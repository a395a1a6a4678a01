"""One run of one cell: set-up, the measured window, the profiled stretch,
the comparison with the reference, and the result line.

Everything that belongs to one configuration, one traffic mix, one cell or
one metric is found by name (``BENCHMARK.json`` at the root of the
checkout):

* ``configs/<config>.json``: the widths, the horizon, the solver options
  and the name of the plain reference (``reference/<name>.py``);
* ``traffic/<traffic>.json``: the batch, the method, the megabytes of the
  pool of inputs, how many calls are compared and profiled, and optionally
  the ``entry`` of the program that a call drives;
* ``cells/<workload>.json``: the limits of the numbers compared;
* ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``;
* ``entries/<entry>.py``: ``program(cell, device) -> (prepare, solve)`` as
  :func:`program` has it, and optionally ``to_result(out) -> Result``,
  which turns what ``solve`` returned into a :class:`Result`, untimed.

The window is a closed loop with one client: a call takes the next batch of
a pool of inputs, calls the program (``solve_batched`` on a pool resident
on the device, where the traffic names no entry), and waits for its
outputs (a device synchronise) before the next.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import random
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import torch

from . import generator, stats, trace
from .roofline import pcg_bodies

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gato_tpu")
# Problems the reference takes at once, so that it fits beside the pool.
REF_CHUNK = 256


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list   # BENCHMARK.json entries that this cell reports
    per_layer: list


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load_cell(workload: str, bench_json: Path = ROOT / "BENCHMARK.json",
              base: Path = BENCH) -> Cell:
    """The cell named ``workload``, its configuration, traffic and limits
    read from their files under ``base``."""
    spec = _load_json(bench_json)
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        names = [w["name"] for w in spec["workloads"]]
        raise KeyError(f"no workload {workload!r} in {bench_json}; there are {names}")
    return Cell(
        name=workload, chips=int(entry["chips"]),
        config=_load_json(base / "configs" / f"{entry['config']}.json"),
        traffic=_load_json(base / "traffic" / f"{entry['traffic']}.json"),
        limits=_load_json(base / "cells" / f"{workload}.json")["limits"],
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, workload)])


def _load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    loader_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(loader_spec)
    loader_spec.loader.exec_module(module)
    return module


def load_reader(metric: str, base: Path = BENCH):
    """The reader of ``metric``: ``metrics/<metric>.py``."""
    return _load_module(base / "metrics" / f"{metric}.py", f"benchmark_metric_{metric}")


def load_reference(name: str, base: Path = BENCH):
    return _load_module(base / "reference" / f"{name}.py", f"benchmark_reference_{name}")


class Entry(NamedTuple):
    """The program under test as a cell drives it."""
    program: Callable                     # (cell, device) -> (prepare, solve)
    to_result: Optional[Callable] = None  # solve's output -> Result; None: it is one


def entry_of(cell: Cell, base: Path = BENCH) -> Entry:
    """The traffic's ``entry`` (``entries/<entry>.py``), or :func:`program`
    where it names none."""
    name = cell.traffic.get("entry")
    if name is None:
        return Entry(program)
    module = _load_module(base / "entries" / f"{name}.py", f"benchmark_entry_{name}")
    return Entry(module.program, getattr(module, "to_result", None))


class Result(NamedTuple):
    """What a solve returns, as the program's ``SolveResult`` has it."""
    lam: torch.Tensor
    dz_x: torch.Tensor
    dz_u: torch.Tensor
    iters: torch.Tensor
    converged: torch.Tensor
    eta: torch.Tensor


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    shape: tuple              # (K, s, c)
    batch: int
    method: str
    setup_s: float
    window_s: float
    call_s: list              # each call's start to its outputs being ready
    host_call_s: list         # each call's entry to return of solve_batched
    iters: Optional[list] = None          # each call's iters (traced runs)
    timeline: Optional[trace.Timeline] = None
    profiled_pool: Optional[list] = None  # pool index of each profiled call
    plain_bodies: Optional[list] = None   # reference PCG bodies a pool batch

    @property
    def calls(self) -> int:
        return len(self.call_s)


# ---- the solvers put in the window ----

def program(cell: Cell, device: torch.device):
    """(prepare, solve) of the program under test: ``solve_batched`` with
    the configuration's options and the traffic's method, from lam = 0."""
    import gato_tpu_torch as gt

    cfg, sv = cell.config, cell.config["solver"]
    spec = gt.ProblemSpec(cfg["state_size"], cfg["control_size"], cfg["knot_points"])
    options = gt.SolverOptions(
        rho=sv["rho"], exit_tol=sv["exit_tol"], max_iters=sv["max_iters"],
        preconditioner=sv["preconditioner"], precond_poly_degree=sv["precond_poly_degree"],
        dtype=sv["dtype"], method=cell.traffic["method"])

    def solve(blocks):
        return gt.solve_batched(spec, blocks, options, device=device)

    return (lambda fields: gt.KKTBlocks(*fields)), solve


def control(cell: Cell, device: torch.device):
    """(prepare, solve) of the control: the reference in the program's
    place, its products at TF32."""
    ref = load_reference(cell.config["reference"])
    rho = cell.config["solver"]["rho"]

    def solve(blocks):
        sol = ref.solve(blocks, rho, tf32=True)
        n = sol.lam.shape[0]
        return Result(sol.lam, sol.dz_x, sol.dz_u,
                      torch.zeros(n, dtype=torch.int32, device=device),
                      torch.ones(n, dtype=torch.bool, device=device),
                      torch.zeros(n, device=device))

    return (lambda fields: fields), solve


# ---- the window ----

class Sampler:
    """A uniform sample of ``size`` calls of the window (reservoir
    sampling, drawn from the seed)."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.kept = size, random.Random(seed), []

    def offer(self, i: int, item) -> None:
        if i < self.size:
            self.kept.append(item)
        else:
            j = self.rng.randrange(i + 1)
            if j < self.size:
                self.kept[j] = item


def _loop(pool, solve, sync, seconds: float, sampler: Sampler, iters=None,
          to_result=None):
    """Calls until ``seconds`` have passed; returns (window seconds, call
    seconds, host seconds of each solve call).  ``iters`` collects each
    call's ``iters``, of its output turned by ``to_result`` where given."""
    P = len(pool)
    call_s, host_s = [], []
    i = 0
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        p = i % P
        t0 = time.perf_counter()
        res = solve(pool[p])
        t1 = time.perf_counter()
        sync()
        t2 = time.perf_counter()
        call_s.append(t2 - t0)
        host_s.append(t1 - t0)
        sampler.offer(i, (p, res))
        if iters is not None:
            iters.append((res if to_result is None else to_result(res)).iters)
        i += 1
        if t2 >= deadline:
            return t2 - start, call_s, host_s


# ---- the comparison ----

def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per problem: the largest gap over the largest reference entry; a
    non-finite answer reads inf."""
    got, ref = got.double().flatten(1), ref.double().flatten(1)
    err = (got - ref).abs().amax(1) / ref.abs().amax(1)
    return torch.nan_to_num(err, nan=float("inf"))


def compare(cell: Cell, pool: list, kept: list, reference) -> tuple:
    """(numbers, failed) of the sampled calls against the reference:
    ``lam_err`` and ``dz_err``, the worst problem's largest gap over its
    largest reference entry, and ``unconverged``, the problems the program
    flags unconverged that the reference solves.  PCG cells add
    ``iters_short``: the mean over the sampled problems of the iterations
    by which the program stopped before the reference's plain PCG to the
    same exit tolerance (a solver that stops early reads high)."""
    sv = cell.config["solver"]
    method = cell.traffic["method"]
    inputs = [torch.cat(f) for f in zip(*(pool[p] for p, _ in kept))]
    outs = [torch.cat(f) for f in zip(*(tuple(res) for _, res in kept))]
    lam, dz_x, dz_u, iters, conv, _ = outs
    e_lam, e_dz, bad, short = [], [], [], []
    for a in range(0, lam.shape[0], REF_CHUNK):
        sl = slice(a, a + REF_CHUNK)
        chunk = [t[sl] for t in inputs]
        ref = reference.solve(chunk, sv["rho"])
        e_lam.append(_rel_err(lam[sl], ref.lam))
        e_dz.append(_rel_err(torch.cat([dz_x[sl].flatten(1), dz_u[sl].flatten(1)], 1),
                             torch.cat([ref.dz_x.flatten(1), ref.dz_u.flatten(1)], 1)))
        if method == "pcg":
            plain = reference.pcg(chunk, sv["rho"], sv["exit_tol"], sv["max_iters"])
            solvable = plain.converged
            short.append(plain.iters.double() - iters[sl].double())
        else:
            solvable = torch.isfinite(ref.lam).flatten(1).all(1)
        bad.append(~conv[sl] & solvable)
    e_lam, e_dz, bad = torch.cat(e_lam), torch.cat(e_dz), torch.cat(bad)
    numbers = {"lam_err": float(e_lam.max()), "dz_err": float(e_dz.max()),
               "unconverged": int(bad.sum())}
    lim = cell.limits
    failed = (e_lam > lim["lam_err"]) | (e_dz > lim["dz_err"]) | bad
    if method == "pcg":
        short = torch.cat(short)
        numbers["iters_short"] = float(short.mean())
        if numbers["iters_short"] > lim["iters_short"]:
            # Every problem that stopped before the reference shares the fault.
            failed |= short > 0
    return numbers, int(failed.sum())


# ---- the run ----

def _plain_bodies(cell: Cell, pool: list, reference) -> list:
    """Each pool batch's total PCG bodies by the reference's plain PCG,
    run over the whole pool in chunks of REF_CHUNK problems."""
    sv = cell.config["solver"]
    whole = [torch.cat(f) for f in zip(*pool)]
    bodies = []
    for a in range(0, whole[0].shape[0], REF_CHUNK):
        cnt = reference.pcg([t[a:a + REF_CHUNK] for t in whole], sv["rho"],
                            sv["exit_tol"], sv["max_iters"])
        bodies += [pcg_bodies(int(i), bool(c))
                   for i, c in zip(cnt.iters.tolist(), cnt.converged.tolist())]
    B = pool[0][0].shape[0]
    return [sum(bodies[p * B:(p + 1) * B]) for p in range(len(pool))]


def _breakdown(tl: trace.Timeline) -> dict:
    by_op = {}
    for name, a, b in tl.ops_in_window():
        by_op[name] = by_op.get(name, 0.0) + (b - a)
    # Each idle gap is cut where a span, the benchmark's or the program's,
    # starts or ends, and each piece named by the innermost span the host
    # was in.
    spans = tl.spans + tl.program_spans
    by_span = {}
    for a, b in stats.idle_gaps([(a, b) for _, a, b in tl.ops], tl.start, tl.end):
        cuts = sorted({a, b} | {t for _, x, y in spans for t in (x, y) if a < t < b})
        for lo, hi in zip(cuts, cuts[1:]):
            span = trace.host_span_at(spans, 0.5 * (lo + hi))
            by_span[span] = by_span.get(span, 0.0) + (hi - lo)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_span)}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi failed: {err}"


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def measure(cell: Cell, seed: int, seconds: float, traced: bool, *,
            solver: Optional[Callable] = None, to_result: Optional[Callable] = None,
            device="cuda", t_start: Optional[float] = None) -> dict:
    """One run of ``cell``: returns the result line's object.  ``solver``
    and ``to_result`` stand in for the cell's :func:`entry_of` where
    ``solver`` is given.  ``t_start`` is the process's start on the host
    clock (``time.perf_counter``), from which ``setup_s`` counts."""
    if solver is None:
        solver, to_result = entry_of(cell)
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg, tr = cell.config, cell.traffic
    K, s, c = cfg["knot_points"], cfg["state_size"], cfg["control_size"]
    B, method = int(tr["batch"]), tr["method"]

    # Set-up, split at each step's end (seconds from the process's start).
    split = {"imports": time.perf_counter() - t_start}
    prepare, solve = solver(cell, dev)
    P = generator.pool_size(float(tr["pool_mb"]), B, K, s, c)
    fields = generator.make_pool(P, B, K, s, c, seed, dev)
    pool = [prepare(f) for f in fields]
    sync()
    split["inputs"] = time.perf_counter() - t_start
    solve(pool[0])
    sync()
    split["first_call"] = time.perf_counter() - t_start
    # Warm-up: the same loop, the same shapes, until warmup_s has passed.
    _loop(pool, solve, sync, float(tr["warmup_s"]),
          Sampler(int(tr["sample_calls"]), seed))
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    sampler = Sampler(int(tr["sample_calls"]), seed)
    iters = [] if traced else None
    t_window = time.perf_counter()
    window_s, call_s, host_s = _loop(pool, solve, sync, seconds, sampler, iters, to_result)
    run = Run(cell=cell, shape=(K, s, c), batch=B, method=method,
              setup_s=t_window - t_start, window_s=window_s, call_s=call_s,
              host_call_s=host_s, iters=iters)

    if traced:
        first = len(call_s)

        def run_calls(n, span):
            done = []
            for j in range(n):
                p = (first + j) % len(pool)
                with span(trace.CALL_SPAN):
                    with span("bench.solve_batched"):
                        res = solve(pool[p])
                    with span("bench.sync"):
                        sync()
                del res
                done.append(p)
            run.profiled_pool = done

        run.timeline = trace.profile(run_calls, int(tr["profile_calls"]))
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    reference = load_reference(cfg["reference"])
    if to_result is not None:
        sampler.kept[:] = [(p, Result(*(t.to(dev) for t in to_result(out))))
                           for p, out in sampler.kept]
    numbers, failed = compare(cell, fields, sampler.kept, reference)
    sampler.kept.clear()
    if traced and method == "pcg":
        run.plain_bodies = _plain_bodies(cell, fields, reference)

    entries = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for entry in entries:
        value = load_reader(entry["name"]).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    device_info = {
        "platform": "gpu" if on_card else dev.type,
        "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
        "count": cell.chips, "memory_peak_bytes": int(peak)}
    split["warmup"] = run.setup_s
    result = {"correct": None, "attempted": run.calls * B, "failed": failed,
              "metrics": metrics, "device": device_info, "setup_split_s": split}
    if traced and run.timeline is not None:
        tl = run.timeline
        device_info["busy_s"] = stats.busy_seconds([(a, b) for _, a, b in tl.ops],
                                                   tl.start, tl.end)
        device_info["window_s"] = tl.seconds
        result["breakdown"] = _breakdown(tl)
    checks = {name: {"value": value, "limit": cell.limits[name]}
              for name, value in numbers.items()}
    result["correct"] = all(v["value"] <= v["limit"] for v in checks.values())
    result["checks"] = checks
    return result
