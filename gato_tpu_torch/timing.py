"""Device timing of solver workloads: chained cold solves, T against 2T.

The port of ``gato_tpu.timing``.  :func:`chain_time` runs a chain of T
dependent steps, each a full solve on freshly perturbed problem data (so no
result is reused and no step's work can be skipped), and differences the
times of chains of T and 2T steps, so that the fixed cost of a chain (the
fence, the first launch) cancels.  :func:`time_solve` wraps it for one
(spec, blocks, options) at the solver's own core.

On a CUDA device a chain is timed with a pair of CUDA events around it and
fenced with ``torch.cuda.synchronize()``; on the CPU with
``time.perf_counter``.  A chain here is a Python loop of solves, as a
control loop calls them: its time is the device span of T dependent
solves, including the gaps in which the host prepares and launches the
next step.  So :func:`time_solve` measures what a caller of the solver sees
per solve, not a kernel's own device time (the probes in
``gato_tpu_torch/tools/`` measure those floors).

:func:`measure_rtt_ms` times the round trip of one scalar fetched from the
device.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .formats import KKTBlocks
from .problem import ProblemSpec, SolverOptions
from .solver import _resolve_backend, _solve_core, _stage, resolve_device, spec_shape


def measure_rtt_ms(reps: int = 10, *, device="cuda") -> float:
    """Round trip: median time to reduce a small tensor on ``device`` and
    fetch the 4-byte result."""
    dev = resolve_device(device)
    float(torch.ones((8, 128), device=dev).sum())
    ts = []
    for i in range(reps):
        x = torch.full((8, 128), float(i + 1), device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        float(x.sum())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def _chain_fn(step_fn, q0, length):
    """A chain of ``length`` dependent steps: step t gets the step counter
    as a tensor and the previous step's output as ``lam_carry``.

    step_fn(q0, lam_carry, t) -> tensor whose sum depends on the whole step."""
    ts = torch.arange(length, dtype=q0.dtype, device=q0.device)

    def chain(q):
        out = torch.zeros_like(q0)
        for i in range(length):
            out = step_fn(q, out, ts[i])
        return out.sum()

    return chain


def _timed(chain, q0, rep):
    """ms of one run of ``chain`` on q0 perturbed for repetition ``rep``."""
    q = q0 * (1.0 + 1e-6 * (rep + 1))
    if q.device.type == "cuda":
        torch.cuda.synchronize(q.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = chain(q)
        end.record()
        torch.cuda.synchronize(q.device)
        float(out)
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    float(chain(q))
    return (time.perf_counter() - t0) * 1e3


def _best_cluster(estimates, n):
    """Median and range of the tightest window of ``n`` consecutive sorted
    estimates — a one-off transient (transport hiccup, chip contention) lands
    far from the cluster and is excluded instead of polluting a plain
    median/spread over everything."""
    xs = sorted(estimates)
    n = min(n, len(xs))
    best_i, best_r = 0, float("inf")
    for i in range(len(xs) - n + 1):
        r = xs[i + n - 1] - xs[i]
        if r < best_r:
            best_i, best_r = i, r
    window = xs[best_i:best_i + n]
    return float(np.median(window)), float(best_r)


def chain_time(step_fn, q0, T: int, reps: int = 7, n_independent: int = 2,
               min_diff_ms: float = 8.0, rel_spread: float = 0.2,
               max_extra: int = 4, label: str = "",
               log=None):
    """Per-step time in ms, via T-vs-2T chain differencing.

    ``step_fn(q0, lam_carry, t)`` must run one full solve whose inputs
    depend on ``t`` and ``lam_carry`` (see :func:`time_solve` for a correct
    perturbation) and return a tensor that depends on every output to keep.
    Runs ``n_independent`` full repetitions and returns (cluster_ms,
    info_dict with reps/spread/T).  Two robustness loops:

    * if the pilot chain difference is below ``min_diff_ms`` (noise
      territory), T is doubled — up to three times — and the measurement
      redone;
    * if the estimates disagree by more than ``rel_spread`` of their value
      (a transient), up to ``max_extra`` further independent estimates are
      taken and the tightest ``n_independent``-wide cluster is reported, so
      a one-off glitch is excluded rather than averaged in."""
    for attempt in range(4):
        c1 = _chain_fn(step_fn, q0, T)
        c2 = _chain_fn(step_fn, q0, 2 * T)
        t0 = time.perf_counter()
        float(c1(q0))  # first run
        # The first run (kernel builds and loads included) is reported
        # beside the steady-state time, re-captured on every attempt so that
        # it is the final T's chain, the one info['T'] names.
        first_call_ms = (time.perf_counter() - t0) * 1e3
        float(c2(q0))
        estimates = []
        diffs = []

        def one_estimate(k):
            t1 = float(np.median([_timed(c1, q0, 10 * k + r) for r in range(reps)]))
            t2 = float(np.median([_timed(c2, q0, 10 * k + r) for r in range(reps)]))
            d = t2 - t1
            diffs.append(d)
            # A stall during either chain can drive the difference
            # non-positive.  Such a measurement carries no signal; clamping
            # it to a floor would let TWO stalls form a fake zero-spread
            # "tightest cluster" of identical floor values that sails through
            # the spread check — so corrupted differences are DROPPED and
            # re-measured instead.
            if d > 0:
                estimates.append(d / T)

        def cluster():
            if not estimates:
                return 0.0, 0.0
            return _best_cluster(estimates, n_independent)

        for k in range(n_independent):
            one_estimate(k)
        if float(np.median(diffs)) >= min_diff_ms or attempt == 3:
            ms, spread = cluster()
            extra = 0
            while (len(estimates) < n_independent
                   or spread > rel_spread * ms) and extra < max_extra:
                if log is not None:
                    log(f"  [{label}] {len(estimates)} usable estimates, "
                        f"spread {spread:.4f} ms vs {ms:.4f} ms; re-measuring")
                one_estimate(n_independent + extra)
                ms, spread = cluster()
                extra += 1
            info = {
                "reps_ms": [round(e, 6) for e in estimates],
                "spread_ms": round(spread, 6),
                "T": T,
                "chain_diff_ms": round(float(np.median(diffs)), 3),
                "first_call_ms": round(first_call_ms, 1),
            }
            warnings = []
            if float(np.median(diffs)) < min_diff_ms:
                warnings.append("chain difference below noise floor")
            if len(estimates) < n_independent:
                warnings.append(
                    f"only {len(estimates)}/{n_independent} usable estimates"
                    " (non-positive chain differences dropped)")
            elif spread > rel_spread * ms:
                warnings.append(
                    f"estimates still spread {spread:.4f} ms after "
                    f"{len(estimates)} independent measurements")
            if warnings:
                info["noise_warning"] = "; ".join(warnings)
            return ms, info
        if log is not None:
            log(f"  [{label}] chain diff {np.median(diffs):.2f} ms < "
                f"{min_diff_ms} ms at T={T}; doubling T")
        T *= 2
    raise AssertionError("unreachable")


def perturb(blocks: KKTBlocks, q0, lam_carry, t):
    """Fresh problem data each chain step: Q scaled by a factor that depends
    on ``t`` (a tensor) and on the previous step's output, q by one that
    depends on ``t``.  It stays on the device: nothing is read back."""
    scale = 1.0 + 1e-6 * torch.cos(t) + 1e-7 * torch.tanh(lam_carry.sum())
    Q = blocks.Q * scale
    q = q0 * (1.0 + 1e-6 * torch.sin(t))
    return Q, q


def time_solve(
    spec: ProblemSpec,
    blocks: KKTBlocks,
    options: SolverOptions = SolverOptions(),
    pcg_backend: Optional[str] = None,
    *,
    T: int = 64,
    device="cuda",
    **chain_kwargs,
):
    """Per-solve time of one problem configuration, as a caller sees it.

    Returns (avg_ms, info): the median per-solve time over chained cold
    solves (every step a fresh problem — Q and q perturbed) through the
    solver's core with the backend ``solve`` would take, plus the
    measurement detail.  ``blocks`` may carry a leading batch axis (then
    solve_batched semantics apply and avg_ms is per BATCH; divide by the
    batch size for per-solve).  ``device`` defaults to "cuda" and raises
    without a card; pass "cpu" for the plain path."""
    batched = len(blocks.Q.shape) == 4
    lead = (int(blocks.Q.shape[0]),) if batched else ()
    backend = _resolve_backend(pcg_backend, options, device, spec_shape(spec),
                               batch=lead[0] if batched else 1)
    dev, b, zero_lam = _stage(spec, blocks, options, None, device, lead)
    if not batched:
        zero_lam = zero_lam.unsqueeze(0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # fence staging

    def step(q0, lam_carry, t):
        Q, q = perturb(b, q0, lam_carry, t)
        kkt = KKTBlocks(Q, b.R, b.A, b.B, q, b.r, b.c)
        if not batched:
            kkt = KKTBlocks(*(a.unsqueeze(0) for a in kkt))
        res = _solve_core(kkt, zero_lam, options, backend)
        out = res.lam + res.dz_x + 1e-20 * res.dz_u.sum()
        return out if batched else out[0]

    label = chain_kwargs.pop("label", f"{backend}/{options.method}")
    return chain_time(step, b.q, T, label=label, **chain_kwargs)
