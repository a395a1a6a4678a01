"""Kernel A and rows 4, 5, 6, 11, 12 and 17 by stage, their times and row
13's, for the gato_tpu_torch of any checkout, on one CUDA card.

    python3 gato_tpu_torch/tools/direct_stamps.py [--root ROOT] [--runs N]
        [--two-meetings] [--only GROUP,...]

Imports gato_tpu_torch from the checkout at ROOT (default: this one),
building its kernels there, so that one call can set a parent's kernels
beside this tree's.  Prints JSON lines, each with the card's name and power
limit:

* ``times``: row 5 (``thomas_fwd_cuda``) and the Thomas pair
  (``solve_direct_thomas_cuda``) at IIWA (14, 7, 50), B = 1, 16 and 256,
  rho 1e-3; row 11 (``cr_longk_cuda``) on row 7's condensation of IIWA
  problems at K = 1024 and 8192, B = 1 and 15: CUDA events (the median of
  ``runs`` calls after three, with the wrapper's host work) and the
  device's time of one launch (20 calls captured in a CUDA graph, the
  replay's median over 20).  Kernel A (``pcg_batched_cuda``) on
  ``assemble.condense``'s operators at IIWA K = 50, B = 1 and 256, and K =
  688 (the edge before the long-K tier), B = 1; row 4
  (``direct_fused_cuda``) at K = 50, B = 1, 15 and 256, and K = 740 (its
  edge), B = 1.  Row 6 (``thomas_rev_cuda``) on row 5's stacks at IIWA K =
  50, B = 1, 16 and 256, and K = 1024, B = 16.  Row 12 (``peel_longk_cuda``)
  and the unpeel (``unpeel_longk_cuda``, on the peel's level and row 11's
  solution of the reduced system) on row 11's inputs, with both exact
  routes ('xl', 'hybrid': ``solve_direct_longk_batched``) there.  Row 13
  (``recover_longk_cuda``) on row 7's condensation of IIWA problems at K =
  1024 and 8192, B = 1 and 16, lambda = gamma.
* ``stamps`` (a checkout whose library exports ``gato_thomas_stamps``):
  in a child process, the kernels built again with ``-DGATO_STAGE_STAMPS``
  (a separate library; the shipped build is untouched), which read
  ``%globaltimer`` at fixed points; the medians over ``runs`` launches, in
  us.  Row 5: ``stage1`` (the condensation, from its start to its end),
  ``walk`` (from there to the last knot), the median ``knot`` of the walk
  and the first and last knots.  ``cluster``: the alternative design for
  row 5's condensation, kernel B's (``cluster_body.cuh`` stages 1-3: the
  Gauss-Jordan of Q and R and the products, on one thread-block cluster a
  problem) at the same inputs, B = 1 and 16, from its own stamps.  Row 11:
  ``phases``, the time between consecutive stamps in the order the kernel
  takes them, and ``labels`` naming each (see each source's note on its
  stamps).  Kernel A and row 4 (a checkout whose library exports
  ``gato_pcg_stamps`` and ``gato_direct_stamps``) the same way, at the
  shapes of their times.  Row 6 (a checkout whose library exports
  ``gato_thomas_rev_stamps``): its ``walk`` (problem 0's, from its start to
  its last knot), the median ``knot``, the first and last knots, the
  ``gap`` to the epilogue and the ``epilogue`` (0 where the recovery and
  residual run inside the walk).  Row 12 (``gato_peel_stamps``): the peel's
  ``first`` and ``second`` launches (each from its first CTA's start to its
  last one's end), the ``gap`` between them, and the ``unpeel``.  Row 17
  (``gato_fma_stamps``; group ``row17``, stamps only) at K = 50 and 4, B =
  1, 100 trips of depth 2: the ``load`` of 0.01 M and y, the ``first``
  matvec, the 199 others (``steady_ns_per_matvec``), the ``store``.

``--two-meetings`` builds with ``-DGATO_CR_TWO_MEETINGS`` (both lines):
every grid level of row 11 takes two meetings, a warp a row, where the
shipped build takes one meeting at a level of few rows.  ``--only`` keeps
some of the groups rowA, row4, row5 (with the pair and kernel B's
condensation), row6, row11, row12, row13 (times only: no stamps child
runs for it alone) and row17 (stamps only).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

THOMAS_B = (1, 16, 256)
CR_SHAPES = ((1024, 1), (1024, 15), (8192, 1), (8192, 15))
PCG_SHAPES = ((50, 1), (50, 256), (688, 1))
ROW4_SHAPES = ((50, 1), (50, 15), (50, 256), (740, 1))
ROW6_SHAPES = ((50, 1), (50, 16), (50, 256), (1024, 16))
ROW13_SHAPES = ((1024, 1), (8192, 1), (1024, 16), (8192, 16))
RHO = 1e-3


def _import(root: str):
    sys.path.insert(0, str(Path(root).resolve()))
    import gato_tpu_torch as gt

    if not gt.__file__.startswith(str(Path(root).resolve())):
        raise SystemExit(f"imported {gt.__file__}, not the checkout at {root}")
    return gt


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, runs: int) -> float:
    import numpy as np
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, calls: int = 20) -> float:
    """One fn()'s device time: ``calls`` calls captured in a CUDA graph,
    the replay's median over ``calls``."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return median_ms(graph.replay, 11) / calls


GROUPS = ("rowA", "row4", "row5", "row6", "row11", "row12", "row13", "row17")
# The groups with stamps (the stamped build's child).
STAMPED = ("rowA", "row4", "row5", "row6", "row11", "row12", "row17")
# Row 17's stamped launches: K = 50 (probe D's) and 4 (kernel B's knots a
# CTA at C = 16), B = 1, 100 trips of depth 2.
ROW17_KNOTS = (50, 4)


def inputs(gt, dev, only=GROUPS):
    """{("thomas", B): blocks}, {("cr", K, B): (S, gamma)}, {("crkkt", K,
    B): blocks}, {("kkt", K, B): blocks}, {("pcg", K, B): condensed system}
    , {("rev", K, B): (row 5's stacks, blocks)} and {("recover", K, B): row
    13's arguments} at IIWA widths, for the groups in ``only``."""
    from gato_tpu_torch import testing as tt
    from gato_tpu_torch.kernels import longk as kl
    from gato_tpu_torch.kernels import thomas_batch as kt

    full = gt.blocks_to_torch(tt.random_batch(tt.IIWA, max(THOMAS_B), seed0=0), dev)
    out = {("thomas", n): gt.KKTBlocks(*(a[:n] for a in full)) for n in THOMAS_B}
    for K, n in CR_SHAPES if {"row11", "row12"} & set(only) else ():
        spec = gt.ProblemSpec(14, 7, K)
        b = gt.blocks_to_torch(tt.random_batch(spec, n, seed0=100 + K), dev)
        ops = kl.condense_longk_cuda(*b, rho=RHO, preconditioner="jacobi")
        out[("cr", K, n)] = (ops.S, ops.gamma)
        out[("crkkt", K, n)] = b
    for K, n in ROW6_SHAPES if "row6" in only else ():
        b = (out[("thomas", n)] if K == 50 else gt.blocks_to_torch(
            tt.random_batch(gt.ProblemSpec(14, 7, K), n, seed0=300 + K), dev))
        out[("rev", K, n)] = (kt.thomas_fwd_cuda(*b, rho=RHO), b)
    for K, n in ROW13_SHAPES if "row13" in only else ():
        b = gt.blocks_to_torch(tt.random_batch(gt.ProblemSpec(14, 7, K), n,
                                               seed0=400 + K), dev)
        ops = kl.condense_longk_cuda(*b, rho=RHO)
        out[("recover", K, n)] = (ops.Qinv, ops.Rinv, b.A, b.B, b.q, b.r, ops.gamma)
    for K, n in sorted(set(PCG_SHAPES if "rowA" in only else ())
                       | set(ROW4_SHAPES if "row4" in only else ())):
        b = gt.blocks_to_torch(tt.random_batch(gt.ProblemSpec(14, 7, K), n,
                                               seed0=200 + K), dev)
        out[("kkt", K, n)] = b
        if (K, n) in PCG_SHAPES:
            out[("pcg", K, n)] = gt.assemble.condense(*b, RHO)
    return out


def rev_call(kt, f, b):
    return lambda: kt.thomas_rev_cuda(f, b.q, b.A, b.B, b.r)


def peel_calls(kl, S, g):
    """(peel, unpeel) of row 12 on (S, g): the unpeel on the peel's level
    and row 11's solution of the reduced system."""
    Sh, bh, level = kl.peel_longk_cuda(S, g)
    xh = kl.cr_longk_cuda(Sh, bh)[0]
    return lambda: kl.peel_longk_cuda(S, g), lambda: kl.unpeel_longk_cuda(xh, level)


def pcg_call(ka, sys_):
    return lambda: ka.pcg_batched_cuda(sys_.S, sys_.Pinv, sys_.gamma,
                                       exit_tol=1e-6, max_iters=100)


def row4_labels(n: int, K: int) -> list:
    """Names of row 4's stamped phases: the condensation, each level, the
    root, each back-substitution level, the residual, the recovery."""
    hs = [1 << i for i in range(max((K - 1).bit_length(), 0))]
    labels = (["condensation"] + [f"level h={h}" for h in hs] + ["root"]
              + [f"back h={h}" for h in reversed(hs)] + ["residual", "recovery"])
    return labels[:n - 1] if len(labels) >= n - 1 else labels + [
        f"phase {i}" for i in range(len(labels), n - 1)]


def pcg_labels(n: int) -> list:
    """Names of kernel A's stamped phases: the one-block kernel's load, PCG
    and store, or the cluster kernel's operator copy, PCG set-up, loop and
    store."""
    if n - 1 == 3:
        return ["load", "PCG (set-up and loop)", "store"]
    return ["copy", "set-up", "loop", "store"][:n - 1]


def measure(root: str, runs: int, defines: tuple = (), only=GROUPS) -> dict:
    gt = _import(root)
    import torch

    from gato_tpu_torch.kernels import _build
    from gato_tpu_torch.kernels import direct_fused as kd
    from gato_tpu_torch.kernels import longk as kl
    from gato_tpu_torch.kernels import pcg_kernel as ka
    from gato_tpu_torch.kernels import thomas_batch as kt

    _build.DEFINES = defines

    dev = torch.device("cuda", 0)
    data = inputs(gt, dev, only)
    out = {"what": "times", "root": root, "defines": list(defines), "card": card(),
           "rowA": {}, "row4": {}, "row5": {}, "pair": {}, "row6": {}, "row11": {},
           "row12": {}, "unpeel": {}, "routes": {}, "row13": {}}
    for K, n in PCG_SHAPES if "rowA" in only else ():
        fn = pcg_call(ka, data[("pcg", K, n)])
        out["rowA"][f"K={K} B={n}"] = {"ms": median_ms(fn, runs), "device_ms": device_ms(fn)}
    for K, n in ROW4_SHAPES if "row4" in only else ():
        b = data[("kkt", K, n)]
        fn = lambda: kd.direct_fused_cuda(*b, rho=RHO)  # noqa: E731
        out["row4"][f"K={K} B={n}"] = {"ms": median_ms(fn, runs), "device_ms": device_ms(fn)}
    for n in THOMAS_B if "row5" in only else ():
        b = data[("thomas", n)]
        for key, fn in (("row5", lambda: kt.thomas_fwd_cuda(*b, rho=RHO)),
                        ("pair", lambda: kt.solve_direct_thomas_cuda(*b, rho=RHO))):
            out[key][f"B={n}"] = {"ms": median_ms(fn, runs), "device_ms": device_ms(fn)}
    for K, n in CR_SHAPES if "row11" in only else ():
        S, g = data[("cr", K, n)]
        fn = lambda: kl.cr_longk_cuda(S, g)  # noqa: E731
        out["row11"][f"K={K} B={n}"] = {"ms": median_ms(fn, runs),
                                        "device_ms": device_ms(fn)}
    for K, n in ROW6_SHAPES if "row6" in only else ():
        fn = rev_call(kt, *data[("rev", K, n)])
        out["row6"][f"K={K} B={n}"] = {"ms": median_ms(fn, runs), "device_ms": device_ms(fn)}
    for K, n in ROW13_SHAPES if "row13" in only else ():
        args = data[("recover", K, n)]
        fn = lambda: kl.recover_longk_cuda(*args)  # noqa: E731
        out["row13"][f"K={K} B={n}"] = {"ms": median_ms(fn, runs),
                                        "device_ms": device_ms(fn)}
    for K, n in CR_SHAPES if "row12" in only else ():
        S, g = data[("cr", K, n)]
        b = data[("crkkt", K, n)]
        key = f"K={K} B={n}"
        for name, fn in zip(("row12", "unpeel"), peel_calls(kl, S, g)):
            out[name][key] = {"ms": median_ms(fn, runs), "device_ms": device_ms(fn)}
        for tier in ("xl", "hybrid"):
            fn = lambda tier=tier: kl.solve_direct_longk_batched(  # noqa: E731
                *b, rho=RHO, force_tier=tier)
            out["routes"][f"{tier} {key}"] = {"ms": median_ms(fn, runs),
                                              "device_ms": device_ms(fn)}
    return out


def cr_labels(kl, n: int, K: int, s: int, limit: int) -> list:
    """Names of row 11's stamped phases (the times between its ``n``
    stamps): before the tail design, each level's inversion and reduction,
    the root and the back-substitution levels; with it, the grid levels,
    the tail's load, levels, root and back-substitution, and the grid's
    back-substitution levels."""
    if not hasattr(kl, "cr_tail_stride"):
        L = max((K - 1).bit_length(), 0)
        hs = [1 << i for i in range(L)]
        return ([f"{k} h={h}" for h in hs for k in ("invert", "reduce")] + ["root"]
                + [f"back h={h}" for h in reversed(hs)])
    ht = kl.cr_tail_stride(K, s, limit)
    grid = [1 << i for i in range(max(ht.bit_length() - 1, 0))]
    rows = (K - 1) // ht + 1
    tail = [f"tail level {1 << i}" for i in range(max((rows - 1).bit_length(), 0))]
    labels = [f"grid level h={h}" for h in grid]
    labels += ["launch gap to the tail" if grid else "tail start", "tail load",
               *tail, "tail root", "tail back-substitution"]
    if grid:
        labels += [f"tail store, launch and grid back h={grid[-1]}"]
        labels += [f"grid back h={h}" for h in reversed(grid[:-1])]
    return labels[:n - 1] if len(labels) >= n - 1 else labels + [
        f"phase {i}" for i in range(len(labels), n - 1)]


def stamps(root: str, runs: int, wait: bool = False, defines: tuple = (),
           only=GROUPS) -> dict:
    """The ``stamps`` line (run in a child process: the stamped build must
    be chosen before the first CUDA call).  ``wait``: build, print
    ``built``, then read a line from stdin before touching the card (a
    caller that shares the card and the host says when both are idle)."""
    gt = _import(root)
    import numpy as np
    import torch

    from gato_tpu_torch.kernels import _build
    from gato_tpu_torch.kernels import direct_fused as kd
    from gato_tpu_torch.kernels import fused_solve as kb
    from gato_tpu_torch.kernels import longk as kl
    from gato_tpu_torch.kernels import pcg_kernel as ka
    from gato_tpu_torch.kernels import thomas_batch as kt

    _build.DEFINES = ("-DGATO_STAGE_STAMPS", *defines)
    _build.build()
    if wait:
        print("built", flush=True)
        sys.stdin.readline()
    dev = torch.device("cuda", 0)
    data = inputs(gt, dev, only)
    buf = (ctypes.c_ulonglong * 256)()

    def runs_of(fn, read) -> np.ndarray:
        rows = []
        for i in range(runs + 3):
            fn()
            torch.cuda.synchronize()
            n = read(ctypes.cast(buf, ctypes.c_void_p))
            if n < 2:
                raise RuntimeError("the stamped build returned no stamps")
            if i >= 3:
                rows.append(np.diff(np.array(list(buf)[:n], dtype=np.float64)) / 1e3)
        return np.median(np.array(rows), axis=0)

    def raw(fns, read) -> np.ndarray:
        """The stamps of ``runs`` rounds of ``fns`` (after three), read
        after each round: (runs, n), in ns."""
        rows = []
        for i in range(runs + 3):
            for fn in fns:
                fn()
            torch.cuda.synchronize()
            n = read(ctypes.cast(buf, ctypes.c_void_p))
            if n < 1:
                raise RuntimeError("the stamped build returned no stamps")
            if i >= 3:
                rows.append(np.array(list(buf)[:n], dtype=np.float64))
        return np.array(rows)

    line = {"what": "stamps", "root": root, "defines": list(defines), "card": card(),
            "rowA": {}, "row4": {}, "row5": {}, "cluster": {}, "row6": {}, "row11": {},
            "row12": {}, "row17": {}}
    if hasattr(_build.library(), "gato_pcg_stamps"):
        readA = _build.function("gato_pcg_stamps")
        for K, n in PCG_SHAPES if "rowA" in only else ():
            d = runs_of(pcg_call(ka, data[("pcg", K, n)]), readA)
            line["rowA"][f"K={K} B={n}"] = {
                "total": float(d.sum()), "phases": [round(float(x), 3) for x in d],
                "labels": pcg_labels(d.size + 1)}
        read4 = _build.function("gato_direct_stamps")
        for K, n in ROW4_SHAPES if "row4" in only else ():
            b = data[("kkt", K, n)]
            d = runs_of(lambda: kd.direct_fused_cuda(*b, rho=RHO), read4)
            line["row4"][f"K={K} B={n}"] = {
                "total": float(d.sum()), "phases": [round(float(x), 3) for x in d],
                "labels": row4_labels(d.size + 1, K)}
    read5 = _build.function("gato_thomas_stamps")
    for n in THOMAS_B if "row5" in only else ():
        b = data[("thomas", n)]
        d = runs_of(lambda: kt.thomas_fwd_cuda(*b, rho=RHO), read5)
        knots = d[1:]
        line["row5"][f"B={n}"] = {"stage1": float(d[0]), "walk": float(knots.sum()),
                                  "knot": float(np.median(knots)),
                                  "first_knot": float(knots[0]),
                                  "last_knot": float(knots[-1]),
                                  "knots_stamped": int(knots.size)}
    # Kernel B's stamps: the start, then after the Gauss-Jordan of Q, of R,
    # and the products (its condensation), then five more stages.
    readb = _build.function("gato_fused_stage_stamps")
    for n in THOMAS_B[:2] if "row5" in only else ():
        b = data[("thomas", n)]
        d = runs_of(lambda: kb.fused_solve_cuda(*b, rho=RHO, exit_tol=1e-6,
                                                max_iters=100), readb)
        line["cluster"][f"B={n}"] = {"condensation": float(d[:3].sum()),
                                     "cluster_ctas": kb.LAST_CLUSTER}
    read11 = _build.function("gato_longk_cr_stamps")
    limit = _build.max_shared_bytes(dev) - _build.RESERVED_SHARED_BYTES
    for K, n in CR_SHAPES if "row11" in only else ():
        S, g = data[("cr", K, n)]
        d = runs_of(lambda: kl.cr_longk_cuda(S, g), read11)
        labels = cr_labels(kl, d.size + 1, K, 14, limit)
        line["row11"][f"K={K} B={n}"] = {"total": float(d.sum()),
                                         "phases": [round(float(x), 3) for x in d],
                                         "labels": labels}
    lib = _build.library()
    if "row6" in only and hasattr(lib, "gato_thomas_rev_stamps"):
        read6 = _build.function("gato_thomas_rev_stamps")
        for K, n in ROW6_SHAPES:
            st = raw([rev_call(kt, *data[("rev", K, n)])], read6) / 1e3
            knots = np.diff(np.concatenate([st[:, :1], st[:, 4:]], axis=1), axis=1)
            line["row6"][f"K={K} B={n}"] = {
                "walk": float(np.median(st[:, 1] - st[:, 0])),
                "knot": float(np.median(knots)),
                "first_knot": float(np.median(knots[:, 0])),
                "last_knot": float(np.median(knots[:, -1])),
                "knots_stamped": int(knots.shape[1]),
                "gap": float(np.median(st[:, 2] - st[:, 1])),
                "epilogue": float(np.median(st[:, 3] - st[:, 2]))}
    if "row12" in only and hasattr(lib, "gato_peel_stamps"):
        read12 = _build.function("gato_peel_stamps")
        for K, n in CR_SHAPES:
            st = raw(list(peel_calls(kl, *data[("cr", K, n)])), read12) / 1e3
            line["row12"][f"K={K} B={n}"] = {
                "first": float(np.median(st[:, 1] - st[:, 0])),
                "gap": float(np.median(st[:, 2] - st[:, 1])),
                "second": float(np.median(st[:, 3] - st[:, 2])),
                "unpeel": float(np.median(st[:, 5] - st[:, 4]))}
    if "row17" in only and hasattr(lib, "gato_fma_stamps"):
        from gato_tpu_torch.kernels import probes as kp
        read17 = _build.function("gato_fma_stamps")
        for K in ROW17_KNOTS:
            M, y0 = kp.fma_operator(1, K, seed=8700, device=dev)
            d = runs_of(lambda: kp.fma_chain_cuda(M, y0, depth=2, trips=100), read17)
            line["row17"][f"K={K} B=1"] = {
                "load": float(d[0]), "first": float(d[1]),
                "steady_ns_per_matvec": float(1e3 * d[2] / 199), "store": float(d[3]),
                "total": float(d.sum())}
    return line


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--runs", type=int, default=25)
    ap.add_argument("--stamps-child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--two-meetings", action="store_true",
                    help="build row 11 with every grid level in two meetings")
    ap.add_argument("--wait", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--only", default=",".join(GROUPS),
                    help="comma-separated groups of " + ", ".join(GROUPS))
    args = ap.parse_args()
    only = tuple(args.only.split(","))
    if not set(only) <= set(GROUPS):
        raise SystemExit(f"--only takes groups of {GROUPS}, got {only}")
    defines = ("-DGATO_CR_TWO_MEETINGS",) if args.two_meetings else ()
    if args.stamps_child:
        print(json.dumps(stamps(args.root, args.runs, args.wait, defines, only)))
        return
    print(json.dumps(measure(args.root, args.runs, defines, only)), flush=True)
    from gato_tpu_torch.kernels import _build

    if set(only) & set(STAMPED) and hasattr(_build.library(), "gato_thomas_stamps"):
        child = subprocess.run([sys.executable, __file__, "--root", args.root,
                                "--runs", str(args.runs), "--stamps-child",
                                "--only", args.only,
                                *(["--two-meetings"] if args.two_meetings else [])],
                               capture_output=True, text=True, timeout=1200)
        if child.returncode != 0:
            raise RuntimeError(f"stamps child failed:\n{child.stderr}")
        print(child.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
