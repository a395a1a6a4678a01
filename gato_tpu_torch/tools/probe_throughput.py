"""The batch-256 solve's fixed and per-iteration cost, and the serial FMA
rate, on one CUDA card.

    python3 -m gato_tpu_torch.tools.probe_throughput [A] [D] [--R TRIPS]

The counterpart of ``tools/probe_throughput.py``'s probes A and D:

  A. fixed (condensation, preconditioner, recovery) against per-iteration
     cost of kernel B at IIWA (14, 7, 50), B = 256, at exit_tol = 0 (every
     problem runs exactly max_iters) through ``timing.time_solve``:
     max_iters 0, 8 and 16, and the default exit (exit_tol 1e-8, 200).
  D. the serial column-FMA rate, row 17 (``kernels/probes.py``'s
     ``fma_chain_cuda``): trips x depth dependent block-diagonal matvecs on
     one CTA a problem, each knot's y in registers at each of its lanes
     (``probes.fma_plan``), at IIWA K = 50, s = 14, and at K = 4 (kernel
     B's knots a CTA at C = 16).  Launches of R and 2R trips at depth 2 and
     6 give ns a matvec (the trip's own cost cancels), ns a column FMA,
     and the GFLOP/s of one CTA and, at K = 50, of 132 CTAs (one a
     streaming multiprocessor), beside the card's 67 TFLOP/s of float32,
     with the kernel's SASS instruction counts (FFMA, FMUL, shared loads by
     width, shared stores, barriers, shuffles).  The data: probes.
     fma_operator, each knot's step orthogonal, so y keeps its size over
     every trip (checked finite and nonzero after each launch; the TPU
     probe's M and y0 of all ones contract y to 0 at the port's step).

Probes B, C, C2, E, F and G of the TPU tool have no counterpart: they
measure the TPU's lane-group packing (lockstep exit within a lane group,
forced group sizes), its manual single-buffered DMA against the pipelined
BlockSpec path, and the farm's lane packing; the port has no such layout
(ROADMAP, "What to port, and what not to").  Prints one JSON line per
probe.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import shutil
import subprocess
import sys

from gato_tpu_torch import testing, timing
from gato_tpu_torch.formats import blocks_to_torch
from gato_tpu_torch.kernels import _build, probes
from gato_tpu_torch.problem import SolverOptions
from gato_tpu_torch.tools.probe_dispatch import cuda_device
from gato_tpu_torch.tools.probe_iter_floor import check_live, launch_ms

SPEC = testing.IIWA
B = 256
F32_FLOPS = 67e12   # an H100 SXM's float32 rate outside the tensor cores
SMS = 132


def probe_A(*, batch: int = B, T: int = 12, reps: int = 7, device="cuda",
            log=None) -> dict:
    """Kernel B's fixed and per-iteration cost at IIWA, B = ``batch``."""
    dev = cuda_device(device)
    blocks = blocks_to_torch(testing.random_batch(SPEC, batch, seed0=1000), dev)
    ms = {}
    spreads = {}
    for tag, o in (("maxit0", SolverOptions(rho=1e-3, exit_tol=0.0, max_iters=0)),
                   ("maxit8", SolverOptions(rho=1e-3, exit_tol=0.0, max_iters=8)),
                   ("maxit16", SolverOptions(rho=1e-3, exit_tol=0.0, max_iters=16)),
                   ("full", SolverOptions(rho=1e-3, exit_tol=1e-8, max_iters=200))):
        ms[tag], info = timing.time_solve(SPEC, blocks, o, "fused", T=T, reps=reps,
                                          device=dev, min_diff_ms=1.0,
                                          label=f"A/{tag}", log=log)
        spreads[tag] = info["spread_ms"]
    per_iter_ms = (ms["maxit16"] - ms["maxit8"]) / 8.0
    return {
        "probe": "A", "batch": batch,
        "fixed_ms": ms["maxit0"], "maxit8_ms": ms["maxit8"],
        "maxit16_ms": ms["maxit16"], "full_default_ms": ms["full"],
        "per_iter_ms_batch": per_iter_ms,
        "per_iter_us_per_solve": 1e3 * per_iter_ms / batch,
        "fixed_us_per_solve": 1e3 * ms["maxit0"] / batch,
        "full_us_per_solve": 1e3 * ms["full"] / batch,
        # consistency: fixed + per_iter * 8 should be close to maxit8
        "model_maxit8_ms": ms["maxit0"] + 8 * per_iter_ms,
        "spreads": spreads,
    }


def fma_rates(times: dict, R: int, K: int, s: int) -> dict:
    """Probe D's numbers from launch times {(depth, trips): ms} at depth 2
    and 6, trips R and 2R: the slope a trip at each depth, their difference
    over the 4 extra matvecs (the trip's own cost cancels)."""
    trip2_ns = (times[(2, 2 * R)] - times[(2, R)]) / R * 1e6
    trip6_ns = (times[(6, 2 * R)] - times[(6, R)]) / R * 1e6
    ns_per_matvec = (trip6_ns - trip2_ns) / 4.0
    flops = K * s * (2 * s + 2)   # 1 mul + s-1 FMAs, then 0.25 acc + 0.5 y, a row
    return {
        "trip_d2_ns": trip2_ns, "trip_d6_ns": trip6_ns,
        "ns_per_matvec": ns_per_matvec,
        "loop_overhead_ns_per_trip": trip2_ns - 2 * ns_per_matvec,
        "ns_per_col_fma": ns_per_matvec / (s + 2),   # s FMAs + 2 bounding ops
        "gflops_one_cta": flops / ns_per_matvec,
    }


# The SASS instruction families probe D reports for row 17: its FMAs and
# multiplies, shared loads and stores (by width), barriers and shuffles.
SASS_FAMILIES = ("FFMA", "FMUL", "LDS", "STS", "BAR", "SHFL")
_SASS_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_ops(symbol: str, path=None, families=SASS_FAMILIES) -> dict:
    """{mangled function name: {mnemonic with its modifiers: count}} for
    every function whose name holds ``symbol`` in ``cuobjdump -sass`` of
    ``path`` (default: the built kernel library), counting the mnemonics
    of ``families`` (LDS, LDS.64 and LDS.128 apart)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path or _build.build()["path"])],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if symbol in m.group(1) else None
            if name:
                counts[name] = {}
            continue
        m = _SASS_LINE.search(line) if name else None
        if m and m.group(1).split(".")[0] in families:
            counts[name][m.group(1)] = counts[name].get(m.group(1), 0) + 1
    return counts


# Probe D's horizons: IIWA's, then kernel B's knots a CTA at C = 16.
D_KNOTS = (SPEC.knot_points, 4)


def probe_D(*, R: int = 50_000, reps: int = 7, device="cuda", log=None) -> dict:
    """Row 17's serial FMA rate at one CTA (K = 50 and 4) and at 132 CTAs
    (K = 50), with its SASS counts."""
    dev = cuda_device(device)
    s = SPEC.state_size
    out = {"probe": "D", "K": D_KNOTS[0], "s": s, "R": R}
    for K, ctas in ((D_KNOTS[0], 1), (D_KNOTS[0], SMS), (D_KNOTS[1], 1)):
        M, y0 = probes.fma_operator(ctas, K, seed=17, device=dev)
        times = {}
        for depth in (2, 6):
            for trips in (R, 2 * R):
                run = functools.partial(probes.fma_chain_cuda, M, y0, depth=depth,
                                        trips=trips)
                times[(depth, trips)] = launch_ms(run, reps)
                check_live(f"D K={K} ctas={ctas} depth={depth} R={trips}", run())
                tag = f"K{K}_" if K != D_KNOTS[0] else ""
                out[f"t_{tag}ctas{ctas}_d{depth}_R{trips}_ms"] = times[(depth, trips)]
                if log:
                    log(f"  D K={K} ctas={ctas} depth={depth} R={trips}: "
                        f"{times[(depth, trips)]:.4f} ms")
        rates = fma_rates(times, R, K, s)
        if K != D_KNOTS[0]:
            out[f"K{K}"] = rates
        elif ctas == 1:
            out.update(rates)
        else:
            out["ns_per_matvec_132"] = rates["ns_per_matvec"]
            out["gflops_132_ctas"] = rates["gflops_one_cta"] * ctas
    out["share_of_f32_peak_132_ctas"] = out["gflops_132_ctas"] * 1e9 / F32_FLOPS
    out["plan"] = {f"K={K}": probes.fma_plan(1, K)._asdict() for K in D_KNOTS}
    out["sass"] = sass_ops("fma_chain_kernel")
    # FFMA alone: shows that nvcc kept the chain's FMAs (a folded loop
    # would show fewer).
    out["sass_ffma"] = {fn: sum(n for op, n in ops.items() if op.split(".")[0] == "FFMA")
                        for fn, ops in out["sass"].items()}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probes", nargs="*", help="A and/or D (default both)")
    ap.add_argument("--R", type=int, default=50_000)
    args = ap.parse_args(argv)

    def log(m):
        print(m, file=sys.stderr, flush=True)

    for name in args.probes or ("A", "D"):
        if name not in ("A", "D"):
            ap.error(f"unknown probe {name!r}; valid: A, D")
        out = probe_A(log=log) if name == "A" else probe_D(R=args.R, log=log)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
