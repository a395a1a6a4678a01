"""The original solver's one Python entry point, on PyTorch.

    linsys_solve(G_row, G_col, G_val, C_row, C_col, C_val,
                 g, c, input_lambda, testiters, exit_tol,
                 max_iters, warm_start, rho) -> (lambda, dz)

Same 14 positional arguments, same return (two lists of floats) and the same
printed lines as ``gato_tpu.linsys_solve``: the solve runs ``testiters``
times (at least once) and prints the first run's PCG iteration count and
time, then the average time, in milliseconds.  The inputs are staged on the
device once, before the timed loop; on CUDA each timed call ends in
``torch.cuda.synchronize()``.  The first run includes the kernels' build
and load on a fresh checkout.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .formats import blocks_to_torch, pack_kkt
from .problem import ProblemSpec, SolverOptions
from .solver import SolveResult, resolve_device, solve


def infer_spec(C_indptr, g, c_vec) -> ProblemSpec:
    """Infer (state_size, control_size, knot_points) from the KKT structure.

    Rows 0..s-1 of the constraint Jacobian are the initial-condition identity
    (one entry each), so the first row with more than one entry gives s; then
    K = len(c)/s and c = (len(g) - s*K) / (K - 1).
    """
    indptr = np.asarray(C_indptr, dtype=np.int64)
    counts = np.diff(indptr)
    multi = np.nonzero(counts != 1)[0]
    if multi.size == 0 or multi[0] == 0:
        raise ValueError(
            "cannot infer STATE_SIZE from C's structure (no identity block of "
            "single-entry rows at the top); pass spec=ProblemSpec(...) explicitly"
        )
    s = int(multi[0])
    nl, ng = len(c_vec), len(g)
    if nl % s:
        raise ValueError(f"len(c)={nl} is not a multiple of inferred state_size={s}; "
                         "pass spec= explicitly")
    K = nl // s
    if K < 2 or (ng - s * K) % (K - 1):
        raise ValueError(f"cannot infer control_size from len(g)={ng}, s={s}, K={K}; "
                         "pass spec= explicitly")
    c = (ng - s * K) // (K - 1)
    return ProblemSpec(state_size=s, control_size=c, knot_points=K)


def linsys_solve(
    G_row, G_col, G_val,
    C_row, C_col, C_val,
    g, c,
    input_lambda,
    testiters: int,
    exit_tol: float,
    max_iters: int,
    warm_start: bool,
    rho: float,
    *,
    spec: Optional[ProblemSpec] = None,
    pcg_backend: Optional[str] = None,
    verbose: bool = True,
    device="cuda",
) -> Tuple[List[float], List[float]]:
    """Drop-in counterpart of the original ``gpu_library.linsys_solve``.

    ``device`` defaults to "cuda" and raises when no CUDA device exists;
    pass ``device="cpu"`` for the plain PyTorch path.  With ``warm_start``
    each run starts from the previous run's multipliers."""
    dev = resolve_device(device)
    if spec is None:
        spec = infer_spec(C_row, g, c)
    blocks = pack_kkt(spec, G_row, G_col, G_val, C_row, C_col, C_val, g, c)
    options = SolverOptions(
        exit_tol=exit_tol, max_iters=max_iters, warm_start=warm_start, rho=rho
    )

    # Stage every input on the device once, before the timed loop.
    blocks = blocks_to_torch(blocks, dev, torch.float32)
    lam = torch.as_tensor(
        np.asarray(input_lambda, dtype=np.float32).reshape(
            spec.knot_points, spec.state_size), device=dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)

    result: Optional[SolveResult] = None
    times_ms = []
    for i in range(max(int(testiters), 1)):
        t0 = time.perf_counter()
        result = solve(spec, blocks, options, lam0=lam,
                       pcg_backend=pcg_backend, device=dev)
        if cuda:
            torch.cuda.synchronize(dev)
        times_ms.append((time.perf_counter() - t0) * 1e3)
        if warm_start:
            lam = result.lam
        if i == 0 and verbose:
            print(
                f"first run PCG terminated in {int(result.iters)} iterations, "
                f"time:  {times_ms[0]:f}"
            )
    if verbose:
        print(f"avg time: {float(np.mean(times_ms)):f}")

    return list(map(float, result.lam_flat())), list(map(float, result.dz_flat()))
