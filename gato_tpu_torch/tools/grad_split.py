"""One differentiable exact solve split into its parts, on one CUDA card.

    python3 -m gato_tpu_torch.tools.grad_split [--K 50] [--B 0] [--runs 25]

``diff.kkt_solve`` (B = 0) or ``kkt_solve_batched`` (B problems) at IIWA
widths (s = 14, c = 7, horizon K), rho 1e-3, seeded inputs, the loss
``sum(lam cos lam) + sum(dz_x^2) + sum(sin dz_u)``.  CUDA-event medians of
``runs`` calls, ms:

* ``fwd_bwd``: the forward, the loss and ``torch.autograd.grad`` of all
  eight inputs;
* ``fwd``: the forward alone; ``bwd``: ``torch.autograd.grad`` alone on one
  retained graph (the adjoint solve and the cotangents, on the autograd
  engine's thread);
* ``solve_here``: one exact solve (``diff._solve``) on the calling thread,
  the adjoint solve's work without the engine; ``cotangents``: the
  cotangent assembly (``diff._cotangents``) alone;
* ``backward_ops``: the ten ops with the most CPU time in a
  ``torch.profiler`` trace of ten backward calls (name, calls, CPU us a
  call, device us a call).

Prints one JSON line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from gato_tpu_torch import diff, testing
from gato_tpu_torch.problem import ProblemSpec
from gato_tpu_torch.tools.probe_dispatch import cuda_device

RHO = 1e-3


def loss_of(lam, dz_x, dz_u):
    return ((lam * torch.cos(lam)).sum() + (dz_x ** 2).sum()
            + torch.sin(dz_u).sum())


def median_ms(fn, runs: int, warmup: int = 3) -> float:
    for _ in range(warmup):
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


def grad_split(K: int = 50, B: int = 0, runs: int = 25, device="cuda") -> dict:
    dev = cuda_device(device)
    spec = ProblemSpec(14, 7, K)
    blocks = (testing.random_blocks(spec, seed=5) if B == 0
              else testing.random_batch(spec, B, seed0=5))
    args = [torch.tensor(np.asarray(a), device=dev, requires_grad=True) for a in blocks]
    args.append(torch.tensor(RHO, device=dev, requires_grad=True))
    solve = diff.kkt_solve if B == 0 else diff.kkt_solve_batched

    def fwd_bwd():
        return torch.autograd.grad(loss_of(*solve(*args)), args)

    loss = loss_of(*solve(*args))
    plain = [a.detach() for a in args[:7]]
    batched = plain if B else [a.unsqueeze(0) for a in plain]
    lam, dz_x, dz_u = diff._solve(*batched, RHO)
    out = {
        "K": K, "B": B, "runs": runs,
        "fwd_bwd": median_ms(fwd_bwd, runs),
        "fwd": median_ms(lambda: solve(*args), runs),
        "bwd": median_ms(lambda: torch.autograd.grad(loss, args, retain_graph=True), runs),
        "solve_here": median_ms(lambda: diff._solve(*batched, RHO), runs),
        "cotangents": median_ms(lambda: diff._cotangents(lam, dz_x, dz_u, lam, dz_x, dz_u),
                                runs),
    }
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            torch.autograd.grad(loss, args, retain_graph=True)
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: e.cpu_time_total, reverse=True)[:10]
    out["backward_ops"] = [
        (e.key, e.count, round(e.cpu_time_total / e.count, 1),
         round(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
               / e.count, 1)) for e in rows]
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--K", type=int, default=50)
    ap.add_argument("--B", type=int, default=0, help="0: kkt_solve, one problem")
    ap.add_argument("--runs", type=int, default=25)
    a = ap.parse_args(argv)
    print(json.dumps(grad_split(a.K, a.B, a.runs)))


if __name__ == "__main__":
    main()
