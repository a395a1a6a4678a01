"""Capabilities tour on gato_tpu_torch: polynomial preconditioning, long
horizons, exact direct solves, MPC chains and farms, packed serving,
differentiable batched solves, and batches split over a mesh.

Run from the repository's root:

    PYTHONPATH=. python examples/torch/advanced.py                # the card
    PYTHONPATH=. python examples/torch/advanced.py --device cpu   # plain PyTorch

``--device cuda`` (the default) runs the CUDA kernels (kernel B, the
long-K tier at K = 1024, row 4, the sequence kernel) and raises where CUDA
is absent; ``--device cpu`` runs their plain PyTorch versions.
"""

import argparse

import numpy as np
import torch

import gato_tpu_torch as gt
from gato_tpu_torch.testing import random_batch, random_blocks

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
dev = torch.device(parser.parse_args().device)
if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("--device cuda was asked for but torch.cuda.is_available() "
                       "is False; pass --device cpu for the plain PyTorch path")

iiwa = gt.ProblemSpec(state_size=14, control_size=7, knot_points=50)
blocks = random_blocks(iiwa, seed=0)

# --- polynomial preconditioner composition ----------------------------------
# precond_poly_degree=d applies M_d r = P sum_{i<d} (I - S P)^i r: wider
# effective bandwidth with no extra stored blocks.  Fewer iterations whenever
# iterations are the scarce resource (long horizons, sharded meshes).
for d in (1, 2, 3):
    res = gt.solve(iiwa, blocks, gt.SolverOptions(rho=1e-3, exit_tol=1e-6,
                                                  max_iters=200,
                                                  precond_poly_degree=d),
                   device=dev)
    print(f"poly degree {d}: {int(res.iters)} PCG iterations")

# --- horizons past one block's shared memory ---------------------------------
# K=1024 at IIWA width does not fit kernel B's shared memory on an H100; on
# the card the solver switches to the long-K tier (kernels/longk.py): row 7's
# condensation tiles, the PCG loop on a cooperative grid (each CTA a knot
# range, S and Pinv in shared memory while they fit), row 13's recovery.
long_spec = gt.ProblemSpec(14, 7, 1024)
res = gt.solve(long_spec, random_blocks(long_spec, seed=1),
               gt.SolverOptions(rho=1e-2, exit_tol=1e-6, max_iters=300), device=dev)
print(f"K=1024 (long-K tier on the card): {int(res.iters)} iterations, "
      f"converged={bool(res.converged)}")

# --- exact direct solve ------------------------------------------------------
# Condensation, block cyclic reduction and recovery in one launch (row 4,
# kernels/direct_fused.py): no tolerance, no iterations; also the robust
# option when PCG stalls.
res = gt.solve(iiwa, blocks, gt.SolverOptions(rho=1e-3, method="direct"), device=dev)
print(f"direct: iters={int(res.iters)} residual^2={float(res.eta):.2e}")

# --- MPC chain, one launch ---------------------------------------------------
T = 16
drift = 1.0 + 0.01 * np.arange(T, dtype=np.float32)
seq = gt.KKTBlocks(*(np.broadcast_to(a, (T,) + a.shape).copy() for a in blocks))
seq = seq._replace(q=seq.q * drift[:, None, None])
out = gt.solve_sequence(iiwa, seq, gt.SolverOptions(rho=1e-3, exit_tol=1e-6,
                                                    max_iters=200), device=dev)
iters = out.iters.tolist()
print(f"MPC chain: first {iters[0]} iters, warm-started rest "
      f"{float(np.mean(iters[1:])):.1f} mean")

# --- MPC FARM: B warm-started streams in lockstep ----------------------------
# Leading (T, B) axes; the sequence kernel advances every stream with its
# own warm-start carry, one launch for the whole farm.
Bf = 4
farm = gt.KKTBlocks(*(np.broadcast_to(a, (T, Bf) + a.shape).copy() for a in blocks))
farm = farm._replace(q=farm.q * (drift[:, None, None, None]
                                 + np.float32(0.1) * np.arange(Bf, dtype=np.float32)
                                 [None, :, None, None]))
out = gt.solve_sequence_batched(iiwa, farm, gt.SolverOptions(rho=1e-3, exit_tol=1e-6,
                                                             max_iters=200),
                                device=dev)
it = out.iters.double()
print(f"MPC farm ({Bf} streams): first-step mean {float(it[0].mean()):.1f} "
      f"iters, warm-started rest {float(it[1:].mean()):.1f} mean")

# --- packed serving: stage once, launch cost per solve -----------------------
# pack() stages the blocks on the device once; update_vectors refreshes only
# the rhs (frozen linearization), and the warm-start carry stays there.
opts = gt.SolverOptions(rho=1e-3, exit_tol=1e-6, max_iters=200)
packed = gt.pack(iiwa, blocks, device=dev)
first = gt.solve_packed(packed, opts)
packed = gt.update_vectors(packed, blocks.q * np.float32(1.01), blocks.r, blocks.c)
warm = gt.solve_packed(packed, opts, lam0=first.lam_packed)
print(f"packed serving: cold {int(first.unpack().iters)} iters, rhs-refresh "
      f"warm {int(warm.unpack().iters)} iters (the carry stayed on the device)")

# --- differentiable batched solves on the exact kernels ----------------------
# kkt_solve_batched: implicit-function-theorem gradients, the forward and
# the adjoint solve both on the exact dispatch's kernels (row 4 here).
Bd = 3
dargs = [torch.as_tensor(a, device=dev) for a in random_batch(iiwa, Bd, seed0=40)]
Q = dargs[0].clone().requires_grad_(True)
lam, _, _ = gt.kkt_solve_batched(Q, *dargs[1:], 1e-3)
(gQ,) = torch.autograd.grad((lam ** 2).sum(), Q)
print(f"differentiable batch: dloss/dQ shape {tuple(gQ.shape)}, "
      f"finite={bool(torch.isfinite(gQ).all())}")

# --- a batch split over a mesh, the solver on each group ---------------------
# A mesh may repeat a device: Mesh([dev] * 4) is four groups on one card.
n_dev = 4
B = 4 * n_dev
small = gt.ProblemSpec(4, 2, 10)
bb = gt.blocks_to_torch(random_batch(small, B, seed0=10), dev)
mesh = gt.Mesh([dev] * n_dev, "dp")
res_dp, _, _ = gt.solve_batched_dp(mesh, *bb, rho=1e-2, exit_tol=1e-8, max_iters=200)
print(f"dp-split batch ({B} problems / {n_dev} groups on {mesh}): "
      f"all converged={bool(res_dp.converged.all())}")
