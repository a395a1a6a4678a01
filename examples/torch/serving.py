"""Serving-deployment tour on gato_tpu_torch: the packed API from one card
to a mesh.

A production MPC/QP serving loop re-solves the same SHAPE thousands of
times per second.  ``solve_batched`` converts and copies its inputs to the
device on every call; this example shows the serving levels that remove it:

  1. pack once + rhs refresh         (frozen linearization)
  2. packed warm-start carry         (the solution stays on the device)
  3. fleet serving over a mesh       (the same packed value, split in groups)
  4. streaming farm windows          (a (T, B) window packed once)

Run from the repository's root:

    PYTHONPATH=. python examples/torch/serving.py                # the card
    PYTHONPATH=. python examples/torch/serving.py --device cpu   # plain PyTorch

``--device cuda`` (the default) runs kernel B, row 4 and the sequence
kernel, and raises where CUDA is absent; ``--device cpu`` runs their plain
PyTorch versions.
"""

import argparse
import dataclasses

import numpy as np
import torch

import gato_tpu_torch as gt
from gato_tpu_torch.testing import random_batch

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
dev = torch.device(parser.parse_args().device)
if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("--device cuda was asked for but torch.cuda.is_available() "
                       "is False; pass --device cpu for the plain PyTorch path")

spec = gt.ProblemSpec(state_size=4, control_size=2, knot_points=12)
opts = gt.SolverOptions(rho=1e-3, exit_tol=1e-8, max_iters=200)

B = 8
blocks = random_batch(spec, B, seed0=0)

# --- 1. pack once, then serve at kernel-launch cost --------------------------
packed = gt.pack(spec, blocks, device=dev)
res = gt.solve_packed(packed, opts)
print(f"cold solve: iters {res.iters.tolist()}")

# Frozen linearization, fresh rhs every tick: refresh ONLY the vectors
# (O(s) per knot instead of O(s^2) for the four matrix stacks).
for tick in range(3):
    q_new = blocks.q * np.float32(1.0 + 0.02 * (tick + 1))
    packed = gt.update_vectors(packed, q_new, blocks.r, blocks.c)
    # --- 2. the warm-start carry stays on the device across calls ------------
    res = gt.solve_packed(packed, opts, lam0=res.lam_packed)
    print(f"tick {tick}: warm iters {res.iters.tolist()}")

out = res.unpack()          # public (B, K, s) shapes
print(f"unpacked lam shape {tuple(out.lam.shape)}, all converged "
      f"{bool(out.converged.all())}")

# --- 3. fleet serving: the same packed value split over a mesh ---------------
# Device i of the mesh solves problems [i g, (i+1) g), g = B / n.  A mesh may
# repeat a device: then the groups are views of the pack and share its card.
n = next(k for k in (4, 2, 1) if B % k == 0)
mesh = gt.Mesh([dev] * n, "dp")
res_dp = gt.solve_packed_dp(mesh, packed, opts, lam0=res.lam_packed)
shared = "; the groups share one device" if len(set(mesh.devices)) == 1 else ""
print(f"fleet ({n} groups of {B // n} on {mesh}{shared}): warm iters "
      f"{res_dp.iters.tolist()}")

# --- exact serving: the same pack serves method='direct' ---------------------
opts_d = dataclasses.replace(opts, method="direct")
res_d = gt.solve_packed(packed, opts_d)          # row 4 on the PCG pack
print(f"exact direct serve (the PCG pack, solve_packed): eta max "
      f"{float(res_d.eta.max()):.2e}")
try:
    gt.solve_packed_dp(mesh, packed, opts_d)
except ValueError as e:                          # gato_tpu's contract
    print(f"solve_packed_dp refuses the relabel: {e}")
else:
    raise AssertionError("solve_packed_dp relabelled a PCG pack")
res_dd = gt.solve_packed_dp(mesh, gt.pack(spec, blocks, method="direct", device=dev),
                            opts_d)
print(f"exact fleet serve (a 'direct' pack over the mesh): eta max "
      f"{float(res_dd.eta.max()):.2e}")

# --- 4. streaming farm windows: pack the (T, B) stream once ------------------
# A long-session MPC loop re-solving whole windows: pack_sequence stages a
# window once, and the lambda carry crosses windows on the device.
Tw = 4
rng = np.random.default_rng(0)
window = gt.KKTBlocks(*(np.broadcast_to(a, (Tw,) + a.shape).copy() for a in blocks))
carry = None
for w in range(2):
    qs = (window.q * (1.0 + 0.01 * rng.normal(size=window.q.shape))).astype(np.float32)
    pw = gt.pack_sequence(spec, window._replace(q=qs), device=dev)
    rw = gt.solve_packed_sequence(pw, opts, lam0=carry)
    carry = rw.lam_tail_packed          # warm start crosses windows
    print(f"window {w}: per-step mean iters "
          f"{rw.iters.double().mean(dim=1).round(decimals=1).tolist()}")
