"""IIWA-scale (14, 7, 50) solves on gato_tpu_torch: single, batched, and
an MPC sequence.

Run from the repository's root:

    PYTHONPATH=. python examples/torch/iiwa_batch.py                # the card
    PYTHONPATH=. python examples/torch/iiwa_batch.py --device cpu   # plain PyTorch

``--device cuda`` (the default) runs kernel B for the solves and the
sequence kernel for the MPC chain, and raises where CUDA is absent;
``--device cpu`` runs their plain PyTorch versions.  The time it prints is
the device's, with the card's name and power limit beside it.
"""

import argparse
import subprocess
import time

import numpy as np
import torch

import gato_tpu_torch as gt
from gato_tpu_torch.testing import dense_oracle, random_batch, random_blocks

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
dev = torch.device(parser.parse_args().device)
if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("--device cuda was asked for but torch.cuda.is_available() "
                       "is False; pass --device cpu for the plain PyTorch path")


def card_line(dev: torch.device) -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    if dev.type != "cuda":
        return "cpu (plain PyTorch versions)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", f"--id={dev.index or 0}"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


spec = gt.ProblemSpec(state_size=14, control_size=7, knot_points=50)
opts = gt.SolverOptions(exit_tol=1e-6, max_iters=200, rho=1e-3)

# --- single solve, checked against the dense oracle -------------------------
blocks = random_blocks(spec, seed=0)
res = gt.solve(spec, blocks, opts, device=dev)
lam_ref, _ = dense_oracle(spec, blocks, rho=1e-3)
err = np.max(np.abs(res.lam_flat() - lam_ref))
print(f"single solve: {int(res.iters)} PCG iters, max |err| vs oracle {err:.2e}")

# --- 256 independent problems in one launch ---------------------------------
# The inputs are staged on the device once; the timed call is the second,
# after one warm call (which also builds the kernels on the card's first use).
B = 256
batch = gt.blocks_to_torch(random_batch(spec, B, seed0=100), dev)
bres = gt.solve_batched(spec, batch, opts, device=dev)
sync()
t0 = time.perf_counter()
bres = gt.solve_batched(spec, batch, opts, device=dev)
sync()
dt = time.perf_counter() - t0
print(f"batch {B}: all converged={bool(bres.converged.all())}, "
      f"{dt * 1e6 / B:.1f} us/solve  [{card_line(dev)}]")

# --- MPC: 32 warm-started dependent solves in one launch --------------------
T = 32
seq = gt.KKTBlocks(*(np.broadcast_to(a, (T,) + a.shape).copy() for a in blocks))
sres = gt.solve_sequence(spec, seq, opts, device=dev)
print(f"MPC sequence: first solve {int(sres.iters[0])} iters, "
      f"warm-started rest mean {float(sres.iters[1:].double().mean()):.1f} iters")
