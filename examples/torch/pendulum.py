"""The reference's pendulum example (test_pendulum_5.py) on gato_tpu_torch.

Run from the repository's root:

    PYTHONPATH=. python examples/torch/pendulum.py                # the card
    PYTHONPATH=. python examples/torch/pendulum.py --device cpu   # plain PyTorch

``--device cuda`` (the default) runs the CUDA kernels and raises where CUDA
is absent; ``--device cpu`` runs their plain PyTorch versions.
"""

import argparse
import subprocess

import numpy as np
import torch
from scipy import sparse

import gato_tpu_torch as gt
from gato_tpu_torch.testing import pendulum_problem

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


p = pendulum_problem()
l, dz = gt.linsys_solve(
    p.G_row, p.G_col, p.G_val, p.C_row, p.C_col, p.C_val,
    p.g, p.c, [0.0] * 10,
    testiters=10, exit_tol=1e-6, max_iters=10, warm_start=False, rho=0.001,
    device=dev,
)

# Oracle check, exactly as the reference example does (test_pendulum_5.py:28-37)
G = sparse.csr_matrix((p.G_val, p.G_col, p.G_row)).todense()
C = sparse.csr_matrix((p.C_val, p.C_col, p.C_row)).todense()
A = np.block([[G, C.T], [C, np.zeros((C.shape[0], C.shape[0]))]])
gamma = np.block([[np.array([p.g]).T], [np.array([p.c]).T]])
x = np.linalg.inv(A).dot(gamma)
x_gato = np.block([[np.array([dz]).T], [np.array([l]).T]])
assert np.allclose(x_gato, x, rtol=1, atol=0.01)
print(f"the times above were taken on: {card_line(dev)}")
print("Test passed")
