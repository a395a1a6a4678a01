"""Inputs of a cell, made on the device from the seed.

A problem is a random well-conditioned trajectory QP at the configuration's
widths: Q and R symmetric positive definite (a random factor F F^T, F with
entries of standard deviation 0.3, plus a diagonal shift rising from 1 to 2
along the horizon), A = -(I + dt M) with M of standard deviation 0.2 and
dt = 0.1, the sign the CSR packing of x_{k+1} - A x_k - B u_k = c gives,
B = -dt N, q and r standard normal and c of standard deviation 0.1.  It is
the recipe of the program's own test generator, written here in torch so
that a pool of problems is made on the card in a few large calls.
"""

from __future__ import annotations

import math

import torch

DT = 0.1
FACTOR_STD = 0.3
DYN_STD = 0.2
C_STD = 0.1


def _spd(g, n, K, w, device):
    F = torch.randn((n, K, w, w), generator=g, device=device) * FACTOR_STD
    M = F @ F.mT
    M = 0.5 * (M + M.mT)
    shift = torch.linspace(1.0, 2.0, K, device=device)
    return M + shift[:, None, None] * torch.eye(w, device=device)


def make_problems(n: int, K: int, s: int, c: int, seed: int, device) -> tuple:
    """``n`` problems as seven float32 tensors (Q, R, A, B, q, r, c) with a
    leading problem axis, on ``device``, from ``seed`` alone."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        Q = _spd(g, n, K, s, device)
        R = _spd(g, n, K - 1, c, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    eye = torch.eye(s, device=device)
    A = -(eye + DT * DYN_STD * torch.randn((n, K - 1, s, s), generator=g, device=device))
    B = -DT * torch.randn((n, K - 1, s, c), generator=g, device=device)
    q = torch.randn((n, K, s), generator=g, device=device)
    r = torch.randn((n, K - 1, c), generator=g, device=device)
    cc = C_STD * torch.randn((n, K, s), generator=g, device=device)
    return Q, R, A, B, q, r, cc


def problem_bytes(K: int, s: int, c: int) -> int:
    """One problem's seven float32 input blocks, in bytes."""
    return 4 * (K * s * s + (K - 1) * (c * c + s * s + s * c) + 2 * K * s + (K - 1) * c)


def pool_size(pool_mb: float, batch: int, K: int, s: int, c: int) -> int:
    """Batches in a pool of at least ``pool_mb`` megabytes of inputs, and
    at least two: a pool larger than the card's cache makes each call read
    its inputs from device memory, as a freshly linearised problem is."""
    return max(2, math.ceil(pool_mb * 1e6 / (batch * problem_bytes(K, s, c))))


def make_pool(pool: int, batch: int, K: int, s: int, c: int, seed: int,
              device) -> list:
    """``pool`` batches of ``batch`` problems each: a list of seven-tuples of
    contiguous views into one allocation per field."""
    fields = make_problems(pool * batch, K, s, c, seed, device)
    return [tuple(f[i * batch:(i + 1) * batch] for f in fields) for i in range(pool)]
