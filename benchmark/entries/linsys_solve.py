"""gato-python's own call: ``linsys_solve`` from CSR, one KKT system a call.

``prepare`` turns each generated problem (a batch of one) into the call's
14 arguments as a caller that builds G and C with ``scipy.sparse`` holds
them: G and C as CSR (int32 ``indptr`` and ``indices``, float64 ``data``),
g and c float64, all NumPy arrays in host memory; ``input_lambda`` zeros,
``testiters`` 1, ``exit_tol``, ``max_iters`` and ``rho`` from the
configuration, ``warm_start`` False.  The CSR layout is written here from
the system's definition (``reference/kkt.py``'s docstring), with nothing
taken from the program: G = blockdiag(Q_0, R_0, Q_1, ..., Q_{K-1}), each
block stored dense, row by row; C's first s rows are the initial-condition
identity, then row (k+1) s + i holds A_k[i] on x_k, B_k[i] on u_k and 1 on
x_{k+1}[i]; g = [q_0, r_0, q_1, ..., q_{K-1}] and c knot by knot.

``solve`` is the timed call: ``gato_tpu_torch.linsys_solve(*args)`` with
its defaults on the card (packing, staging, the solve, the synchronise,
the two printed lines, two lists back), what it prints going to a buffer
of the call's own.  ``to_result`` rebuilds lam, dz_x and dz_u from the
lists and reads the iteration count from the printed line.
"""

from __future__ import annotations

import contextlib
import io
import re
from typing import NamedTuple

import numpy as np
import torch

from benchmark.harness import Result

ITERS = re.compile(r"first run PCG terminated in (\d+) iterations")


class Answer(NamedTuple):
    """What one call returned and printed, with the widths and the
    iteration cap that read it back."""
    lam: list
    dz: list
    printed: str
    shape: tuple     # (K, s, c)
    max_iters: int


def structure(K: int, s: int, c: int) -> tuple:
    """(G indptr, G indices, C indptr, C indices), int32: the sparsity of
    every problem at these widths."""
    sc = s + c
    knots = np.arange(K)[:, None, None] * sc
    q_cols = np.broadcast_to(knots + np.arange(s), (K, s, s))
    r_cols = np.broadcast_to(knots[:-1] + s + np.arange(c), (K - 1, c, c))
    G_indices = np.concatenate([
        np.concatenate([q_cols[:-1].reshape(K - 1, -1), r_cols.reshape(K - 1, -1)], 1).ravel(),
        q_cols[-1].ravel()])
    G_counts = np.concatenate([np.tile(np.repeat([s, c], [s, c]), K - 1), np.full(s, s)])
    step = np.broadcast_to(knots[:-1] + np.arange(sc), (K - 1, s, sc))
    nxt = knots[1:] + np.arange(s)[:, None]
    C_indices = np.concatenate([np.arange(s), np.concatenate([step, nxt], 2).ravel()])
    C_counts = np.concatenate([np.ones(s, np.int64), np.full((K - 1) * s, sc + 1)])
    indptr = lambda counts: np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return (indptr(G_counts), G_indices.astype(np.int32),
            indptr(C_counts), C_indices.astype(np.int32))


def values(Q, R, A, B, q, r, c) -> tuple:
    """(G data, C data, g, c) of ``n`` problems, each with a leading axis
    of n, in float64, in :func:`structure`'s order."""
    n, K, s = q.shape
    cd = r.shape[2]
    G = np.concatenate([
        np.concatenate([Q[:, :-1].reshape(n, K - 1, s * s), R.reshape(n, K - 1, cd * cd)],
                       2).reshape(n, -1),
        Q[:, -1].reshape(n, s * s)], 1)
    C = np.concatenate([
        np.ones((n, s)),
        np.concatenate([A, B, np.ones((n, K - 1, s, 1))], 3).reshape(n, -1)], 1)
    g = np.concatenate([np.concatenate([q[:, :-1], r], 2).reshape(n, -1), q[:, -1]], 1)
    return (G.astype(np.float64), C.astype(np.float64), g.astype(np.float64),
            c.reshape(n, K * s).astype(np.float64))


def program(cell, device: torch.device):
    """(prepare, solve) of ``linsys_solve`` from CSR, one system a call."""
    import gato_tpu_torch as gt

    cfg, sv = cell.config, cell.config["solver"]
    K, s, c = cfg["knot_points"], cfg["state_size"], cfg["control_size"]
    if int(cell.traffic["batch"]) != 1:
        raise ValueError("linsys_solve takes one KKT system a call: batch must be 1")
    # The call can set only these four options; the rest are its defaults.
    stated = gt.SolverOptions(
        rho=sv["rho"], exit_tol=sv["exit_tol"], max_iters=sv["max_iters"],
        preconditioner=sv["preconditioner"], precond_poly_degree=sv["precond_poly_degree"],
        dtype=sv["dtype"], method=cell.traffic["method"])
    called = gt.SolverOptions(exit_tol=sv["exit_tol"], max_iters=sv["max_iters"],
                              warm_start=False, rho=sv["rho"])
    if stated != called:
        raise ValueError(f"linsys_solve runs {called}; the cell states {stated}")
    on_default = device.type == "cuda" and device.index in (None, torch.cuda.current_device())
    where = {} if on_default else {"device": device}
    G_indptr, G_indices, C_indptr, C_indices = structure(K, s, c)
    lam0 = np.zeros(K * s)
    tail = (lam0, 1, sv["exit_tol"], sv["max_iters"], False, sv["rho"])

    def prepare(fields):
        # One copy to the host a problem, split into its seven fields there.
        flat = torch.cat([f.reshape(-1) for f in fields]).cpu().numpy()
        parts = np.split(flat, np.cumsum([f.numel() for f in fields])[:-1])
        G, C, g, cc = values(*(a.reshape(f.shape) for a, f in zip(parts, fields)))
        return (G_indptr, G_indices, G[0], C_indptr, C_indices, C[0], g[0], cc[0], *tail)

    def solve(args):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            lam, dz = gt.linsys_solve(*args, **where)
        return Answer(lam, dz, printed.getvalue(), (K, s, c), sv["max_iters"])

    return prepare, solve


def to_result(out: Answer) -> Result:
    """One call's answer as a batch of one, on the host: ``iters`` read from
    the printed line, ``converged`` where it is under ``max_iters`` (the
    exit test fired), ``eta`` NaN (not returned)."""
    found = ITERS.search(out.printed)
    if found is None:
        raise ValueError(f"linsys_solve printed no iteration count: {out.printed!r}")
    iters = int(found.group(1))
    K, s, c = out.shape
    sc = s + c
    dz = torch.tensor(out.dz, dtype=torch.float32)
    head = dz[:(K - 1) * sc].reshape(K - 1, sc)
    dz_x = torch.cat([head[:, :s], dz[(K - 1) * sc:].reshape(1, s)])
    return Result(torch.tensor(out.lam, dtype=torch.float32).reshape(1, K, s),
                  dz_x[None], head[None, :, s:],
                  torch.tensor([iters], dtype=torch.int32),
                  torch.tensor([iters < out.max_iters]),
                  torch.tensor([float("nan")]))
