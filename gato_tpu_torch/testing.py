"""Problem generators and oracles (NumPy only).

The same generators as ``gato_tpu.testing``, value for value from the same
seed, so that the port and the JAX package can be fed identical data and so
that a machine without JAX can still build them:

* :func:`pendulum_problem`: the original solver's (2,1,5) integration test
  data, the parity gate;
* :func:`random_blocks`: random well-conditioned trajectory QPs shaped like
  the original's default IIWA build (14, 7, 50);
* :func:`random_farm`: slowly varying (T, B) streams of them for the MPC
  farms;
* :func:`blocks_to_csr`: emit blocks in the 14-argument CSR form;
* :func:`dense_oracle`: the exact float64 dense saddle-point solve.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .formats import KKTBlocks, blocks_to_dense_kkt
from .problem import ProblemSpec

IIWA = ProblemSpec(state_size=14, control_size=7, knot_points=50)


@dataclasses.dataclass
class CSRProblem:
    """A KKT problem in the raw-CSR API form."""

    spec: ProblemSpec
    G_row: list
    G_col: list
    G_val: list
    C_row: list
    C_col: list
    C_val: list
    g: list
    c: list


def pendulum_problem() -> CSRProblem:
    """The (2,1,5) pendulum KKT system of the original integration test."""
    spec = ProblemSpec(state_size=2, control_size=1, knot_points=5)
    G_row = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14]
    G_col = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13]
    G_val = [1., 1., 0.1, 1., 1., 0.1, 1., 1., 0.1, 1., 1., 0.1, 100., 100.]
    C_row = [0, 1, 2, 5, 9, 12, 16, 19, 23, 26, 30]
    C_col = [0, 1, 0, 1, 3, 0, 1, 2, 4, 3, 4, 6, 3, 4, 5, 7, 6, 7, 9, 6, 7, 8,
             10, 9, 10, 12, 9, 10, 11, 13]
    C_val = [1., 1., -1., -0.1, 1., 0.981, -1., -0.1, 1., -1., -0.1, 1., 0.981,
             -1., -0.1, 1., -1., -0.1, 1., 0.981, -1., -0.1, 1., -1., -0.1, 1.,
             0.981, -1., -0.1, 1.]
    g = [-3.1416, 0., 0., -3.1416, 0., 0., -3.1416, 0., 0., -3.1416, 0., 0.,
         -314.159, 0.]
    c = [0.] * 10
    return CSRProblem(spec, G_row, G_col, G_val, C_row, C_col, C_val, g, c)


def random_blocks(
    spec: ProblemSpec,
    seed: int = 0,
    *,
    diag_G: bool = False,
    c_zero: bool = False,
    dtype=np.float32,
) -> KKTBlocks:
    """Random well-conditioned trajectory QP in block form.

    Q/R are SPD (random factor + diagonal shift); A approximates a
    discrete-dynamics Jacobian -(I + dt*M), the sign convention the CSR
    packing produces for x_{k+1} - A x_k - B u_k = c.
    """
    rng = np.random.default_rng(seed)
    s, c, K = spec.state_size, spec.control_size, spec.knot_points

    def spd(n, count):
        if diag_G:
            d = rng.uniform(0.5, 2.0, size=(count, n))
            out = np.zeros((count, n, n))
            out[:, np.arange(n), np.arange(n)] = d
            return out
        F = rng.normal(size=(count, n, n)) * 0.3
        return F @ F.transpose(0, 2, 1) + np.eye(n)[None] * np.linspace(
            1.0, 2.0, count
        )[:, None, None]

    Q = spd(s, K)
    R = spd(c, K - 1)
    dt = 0.1
    A = -(np.eye(s)[None] + dt * rng.normal(size=(K - 1, s, s)) * 0.2)
    B = -dt * rng.normal(size=(K - 1, s, c))
    q = rng.normal(size=(K, s))
    r = rng.normal(size=(K - 1, c))
    cc = np.zeros((K, s)) if c_zero else rng.normal(size=(K, s)) * 0.1
    return KKTBlocks(*(x.astype(dtype) for x in (Q, R, A, B, q, r, cc)))


def stack_blocks(blocks_list) -> KKTBlocks:
    """Stack single-problem KKTBlocks into one batch (leading axis)."""
    return KKTBlocks(*(np.stack([np.asarray(b[f]) for b in blocks_list])
                       for f in range(7)))


def random_batch(spec: ProblemSpec, n: int, seed0: int = 0, **kw) -> KKTBlocks:
    """``n`` problems from seeds seed0 .. seed0+n-1, stacked."""
    return stack_blocks([random_blocks(spec, seed=seed0 + i, **kw)
                         for i in range(n)])


def random_farm(spec: ProblemSpec, T: int, n: int, seed0: int = 0,
                drift: float = 0.01) -> KKTBlocks:
    """A farm of ``n`` streams of ``T`` steps, leading (T, n) axes: each
    stream's matrices fixed over the steps (:func:`random_batch` from
    ``seed0``), its q, r and c drifting in a seeded random walk of ``drift``
    times their mean size a step, as in MPC tracking with frozen dynamics."""
    rng = np.random.default_rng(seed0 + 7)
    base = random_batch(spec, n, seed0=seed0)
    out = []
    for name, a in zip(KKTBlocks._fields, base):
        x = np.broadcast_to(a, (T,) + a.shape)
        if name in ("q", "r", "c"):
            walk = np.cumsum(rng.normal(size=x.shape), axis=0)
            x = x + drift * np.abs(a).mean() * walk
        out.append(np.ascontiguousarray(x, dtype=np.float32))
    return KKTBlocks(*out)


def singular_blocks(spec: ProblemSpec, seed: int = 3, knot: int = 2) -> KKTBlocks:
    """Blocks whose Q[knot] has an exactly-zero first row and column: at
    rho=0 the condensation meets an exactly-zero pivot in a block whose
    diagonal is not all zero."""
    b = random_blocks(spec, seed=seed)
    Q = np.asarray(b.Q).copy()
    Q[knot, :, 0] = 0.0
    Q[knot, 0, :] = 0.0
    return b._replace(Q=Q)


def blocks_to_csr(spec: ProblemSpec, blocks: KKTBlocks) -> CSRProblem:
    """Emit a block problem in the raw-CSR API form (dense blocks stored
    explicitly, which exercises the full packing path)."""
    s, c, K = spec.state_size, spec.control_size, spec.knot_points
    sc = s + c
    nz, nl = spec.nz, spec.nl

    # G: block diagonal [Q_0, R_0, ..., Q_{K-1}]
    G_row, G_col, G_val = [0], [], []
    for row in range(nz):
        k, i = row // sc, row % sc
        if i < s:
            cols = range(k * sc, k * sc + s)
            vals = blocks.Q[k][i]
        else:
            cols = range(k * sc + s, (k + 1) * sc)
            vals = blocks.R[k][i - s]
        G_col.extend(cols)
        G_val.extend(map(float, vals))
        G_row.append(len(G_col))

    # C: identity block then [A_k B_k I] rows
    C_row, C_col, C_val = [0], [], []
    for row in range(nl):
        if row < s:
            C_col.append(row)
            C_val.append(1.0)
        else:
            k, i = row // s - 1, row % s
            C_col.extend(range(k * sc, (k + 1) * sc))
            C_val.extend(map(float, blocks.A[k][i]))
            C_val.extend(map(float, blocks.B[k][i]))
            C_col.append((k + 1) * sc + i)
            C_val.append(1.0)
        C_row.append(len(C_col))

    g = np.zeros(nz)
    for k in range(K):
        g[k * sc : k * sc + s] = blocks.q[k]
        if k < K - 1:
            g[k * sc + s : (k + 1) * sc] = blocks.r[k]
    return CSRProblem(
        spec,
        G_row, G_col, G_val,
        C_row, C_col, C_val,
        list(map(float, g)),
        list(map(float, np.asarray(blocks.c).reshape(-1))),
    )


def dense_oracle(spec: ProblemSpec, blocks: KKTBlocks, rho: float = 0.0):
    """Exact (lam, dz_flat) by the dense float64 saddle-point solve, with rho
    on the G diagonal."""
    KKT, rhs = blocks_to_dense_kkt(spec, blocks, rho=rho)
    x = np.linalg.solve(KKT, rhs)
    return x[spec.nz :], x[: spec.nz]
