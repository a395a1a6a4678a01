"""CSR ingestion: sparse KKT inputs -> per-knot block arrays (NumPy).

The same packing, with the same hard errors, as ``gato_tpu.formats``'s NumPy
path, which is the semantics oracle there; the blocks come out bit-equal.
The layout:

  * ``Q``: (K, s, s)    per-knot state cost Hessians
  * ``R``: (K-1, c, c)  per-interval control cost Hessians
  * ``A``: (K-1, s, s)  constraint-Jacobian state blocks (raw CSR values,
                        i.e. the negated dynamics Jacobians)
  * ``B``: (K-1, s, c)  constraint-Jacobian control blocks
  * ``q``: (K, s), ``r``: (K-1, c)  gradient segments
  * ``c``: (K, s)       constraint residual per knot

The first ``s`` rows of C (the initial-condition identity) and the implicit
+I on x_{k+1} are skipped; every other entry outside the trajectory-QP
pattern is a ``ValueError``.  rho is not applied here but at condensation,
on the full diagonal.

:func:`blocks_to_torch` moves a block set (NumPy arrays or tensors, with or
without leading batch axes) onto a torch device in one dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .problem import ProblemSpec


class KKTBlocks(NamedTuple):
    """Struct-of-blocks KKT data (NumPy arrays or tensors, leading knot axis)."""

    Q: object  # (K, s, s)
    R: object  # (K-1, c, c)
    A: object  # (K-1, s, s)
    B: object  # (K-1, s, c)
    q: object  # (K, s)
    r: object  # (K-1, c)
    c: object  # (K, s)


def check_block_shapes(spec: ProblemSpec, blocks: KKTBlocks,
                       lead: tuple = ()) -> None:
    """Validate every KKTBlocks field against ``spec`` plus optional leading
    batch axes.  The CUDA kernels index by the spec's shape, so a malformed
    field must be rejected here rather than read out of bounds."""
    K, s, c = spec.knot_points, spec.state_size, spec.control_size
    lead = tuple(lead)
    expect = {
        "Q": lead + (K, s, s), "R": lead + (K - 1, c, c),
        "A": lead + (K - 1, s, s), "B": lead + (K - 1, s, c),
        "q": lead + (K, s), "r": lead + (K - 1, c), "c": lead + (K, s),
    }
    for name, arr in zip(expect, blocks):
        if tuple(arr.shape) != expect[name]:
            raise ValueError(
                f"blocks.{name} shape {tuple(arr.shape)} does not match "
                f"{expect[name]} for {spec}")


def _csr_to_coo(indptr, indices, data):
    """Expand CSR to (rows, cols, vals) without scipy."""
    indptr = np.asarray(indptr, dtype=np.int64)
    counts = np.diff(indptr)
    rows = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    return rows, np.asarray(indices, dtype=np.int64), np.asarray(data)


def pack_G(spec: ProblemSpec, G_indptr, G_indices, G_data, dtype=np.float32):
    """Pack the CSR cost Hessian G into (Q, R) block arrays."""
    s, c, K = spec.state_size, spec.control_size, spec.knot_points
    sc = s + c
    rows, cols, vals = _csr_to_coo(G_indptr, G_indices, G_data)

    nz = spec.nz
    if rows.size and (rows.max() >= nz or cols.max() >= nz):
        raise ValueError(f"G entry out of range for nz={nz}")
    if np.any(rows // sc != cols // sc):
        raise ValueError("G has entries coupling different knot points; the "
                         "trajectory-QP Hessian must be block-diagonal per knot")

    knot = rows // sc
    i = rows % sc
    j = cols % sc
    in_state = (i < s) & (j < s)
    in_ctrl = (i >= s) & (j >= s)
    if not np.all(in_state | in_ctrl):
        raise ValueError("G has state-control cross terms; the reference layout "
                         "supports only block-diagonal [Q_k, R_k] Hessians")

    Q = np.zeros((K, s, s), dtype=dtype)
    R = np.zeros((K - 1, c, c), dtype=dtype)
    m = in_state
    Q[knot[m], i[m], j[m]] = vals[m].astype(dtype)
    m = in_ctrl
    if np.any(knot[m] >= K - 1):
        raise ValueError("G has a control block at the final knot (the final knot "
                         "has no control)")
    R[knot[m], i[m] - s, j[m] - s] = vals[m].astype(dtype)
    return Q, R


def pack_C(spec: ProblemSpec, C_indptr, C_indices, C_data, dtype=np.float32):
    """Pack the CSR constraint Jacobian C into (A, B) block arrays: skip the
    first ``s`` rows (initial-condition identity) and the implicit +I on
    x_{k+1}; anything else off the block-bidiagonal pattern raises."""
    s, c, K = spec.state_size, spec.control_size, spec.knot_points
    sc = s + c
    rows, cols, vals = _csr_to_coo(C_indptr, C_indices, C_data)

    keep = rows >= s
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    k = rows // s - 1  # interval index
    cb = cols // sc
    if np.any(cb > k + 1):
        raise ValueError("C has entries right of the x_{k+1} identity "
                         "block; only block-bidiagonal constraint Jacobians "
                         "are supported")
    keep = cb <= k  # drop the identity block on x_{k+1}
    rows, cols, vals, k = rows[keep], cols[keep], vals[keep], k[keep]
    if np.any(cols // sc != k):
        raise ValueError("C has entries left of the current interval's column "
                         "block; only block-bidiagonal constraint Jacobians are "
                         "supported")

    i = rows % s
    j = cols % sc
    A = np.zeros((K - 1, s, s), dtype=dtype)
    B = np.zeros((K - 1, s, c), dtype=dtype)
    m = j < s
    A[k[m], i[m], j[m]] = vals[m].astype(dtype)
    m = ~m
    B[k[m], i[m], j[m] - s] = vals[m].astype(dtype)
    return A, B


def pack_vectors(spec: ProblemSpec, g, c_vec, dtype=np.float32):
    """Split the interleaved gradient g = [q_0,r_0,q_1,r_1,...,q_{K-1}] and the
    constraint residual c into per-knot segments."""
    s, c, K = spec.state_size, spec.control_size, spec.knot_points
    sc = s + c
    g = np.asarray(g, dtype=dtype)
    c_vec = np.asarray(c_vec, dtype=dtype)
    if g.shape != (spec.nz,):
        raise ValueError(f"g must have shape ({spec.nz},), got {g.shape}")
    if c_vec.shape != (spec.nl,):
        raise ValueError(f"c must have shape ({spec.nl},), got {c_vec.shape}")
    head = g[: (K - 1) * sc].reshape(K - 1, sc)
    gq = np.concatenate([head[:, :s], g[None, (K - 1) * sc:]], axis=0)
    gr = np.ascontiguousarray(head[:, s:])
    return gq, gr, c_vec.reshape(K, s)


def pack_kkt(
    spec: ProblemSpec,
    G_indptr, G_indices, G_data,
    C_indptr, C_indices, C_data,
    g, c_vec,
    dtype=np.float32,
) -> KKTBlocks:
    """Full CSR -> KKTBlocks ingestion (NumPy arrays)."""
    Q, R = pack_G(spec, G_indptr, G_indices, G_data, dtype)
    A, B = pack_C(spec, C_indptr, C_indices, C_data, dtype)
    q, r, cc = pack_vectors(spec, g, c_vec, dtype)
    return KKTBlocks(Q=Q, R=R, A=A, B=B, q=q, r=r, c=cc)


def interleave_dz(spec: ProblemSpec, dz_x: np.ndarray, dz_u: np.ndarray) -> np.ndarray:
    """Merge (K,s) state steps and (K-1,c) control steps into the flat
    [dz_x0, dz_u0, dz_x1, ..., dz_x_{K-1}] layout ``linsys_solve`` returns."""
    s, c, K = spec.state_size, spec.control_size, spec.knot_points
    head = np.concatenate([dz_x[: K - 1], dz_u], axis=1).reshape(-1)
    return np.concatenate([head, dz_x[K - 1]])


def blocks_to_dense_kkt(spec: ProblemSpec, blocks: KKTBlocks, rho: float = 0.0):
    """Rebuild the dense saddle-point matrix [[G+rho*I, C^T], [C, 0]] and rhs
    [g; c] from block form (float64).  Test oracle only."""
    s, c, K = spec.state_size, spec.control_size, spec.knot_points
    sc = s + c
    nz, nl = spec.nz, spec.nl
    blocks = KKTBlocks(*(np.asarray(a, dtype=np.float64) for a in blocks))
    G = np.zeros((nz, nz))
    C = np.zeros((nl, nz))
    g = np.zeros(nz)
    for k in range(K):
        o = k * sc
        G[o : o + s, o : o + s] = blocks.Q[k] + rho * np.eye(s)
        g[o : o + s] = blocks.q[k]
        if k < K - 1:
            G[o + s : o + sc, o + s : o + sc] = blocks.R[k] + rho * np.eye(c)
            g[o + s : o + sc] = blocks.r[k]
    C[0:s, 0:s] = np.eye(s)
    for k in range(K - 1):
        ro = (k + 1) * s
        co = k * sc
        C[ro : ro + s, co : co + s] = blocks.A[k]
        C[ro : ro + s, co + s : co + sc] = blocks.B[k]
        C[ro : ro + s, co + sc : co + sc + s] = np.eye(s)
    KKT = np.block([[G, C.T], [C, np.zeros((nl, nl))]])
    rhs = np.concatenate([g, blocks.c.reshape(-1)])
    return KKT, rhs


def blocks_to_torch(blocks, device, dtype=torch.float32) -> KKTBlocks:
    """KKTBlocks of NumPy arrays (for example ``gato_tpu.KKTBlocks``) or
    tensors -> KKTBlocks of contiguous tensors on ``device`` in ``dtype``.
    A field already on that device in that dtype is not copied."""
    device = torch.device(device)
    return KKTBlocks(*(
        torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                        dtype=dtype, device=device).contiguous()
        for a in blocks
    ))
