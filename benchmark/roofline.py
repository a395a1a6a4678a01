"""The least time an H100 could take for a cell's solves, from the work
these inputs need: operations and bytes counted from the shapes, whatever
implements them.

Peaks (NVIDIA H100 SXM data sheet, at its 700 W limit): 67 TFLOP/s in
float32 outside the tensor cores, 3.35 TB/s of HBM3.  An n x n inverse or
product counts 2 n^3 operations, a matrix-vector product 2 n^2.  Bytes are
each input block read once and each output written once.
"""

from __future__ import annotations

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
F32 = 4


def condense_flops(K: int, s: int, c: int) -> float:
    """Qinv, Rinv, phi, B Rinv, theta and gamma of one problem."""
    f = K * 2 * s ** 3 + (K - 1) * 2 * c ** 3
    f += (K - 1) * (2 * s ** 3 + 2 * s * c * c)
    f += (K - 1) * (2 * s ** 3 + 2 * s * s * c)
    f += K * 2 * s * s + (K - 1) * (2 * s * s + 2 * s * c)
    return f


def recover_flops(K: int, s: int, c: int) -> float:
    """dz_x and dz_u of one problem from its multipliers."""
    return (K - 1) * 2 * s * s + K * 2 * s * s + (K - 1) * (2 * s * c + 2 * c * c)


def stair_flops(K: int, s: int) -> float:
    """The symmetric-stair preconditioner: theta^-1 of every knot and two
    off-diagonal products of three blocks a knot."""
    return K * 2 * s ** 3 + 4 * (K - 1) * 2 * s ** 3


def pcg_body_flops(K: int, s: int) -> float:
    """One PCG body: an S matvec and the preconditioner's apply, each a
    block-tridiagonal matvec (6 K s^2), and ~10 K s for dots and updates."""
    return 2 * 6 * K * s * s + 10 * K * s


def thomas_flops(K: int, s: int) -> float:
    """Block Thomas on S lambda = gamma: per knot a pivot inverse, from the
    second knot L C^-1, (L C^-1) U and (L C^-1) y; back, C^-1 (y - U x)."""
    return (K * 2 * s ** 3 + (K - 1) * (4 * s ** 3 + 2 * s * s)
            + K * 2 * s * s + (K - 1) * 2 * s * s)


def solve_flops(method: str, K: int, s: int, c: int, bodies: float = 0.0) -> float:
    """One problem's operations: condensation and recovery, with the
    preconditioner and ``bodies`` PCG bodies (``'pcg'``) or block Thomas
    (``'direct'``)."""
    base = condense_flops(K, s, c) + recover_flops(K, s, c)
    if method == "pcg":
        return base + stair_flops(K, s) + bodies * pcg_body_flops(K, s)
    if method == "direct":
        return base + thomas_flops(K, s)
    raise ValueError(f"unknown method {method!r}")


def pcg_bodies(iters: int, converged: bool) -> int:
    """Bodies a PCG solve runs: the set-up counts one, and a loop that
    exited at index i ran i + 1 (one that never did, ``iters`` =
    max_iters)."""
    return iters + int(converged) + 1


def solve_bytes(K: int, s: int, c: int) -> int:
    """One problem's inputs (Q, R, A, B, q, r, c) read once and outputs
    (lambda, dz_x, dz_u; eta, iters, converged) written once."""
    inputs = K * s * s + (K - 1) * (c * c + s * s + s * c) + K * s + (K - 1) * c + K * s
    outputs = 2 * K * s + (K - 1) * c
    return F32 * (inputs + outputs) + F32 + F32 + 1


def least_seconds(flops: float, nbytes: float) -> float:
    """The larger of operations over the float32 peak and bytes over the
    memory peak."""
    return max(flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S)
