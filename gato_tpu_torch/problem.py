"""Problem specification and solver options.

The original CUDA solver bakes the problem shape into the binary as
compile-time constants (``STATE_SIZE``, ``CONTROL_SIZE``, ``KNOT_POINTS``);
here :class:`ProblemSpec` carries them at run time.  The hand-written CUDA
kernels of this package take the shape as runtime arguments too, so a new
shape needs neither a rebuild nor a retrace.

The fields and their validation are those of ``gato_tpu.problem``; see that
module for the provenance of each option.
"""

from __future__ import annotations

import dataclasses
import enum


class Preconditioner(enum.Enum):
    """Preconditioner family for the block-tridiagonal Schur system.

    * ``JACOBI``          scalar Jacobi, 1/diag(theta_k)
    * ``BLOCK_JACOBI``    theta_k^{-1} on the main diagonal
    * ``SYMMETRIC_STAIR`` block Jacobi plus the off-diagonals
      -theta_k^{-1} phi_k theta_{k-1}^{-1} (the default)
    """

    JACOBI = "jacobi"
    BLOCK_JACOBI = "block_jacobi"
    SYMMETRIC_STAIR = "symmetric_stair"


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """Trajectory-QP shape.

    Attributes:
      state_size:   per-knot state dimension s.
      control_size: per-knot control dimension c.
      knot_points:  trajectory length K.
    """

    state_size: int
    control_size: int
    knot_points: int

    def __post_init__(self):
        if self.state_size < 1 or self.control_size < 1 or self.knot_points < 2:
            raise ValueError(
                f"invalid ProblemSpec {self}: need state_size>=1, control_size>=1,"
                " knot_points>=2"
            )

    @property
    def nx(self) -> int:
        return self.state_size

    @property
    def nu(self) -> int:
        return self.control_size

    @property
    def nk(self) -> int:
        return self.knot_points

    @property
    def nz(self) -> int:
        """Primal dimension: K*(nx+nu) - nu (no control at the last knot)."""
        return (self.state_size + self.control_size) * self.knot_points - self.control_size

    @property
    def nl(self) -> int:
        """Dual (multiplier) dimension: K*nx, one constraint block per knot."""
        return self.state_size * self.knot_points


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Runtime solver options.

    Attributes:
      exit_tol:  PCG termination threshold on |r . Pinv r| (the preconditioned
        residual dot product, not a norm).
      max_iters: PCG iteration cap.  On exhaustion the reported iteration
        count equals ``max_iters``.
      warm_start: start PCG from the supplied lambda (default False starts
        from zero).
      rho: Tikhonov regularizer added to the full diagonal of the cost
        Hessian blocks before condensation.
      preconditioner: see :class:`Preconditioner`.
      method: 'pcg' or 'direct'.  This package implements 'pcg'; 'direct'
        is accepted here (so options built for ``gato_tpu`` validate) and
        refused by the solver.
      precond_poly_degree: polynomial composition of the preconditioner,
        M_d r = P sum_{i<d} (I - S P)^i r, evaluated in Horner form.
      dtype: 'float32' (the CUDA kernels' type) or 'float64' (the plain
        torch path only).
    """

    exit_tol: float = 1e-6
    max_iters: int = 100
    warm_start: bool = False
    rho: float = 0.0
    preconditioner: Preconditioner = Preconditioner.SYMMETRIC_STAIR
    method: str = "pcg"
    precond_poly_degree: int = 1
    dtype: str = "float32"

    def __post_init__(self):
        if self.method not in ("pcg", "direct"):
            raise ValueError(f"method must be 'pcg' or 'direct', got "
                             f"{self.method!r}")
        if not isinstance(self.preconditioner, Preconditioner):
            # Accept the enum's string values too; an unknown name raises
            # here, at construction.
            object.__setattr__(self, "preconditioner",
                               Preconditioner(self.preconditioner))
        if not isinstance(self.precond_poly_degree, int) \
                or self.precond_poly_degree < 1:
            raise ValueError(
                f"precond_poly_degree must be an int >= 1, got "
                f"{self.precond_poly_degree!r}"
            )


DEFAULT_OPTIONS = SolverOptions()
