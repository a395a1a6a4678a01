"""gato_tpu_torch: the trajectory-QP KKT solver on PyTorch and CUDA.

The PyTorch port of ``gato_tpu`` for an NVIDIA H100.  It imports ``torch``
and never ``jax``; ``gato_tpu`` stays the reference it is tested against.

Public surface:
  * :func:`linsys_solve`: the original 14-argument entry point (lists in/out)
  * :func:`solve`, :func:`solve_batched`: the structured API
  * :class:`ProblemSpec`, :class:`SolverOptions`, :class:`Preconditioner`
  * :mod:`gato_tpu_torch.formats`: CSR ingestion and block packing (NumPy)
  * :mod:`gato_tpu_torch.kernels`: the hand-written CUDA kernels (the PCG
    loop and the fused whole solve), each with its plain PyTorch version
"""

from .api import infer_spec, linsys_solve
from .formats import KKTBlocks, blocks_to_torch, pack_kkt
from .problem import DEFAULT_OPTIONS, Preconditioner, ProblemSpec, SolverOptions
from .solver import SolveResult, default_pcg_backend, solve, solve_batched

__version__ = "0.1.0"

__all__ = [
    "linsys_solve",
    "infer_spec",
    "solve",
    "solve_batched",
    "default_pcg_backend",
    "SolveResult",
    "KKTBlocks",
    "blocks_to_torch",
    "pack_kkt",
    "ProblemSpec",
    "SolverOptions",
    "Preconditioner",
    "DEFAULT_OPTIONS",
]
