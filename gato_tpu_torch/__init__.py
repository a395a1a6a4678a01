"""gato_tpu_torch: the trajectory-QP KKT solver on PyTorch and CUDA.

The PyTorch port of ``gato_tpu`` for an NVIDIA H100.  It imports ``torch``
and never ``jax``; ``gato_tpu`` stays the reference it is tested against.

Public surface:
  * :func:`linsys_solve`: the original 14-argument entry point (lists in/out)
  * :func:`solve`, :func:`solve_batched`: the structured API, with
    ``method='pcg'`` or the exact ``method='direct'``
  * :func:`btd_solve`: the exact block-tridiagonal solve
    (:mod:`gato_tpu_torch.direct`)
  * :func:`kkt_solve`, :func:`kkt_solve_batched`: differentiable exact
    solves, gradients by the implicit function theorem through the exact
    dispatch's kernels (:mod:`gato_tpu_torch.diff`)
  * :func:`solve_sequence`, :func:`solve_sequence_batched`: warm-started
    MPC sequences and farms (:mod:`gato_tpu_torch.mpc`)
  * :func:`pack`, :func:`solve_packed`, :func:`pack_sequence`,
    :func:`solve_packed_sequence`: the packed serving API, inputs staged
    once (:mod:`gato_tpu_torch.packed`)
  * :class:`Mesh`, :func:`solve_sharded`, :func:`pcg_sharded`,
    :func:`btd_solve_sharded`: one long trajectory with its knots sharded
    over a mesh of devices; :func:`solve_batched_dp`,
    :func:`solve_sequence_batched_dp`: batches and farms split over it
    (:mod:`gato_tpu_torch.parallel`)
  * :mod:`gato_tpu_torch.timing` (``time_solve``, ``chain_time``,
    ``measure_rtt_ms``) and :mod:`gato_tpu_torch.debug` (``solve_debug``,
    ``residual_history``, ``trace``): the measurement and debug surface
  * :class:`ProblemSpec`, :class:`SolverOptions`, :class:`Preconditioner`
  * :func:`pack_kkt`, :func:`pack_kkt_sparse` and the rest of
    :mod:`gato_tpu_torch.formats`: CSR (or scipy.sparse) ingestion and block
    packing on the host, through the native C++ packer
    (:mod:`gato_tpu_torch.native`) where a compiler is found, else NumPy
  * :mod:`gato_tpu_torch.kernels`: the hand-written CUDA kernels (the PCG
    loop, the fused whole solve, the warm-started farm, the cyclic-reduction
    exact solve, the block-Thomas pair, the long-horizon PCG and exact
    tiers, the knot shard's halo matvec and the measurement probes), each
    with its plain PyTorch version
"""

from .api import infer_spec, linsys_solve
from .diff import kkt_solve, kkt_solve_batched
from .direct import btd_solve
from .formats import KKTBlocks, blocks_to_torch, pack_kkt, pack_kkt_sparse
from .mpc import solve_sequence, solve_sequence_batched
from .packed import (PackedKKT, PackedKKTSequence, PackedSequenceResult,
                     PackedSolveResult, pack, pack_sequence, solve_packed,
                     solve_packed_sequence, update_vectors)
from .parallel import (Mesh, btd_solve_sharded, pcg_sharded, solve_batched_dp,
                       solve_sequence_batched_dp, solve_sharded)
from .problem import DEFAULT_OPTIONS, Preconditioner, ProblemSpec, SolverOptions
from .solver import SolveResult, default_pcg_backend, solve, solve_batched

__version__ = "0.1.0"

__all__ = [
    "linsys_solve",
    "infer_spec",
    "solve",
    "solve_batched",
    "btd_solve",
    "kkt_solve",
    "kkt_solve_batched",
    "solve_sequence",
    "solve_sequence_batched",
    "pack",
    "solve_packed",
    "pack_sequence",
    "solve_packed_sequence",
    "update_vectors",
    "PackedKKT",
    "PackedSolveResult",
    "PackedKKTSequence",
    "PackedSequenceResult",
    "Mesh",
    "solve_sharded",
    "pcg_sharded",
    "btd_solve_sharded",
    "solve_batched_dp",
    "solve_sequence_batched_dp",
    "default_pcg_backend",
    "SolveResult",
    "KKTBlocks",
    "blocks_to_torch",
    "pack_kkt",
    "pack_kkt_sparse",
    "ProblemSpec",
    "SolverOptions",
    "Preconditioner",
    "DEFAULT_OPTIONS",
]
