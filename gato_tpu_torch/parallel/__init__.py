"""Multi-device execution over a :class:`Mesh` of torch devices.

The counterpart of ``gato_tpu.parallel``: the knot axis of one long
trajectory sharded over the mesh (:func:`solve_sharded`,
:func:`pcg_sharded`, :func:`btd_solve_sharded`: halo rows copied between
neighbouring shards for the block-tridiagonal matvec, row 15's kernel on
each shard, dots added in shard order), and batches or farms of
independent problems split over it (:func:`solve_batched_dp`,
:func:`solve_sequence_batched_dp`, and :func:`solve_packed_dp` for one
staged ``PackedKKT``).  One process drives every shard
(mesh.py); a mesh may repeat a device.
"""

from .mesh import Mesh
from .sharded import (btd_solve_sharded, pcg_sharded, solve_batched_dp,
                      solve_packed_dp, solve_sequence_batched_dp, solve_sharded)

__all__ = ["Mesh", "solve_sharded", "pcg_sharded", "btd_solve_sharded",
           "solve_batched_dp", "solve_sequence_batched_dp", "solve_packed_dp"]
