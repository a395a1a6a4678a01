"""Hand-written CUDA kernels for Hopper (sm_90a), built from ../csrc at first
use (_build.py), each beside its plain PyTorch version:

* pcg_kernel:     kernel A, the batched PCG loop
* fused_solve:    kernel B, the whole batched solve
* fused_sequence: row 3, the warm-started farm (T steps of kernel B's body
                  for each stream, in one launch)
* direct_fused:   row 4, the exact solve by cyclic reduction
* thomas_batch:   rows 5 and 6, the exact solve by block Thomas
* longk:          rows 7, 8/10, 9 and 13, the long-horizon PCG tier
                  (condensation, cooperative PCG, both in one launch, and
                  recovery) past kernels A and B's shared memory, and rows
                  11 and 12, its exact tier (cyclic reduction)
* halo_matvec:    row 15, the block-tridiagonal matvec of one knot shard
                  with its neighbours' halo rows (parallel/sharded.py)
* probes:         rows 16-18, the measurement probes (the iteration chain
                  at block and grid scope, the column-FMA chain, the null
                  copy of the dispatch floor; tools/probe_*.py)
"""
