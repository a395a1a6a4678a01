"""Hand-written CUDA kernels for Hopper (sm_90a), built from ../csrc at first
use (_build.py), each beside its plain PyTorch version:

* pcg_kernel:     kernel A, the batched PCG loop
* fused_solve:    kernel B, the whole batched solve
* fused_sequence: row 3, the warm-started farm (T steps of kernel B's body
                  for each stream, in one launch)
"""
