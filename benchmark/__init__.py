"""The benchmark of gato_tpu_torch: KKT solves through solve_batched on one NVIDIA H100.

``python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` at the root of the checkout.
"""
