"""The least time the chip could take for the profiled stretch's solves
(benchmark/roofline.py: the larger of operations over 67 TFLOP/s and bytes
over 3.35 TB/s), over the device time of the operations that ran there, in
%.  A PCG solve's bodies are those the reference's plain PCG takes on the
same inputs to the same exit tolerance."""

from benchmark import roofline


def read(run):
    tl = run.timeline
    if tl is None or not run.profiled_pool:
        return None
    K, s, c = run.shape
    if run.method == "pcg":
        if run.plain_bodies is None:
            return None
        bodies = sum(run.plain_bodies[p] for p in run.profiled_pool)
        flops = (len(run.profiled_pool) * run.batch * roofline.solve_flops("pcg", K, s, c)
                 + bodies * roofline.pcg_body_flops(K, s))
    else:
        flops = len(run.profiled_pool) * run.batch * roofline.solve_flops(run.method, K, s, c)
    nbytes = len(run.profiled_pool) * run.batch * roofline.solve_bytes(K, s, c)
    device_s = sum(b - a for _, a, b in tl.ops_in_window())
    return 100.0 * roofline.least_seconds(flops, nbytes) / device_s
