"""Megabytes of global scratch kernel B allocated a launch for its knots'
records (``fused_solve.SCRATCH_FLOATS`` x 4 B over ``fused_solve.LAUNCHES``,
both counted over the whole process; every launch of a cell has one shape):
0 where the plan keeps the records in shared memory.  Nothing in an
exact-solve cell, or where the program has no such counter."""


def read(run):
    if run.method != "pcg":
        return None
    from gato_tpu_torch.kernels import fused_solve
    floats = getattr(fused_solve, "SCRATCH_FLOATS", None)
    launches = getattr(fused_solve, "LAUNCHES", 0)
    if floats is None or not launches:
        return None
    return 4.0 * floats / 1e6 / launches
