"""Mean of the program's returned PCG iteration counts over every solve of
the window; nothing in an exact-solve cell."""


def read(run):
    if run.method != "pcg" or not run.iters:
        return None
    import torch
    return float(torch.cat([t.flatten() for t in run.iters]).double().mean())
