"""Kernel B and the farm kernel, bit for bit, between two checkouts.

    python3 gato_tpu_torch/tools/bitcheck.py dump ROOT OUT.pt
    python3 gato_tpu_torch/tools/bitcheck.py compare A.pt B.pt

``dump`` imports gato_tpu_torch from the checkout at ROOT (building its
kernels there), runs kernel B (fused_solve_cuda) at IIWA (14, 7, 50), B = 1
and 256, for every preconditioner and poly degree 1 and 2, on one exactly
singular mix, and the farm kernel (fused_sequence_cuda) on T = 16 farms of
B = 1 and 256 streams, and saves every output with ptxas's register and
spill report of the build.  ``compare`` exits 1 unless every output of the
two dumps is bit-identical, and prints both builds' ptxas reports.  It
needs one CUDA card; the inputs come from testing's seeded generators.

A refactor of csrc/cluster_body.cuh (the body both kernels compile) must
pass it against the parent's checkout: it may move registers, not bits.
A change of the arithmetic by design does not pass, and says so: the
cluster layout of kernel B and the farm kernel (cluster_body.cuh, which
replaced the one-CTA fused_body.cuh) sums each dot product over C CTAs in
rank order and reads its Gauss-Jordan pivot rows differently, so its bits
differ from the one-CTA kernel's, within the plain version's tolerance.
csrc/condense.cuh and csrc/pcg_common.cuh, shared by kernel A, rows 4, 5,
7, 8/10 and 13 and the probes, are no longer compiled into kernel B or the
farm; a change to them is checked by those kernels' card tests and by this
tool extended to them.
"""

from __future__ import annotations

import sys
from pathlib import Path


def dump(root: str, out: str) -> None:
    sys.path.insert(0, root)
    import torch

    import gato_tpu_torch as gt
    from gato_tpu_torch import testing as tt
    from gato_tpu_torch.kernels import _build
    from gato_tpu_torch.kernels import fused_sequence as ks
    from gato_tpu_torch.kernels import fused_solve as kb

    if not gt.__file__.startswith(str(Path(root).resolve())):
        raise SystemExit(f"imported {gt.__file__}, not the checkout at {root}")
    dev = torch.device("cuda", 0)
    log = _build.build()["log"]
    spec = tt.IIWA
    full = gt.blocks_to_torch(tt.random_batch(spec, 256, seed0=0), dev)
    outputs = {}

    def keep(tag, res, dz_x, dz_u):
        for name, t in (("lam", res.lam), ("iters", res.iters),
                        ("converged", res.converged), ("eta", res.eta),
                        ("dz_x", dz_x), ("dz_u", dz_u)):
            outputs[f"{tag} {name}"] = t.cpu()

    for n in (1, 256):
        blocks = gt.KKTBlocks(*(a[:n] for a in full))
        for prec in ("symmetric_stair", "block_jacobi", "jacobi"):
            for poly in (1, 2):
                keep(f"B B={n} {prec} poly={poly}",
                     *kb.fused_solve_cuda(*blocks, rho=1e-3, exit_tol=1e-6,
                                          max_iters=100, poly_degree=poly,
                                          preconditioner=prec))
    mix = gt.blocks_to_torch(tt.stack_blocks(
        [tt.random_blocks(spec, seed=40), tt.singular_blocks(spec, seed=3, knot=2),
         tt.random_blocks(spec, seed=41)]), dev)
    keep("B singular", *kb.fused_solve_cuda(*mix, rho=0.0, exit_tol=1e-6,
                                             max_iters=100))
    farm = gt.blocks_to_torch(tt.random_farm(spec, 16, 256, seed0=500), dev)
    rhos = torch.tensor([1e-3 * (1 + t % 2) for t in range(16)], device=dev)
    for n in (1, 256):
        blocks = gt.KKTBlocks(*(a[:, :n] for a in farm))
        keep(f"farm B={n}", *ks.fused_sequence_cuda(
            *blocks, torch.zeros_like(blocks.q[0]), rhos, exit_tol=1e-6,
            max_iters=100))
    torch.cuda.synchronize()
    ptxas = [line.strip() for line in log.splitlines()
             if "registers" in line or "spill" in line or "Compiling entry" in line]
    torch.save({"outputs": outputs, "ptxas": ptxas}, out)
    print(f"dumped {len(outputs)} outputs of {gt.__file__} to {out}")


def compare(a: str, b: str) -> int:
    import torch

    da, db = torch.load(a), torch.load(b)
    bad = [k for k in da["outputs"]
           if k not in db["outputs"] or not torch.equal(da["outputs"][k],
                                                        db["outputs"][k])]
    for name, d in ((a, da), (b, db)):
        print(f"ptxas, {name}:")
        for line in d["ptxas"]:
            print("  " + line)
    if bad or set(da["outputs"]) != set(db["outputs"]):
        print(f"NOT bit-identical: {bad}")
        return 1
    print(f"all {len(da['outputs'])} outputs bit-identical")
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "dump":
        dump(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    else:
        sys.exit(__doc__)
