"""Kernel B, the farm kernel and the long-K PCG tier, bit for bit, between
two checkouts.

    python3 gato_tpu_torch/tools/bitcheck.py dump ROOT OUT.pt
    python3 gato_tpu_torch/tools/bitcheck.py compare A.pt B.pt [GROUP,...]

``dump`` imports gato_tpu_torch from the checkout at ROOT (building its
kernels there), runs kernel B (fused_solve_cuda) at IIWA (14, 7, 50), B = 1
and 256, for every preconditioner and poly degree 1 and 2, on one exactly
singular mix, kernel B's <36, 12> body (group "B36", function ``dump_wide``)
at (36, 12, 57), B = 1 and 4, every preconditioner, C = 16, 8 and 4, and on
a singular mix at C = 16 and 4, the farm kernel (fused_sequence_cuda) on T = 16 farms of
B = 1 and 256 streams, and the long-K kernels at IIWA widths: row 7
(condense_longk_cuda) at K = 1024, B = 1 and 16, every preconditioner, and
K = 8192; rows 8/10 (pcg_longk_cuda) on the plain condensation's operators
at K = 1024, B = 1, 3 (one frozen) and 16, K = 2048, B = 4 at poly degree
2, and K = 8192, B = 1; row 9 (fused_longk_cuda) at K = 1024, B = 1 and
16.  Rows 8/10 run at the CTAs a problem that the one-round split of the
older design gave (parent_ctas), forced through the
wrapper's private ``_rounds=`` plan where the checkout has one: at that
split the two-barrier kernel keeps the older kernel's sums.  It saves every output
(a sha256 digest for those of over a million elements) with ptxas's
register and spill report of the build.  ``dump`` also runs the exact
kernels that share a source or a header with rows 5 and 11 (function
``dump_exact``): kernel A, row 4, row 5, row 6 on the plain forward's
stacks, row 11, rows 12 and the unpeel, and row 13; and row 17, the
FMA-chain probe (``dump_probes``), whose layouts keep one fmaf order a
row, so a change of its schedule must keep its bits.  ``compare`` prints,
group by group, which outputs are bit-identical, and both builds' ptxas
reports; it exits 1 unless every output of the two dumps is, but for the
groups named in its third argument (kernels whose arithmetic a change
redesigned: they are printed all the same).  It needs one CUDA card; the
inputs come from testing's seeded generators.

A refactor of csrc/cluster_body.cuh (the body both kernels compile) must
pass it against the parent's checkout for the groups "B", "B36" and
"farm": it may move registers, not bits.  So must gauss_jordan.cuh's
one-warp path for widths above 32, which replaced the two-phase batch in
the <36, 12> body entry for entry.  Row 7's tiles were rebuilt on kernel B's
Gauss-Jordan and products (longk.cu), which multiply in another order
than condense.cuh's, so the groups "row7" and "row9" differ from a
checkout with the older tiles by design, within the plain version's
tolerance; "row8/10" must not.
A change of the arithmetic by design does not pass, and says so: the
cluster layout of kernel B and the farm kernel (cluster_body.cuh, which
replaced the one-CTA fused_body.cuh) sums each dot product over C CTAs in
rank order and reads its Gauss-Jordan pivot rows differently, so its bits
differ from the one-CTA kernel's, within the plain version's tolerance.
csrc/condense.cuh and csrc/pcg_common.cuh, shared by kernel A, rows 4, 5,
7, 8/10 and 13 and the probes, are no longer compiled into kernel B or the
farm; a change to them is checked by those kernels' card tests and by this
tool extended to them.  Row 6 as a walk and a knot-parallel epilogue (its
residual summed by knot, then by tile) and row 12 on warp_gj_pad (the pivot
row scaled by a reciprocal where warp_gj divided) differ from a checkout
with the older bodies by design, within their plain versions' tolerance:
name "row6,row12,unpeel" against such a checkout.  The Thomas pair and the
'hybrid' route, which run them, are held by the card tests.
"""

from __future__ import annotations

import hashlib
import inspect
import sys
from pathlib import Path

# Outputs of more elements than this are kept as a digest.
DIGEST_NUMEL = 1 << 20


def parent_ctas(B: int, K: int, s: int, n_sms: int) -> int:
    """CTAs a problem of the first round under the one-round split (as many
    problems as the grid holds, CTAs shared out, no more than a problem's
    rows / 256), with two resident CTAs an SM: the long-K PCG kernel's
    split before the two-barrier design."""
    grid = 2 * n_sms
    nprob = min(B, grid)
    return max(min(grid // nprob, -(-K * s // 256)), 1)


def _kept(t):
    t = t.detach().cpu()
    if t.numel() <= DIGEST_NUMEL:
        return t
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


def _same(a, b) -> bool:
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    import torch
    return torch.equal(a, b)


def dump(root: str, out: str) -> None:
    root = str(Path(root).resolve())
    sys.path.insert(0, root)
    import torch

    import gato_tpu_torch as gt
    from gato_tpu_torch import testing as tt
    from gato_tpu_torch.kernels import _build
    from gato_tpu_torch.kernels import fused_sequence as ks
    from gato_tpu_torch.kernels import fused_solve as kb

    if not gt.__file__.startswith(root):
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
    dump_wide(dev, outputs)
    farm = gt.blocks_to_torch(tt.random_farm(spec, 16, 256, seed0=500), dev)
    rhos = torch.tensor([1e-3 * (1 + t % 2) for t in range(16)], device=dev)
    for n in (1, 256):
        blocks = gt.KKTBlocks(*(a[:, :n] for a in farm))
        keep(f"farm B={n}", *ks.fused_sequence_cuda(
            *blocks, torch.zeros_like(blocks.q[0]), rhos, exit_tol=1e-6,
            max_iters=100))
    dump_longk(dev, outputs)
    dump_exact(dev, outputs)
    dump_probes(dev, outputs)
    torch.cuda.synchronize()
    ptxas = [line.strip() for line in log.splitlines()
             if "registers" in line or "spill" in line or "Compiling entry" in line]
    torch.save({"outputs": outputs, "ptxas": ptxas}, out)
    print(f"dumped {len(outputs)} outputs of {gt.__file__} to {out}")


def dump_wide(dev, outputs: dict) -> None:
    """Kernel B's <36, 12> body (group "B36"): fused_solve_cuda at (36, 12,
    57), B = 1 and 4, every preconditioner, at C = 16 (the records in shared
    memory), 8 and 4 (in the global scratch slice); and a mix whose middle
    problem has an exactly singular Q at knot 13 (a CTA's last knot and its
    neighbour's halo at both sizes), rho = 0, at C = 16 and 4."""
    import gato_tpu_torch as gt
    from gato_tpu_torch import testing as tt
    from gato_tpu_torch.kernels import fused_solve as kb

    spec = gt.ProblemSpec(36, 12, 57)
    res_fields = ("lam", "iters", "converged", "eta", "dz_x", "dz_u")
    full = gt.blocks_to_torch(tt.random_batch(spec, 4, seed0=3600), dev)
    for n in (1, 4):
        blocks = gt.KKTBlocks(*(a[:n] for a in full))
        for prec in ("symmetric_stair", "block_jacobi", "jacobi"):
            for C in (16, 8, 4):
                res, dx, du = kb.fused_solve_cuda(*blocks, rho=1e-3, exit_tol=1e-6,
                                                  max_iters=100, preconditioner=prec,
                                                  cluster=C)
                for name, t in zip(res_fields, (*res, dx, du)):
                    outputs[f"B36 B={n} {prec} C={C} {name}"] = _kept(t)
    mix = gt.blocks_to_torch(tt.stack_blocks(
        [tt.random_blocks(spec, seed=3610), tt.singular_blocks(spec, seed=3611, knot=13),
         tt.random_blocks(spec, seed=3612)]), dev)
    for C in (16, 4):
        res, dx, du = kb.fused_solve_cuda(*mix, rho=0.0, exit_tol=1e-6, max_iters=100,
                                          cluster=C)
        for name, t in zip(res_fields, (*res, dx, du)):
            outputs[f"B36 singular C={C} {name}"] = _kept(t)


def dump_exact(dev, outputs: dict) -> None:
    """Kernel A and the exact kernels (groups "rowA", "row4", "row5",
    "row6", "row11", "row12", "unpeel", "row13"): kernel A
    (pcg_batched_cuda) on the plain condensation at IIWA B = 1 and 256,
    row 4 (direct_fused_cuda) at IIWA B = 1 and 15 and a singular mix, row
    5 (thomas_fwd_cuda) and row 6 (thomas_rev_cuda, on the plain forward's
    stacks) at B = 16 and 256, rows 11, 12 and the unpeel (cr_longk_cuda,
    peel_longk_cuda, unpeel_longk_cuda) and row 13 (recover_longk_cuda) on
    the plain condensation at K = 1024, B = 1 and 15, and row 13 on seeded
    random inputs at K = 1033, B = 3 for s = 2, 16 and 30."""
    import torch

    import gato_tpu_torch as gt
    from gato_tpu_torch import assemble
    from gato_tpu_torch import testing as tt
    from gato_tpu_torch.kernels import direct_fused as kd
    from gato_tpu_torch.kernels import longk as kl
    from gato_tpu_torch.kernels import pcg_kernel as ka
    from gato_tpu_torch.kernels import thomas_batch as kt

    def keep(tag, fields, values):
        for name, t in zip(fields, values):
            outputs[f"{tag} {name}"] = _kept(t)

    res_fields = ("lam", "iters", "converged", "eta", "dz_x", "dz_u")
    full = gt.blocks_to_torch(tt.random_batch(tt.IIWA, 256, seed0=900), dev)
    for n in (1, 256):
        sys_ = assemble.condense(*(a[:n] for a in full), 1e-3)
        keep(f"rowA B={n}", ("lam", "iters", "converged", "eta"),
             ka.pcg_batched_cuda(sys_.S, sys_.Pinv, sys_.gamma, exit_tol=1e-6,
                                 max_iters=100))
    for n in (1, 15):
        blocks = gt.KKTBlocks(*(a[:n] for a in full))
        res, dx, du = kd.direct_fused_cuda(*blocks, rho=1e-3)
        keep(f"row4 B={n}", res_fields, (*res, dx, du))
    mix = gt.blocks_to_torch(tt.stack_blocks(
        [tt.random_blocks(tt.IIWA, seed=40), tt.singular_blocks(tt.IIWA, seed=3, knot=2),
         tt.random_blocks(tt.IIWA, seed=41)]), dev)
    res, dx, du = kd.direct_fused_cuda(*mix, rho=0.0)
    keep("row4 singular", res_fields, (*res, dx, du))
    for n in (16, 256):
        blocks = gt.KKTBlocks(*(a[:n] for a in full))
        keep(f"row5 B={n}", kt.ThomasFactors._fields, kt.thomas_fwd_cuda(*blocks, rho=1e-3))
        f = kt.thomas_fwd_plain(*blocks, rho=1e-3)
        res, dx, du = kt.thomas_rev_cuda(f, blocks.q, blocks.A, blocks.B, blocks.r)
        keep(f"row6 B={n}", res_fields, (*res, dx, du))
    longk = gt.blocks_to_torch(tt.random_batch(gt.ProblemSpec(14, 7, 1024), 15,
                                               seed0=910), dev)
    for n in (1, 15):
        blocks = gt.KKTBlocks(*(a[:n] for a in longk))
        ops = kl.condense_longk_plain(*blocks, rho=1e-3, preconditioner="jacobi")
        keep(f"row11 K=1024 B={n}", ("x", "bad"), kl.cr_longk_cuda(ops.S, ops.gamma))
        Sh, bh, level = kl.peel_longk_cuda(ops.S, ops.gamma)
        keep(f"row12 K=1024 B={n}", ("S'", "b'", "Doinv", "bad"),
             (Sh, bh, level.Doinv, level.bad))
        plain_level = kl.peel_longk_plain(ops.S, ops.gamma)[2]
        xh = kl.cr_longk_plain(*kl.peel_longk_plain(ops.S, ops.gamma)[:2])[0]
        keep(f"unpeel K=1024 B={n}", ("x",), (kl.unpeel_longk_cuda(xh, plain_level),))
        keep(f"row13 K=1024 B={n}", ("dz_x", "dz_u"),
             kl.recover_longk_cuda(ops.Qinv, ops.Rinv, blocks.A, blocks.B, blocks.q,
                                   blocks.r, ops.gamma))
    # Row 13 past IIWA's width (its kernels for 16 and 32) and at the
    # pendulum's, on seeded random inputs.
    gen = torch.Generator().manual_seed(913)
    for s, c in ((2, 1), (16, 8), (30, 10)):
        shapes = ((3, 1033, s, s), (3, 1032, c, c), (3, 1032, s, s), (3, 1032, s, c),
                  (3, 1033, s), (3, 1032, c), (3, 1033, s))
        args = [torch.randn(*sh, generator=gen).to(dev) for sh in shapes]
        keep(f"row13 K=1033 B=3 s={s}", ("dz_x", "dz_u"), kl.recover_longk_cuda(*args))


def dump_probes(dev, outputs: dict) -> None:
    """Row 17's outputs (group "row17"): fma_chain_cuda on probes.
    fma_operator's inputs at K = 5, 50 and 73 (both of its layouts), B = 1
    and 132, 100 trips of depth 2."""
    from gato_tpu_torch.kernels import probes as kp

    for K in (5, 50, 73):
        for n in (1, 132):
            M, y0 = kp.fma_operator(n, K, seed=1700 + K + n, device=dev)
            outputs[f"row17 K={K} B={n} y"] = _kept(kp.fma_chain_cuda(M, y0, depth=2,
                                                                      trips=100))


def dump_longk(dev, outputs: dict) -> None:
    """Rows 7, 8/10 and 9's outputs (groups "row7", "row8/10", "row9")."""
    import torch

    import gato_tpu_torch as gt
    from gato_tpu_torch import testing as tt
    from gato_tpu_torch.kernels import longk as kl

    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    takes_rounds = "_rounds" in inspect.signature(kl.pcg_longk_cuda).parameters

    def batch(K, n, seed0):
        return gt.blocks_to_torch(tt.random_batch(gt.ProblemSpec(14, 7, K), n,
                                                  seed0=seed0), dev)

    def keep(tag, fields, values):
        for name, t in zip(fields, values):
            outputs[f"{tag} {name}"] = _kept(t)

    ops_fields = ("S", "Pinv", "gamma", "Qinv", "Rinv", "bad")
    res_fields = ("lam", "iters", "converged", "eta")
    full = batch(1024, 16, 7000)
    for n in (1, 16):
        blocks = gt.KKTBlocks(*(a[:n] for a in full))
        for prec in ("symmetric_stair", "block_jacobi", "jacobi"):
            keep(f"row7 K=1024 B={n} {prec}", ops_fields,
                 kl.condense_longk_cuda(*blocks, rho=1e-3, preconditioner=prec))
        fres, fqi, fri = kl.fused_longk_cuda(*blocks, rho=1e-3, exit_tol=1e-6,
                                             max_iters=100)
        keep(f"row9 K=1024 B={n}", res_fields + ("Qinv", "Rinv"), (*fres, fqi, fri))
    keep("row7 K=8192 B=1", ops_fields,
         kl.condense_longk_cuda(*batch(8192, 1, 7100), rho=1e-3))
    good = [tt.random_blocks(gt.ProblemSpec(14, 7, 1024), seed=7200 + i) for i in range(2)]
    sing = tt.singular_blocks(gt.ProblemSpec(14, 7, 1024), seed=3, knot=2)
    mix = gt.blocks_to_torch(tt.stack_blocks([good[0], sing, good[1]]), dev)
    for tag, blocks, prec, poly, rho in (
            ("K=1024 B=1", gt.KKTBlocks(*(a[:1] for a in full)), "symmetric_stair", 1, 1e-3),
            ("K=1024 B=16", full, "symmetric_stair", 1, 1e-3),
            ("K=1024 B=3 frozen", mix, "symmetric_stair", 1, 0.0),
            ("K=2048 B=4 poly=2", batch(2048, 4, 7300), "block_jacobi", 2, 1e-3),
            ("K=8192 B=1", batch(8192, 1, 7100), "symmetric_stair", 1, 1e-3)):
        ops = kl.condense_longk_plain(*blocks, rho=rho, preconditioner=prec)
        Bn, K, s = ops.gamma.shape
        kw = dict(exit_tol=1e-6, max_iters=100, poly_degree=poly)
        if takes_rounds:
            kw["_rounds"] = kl.pcg_rounds(Bn, K, s, *kl._limits(dev),
                                          parent_ctas(Bn, K, s, n_sms))
        keep(f"row8/10 {tag}", res_fields,
             kl.pcg_longk_cuda(ops.S, ops.Pinv, ops.gamma, None, ops.bad, **kw))


def _group(key: str) -> str:
    return key.split(" ")[0]


def compare(a: str, b: str, changed: tuple = ()) -> int:
    import torch

    da, db = torch.load(a), torch.load(b)
    for name, d in ((a, da), (b, db)):
        print(f"ptxas, {name}:")
        for line in d["ptxas"]:
            print("  " + line)
    keys = sorted(set(da["outputs"]) | set(db["outputs"]))
    bad = [k for k in keys if k not in da["outputs"] or k not in db["outputs"]
           or not _same(da["outputs"][k], db["outputs"][k])]
    for group in sorted({_group(k) for k in keys}):
        mine = [k for k in keys if _group(k) == group]
        off = [k for k in mine if k in bad]
        print(f"{group}: {len(mine) - len(off)} of {len(mine)} outputs bit-identical"
              + (f"; differ: {off}" if off else ""))
    held = [k for k in bad if _group(k) not in changed]
    if changed:
        print(f"groups redesigned by the change, not held: {sorted(changed)}")
    if held:
        print(f"NOT bit-identical: {len(held)} of {len(keys)} outputs")
        return 1
    print(f"all {len(keys) - len(bad)} held outputs bit-identical "
          f"({len(bad)} in the redesigned groups differ)")
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "dump":
        dump(sys.argv[2], sys.argv[3])
    elif len(sys.argv) in (4, 5) and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3],
                         tuple(sys.argv[4].split(",")) if len(sys.argv) == 5 else ()))
    else:
        sys.exit(__doc__)
