"""The inputs are a function of the seed alone."""

import torch

from benchmark import generator


def test_the_same_seed_gives_the_same_inputs():
    a = generator.make_problems(3, 6, 14, 7, 2**31 + 77, "cpu")
    b = generator.make_problems(3, 6, 14, 7, 2**31 + 77, "cpu")
    c = generator.make_problems(3, 6, 14, 7, 2**31 + 78, "cpu")
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y)
        assert not torch.equal(x, z)
        assert x.dtype == torch.float32


def test_shapes_and_a_well_conditioned_problem():
    Q, R, A, B, q, r, c = generator.make_problems(2, 6, 14, 7, 5, "cpu")
    assert Q.shape == (2, 6, 14, 14) and R.shape == (2, 5, 7, 7)
    assert A.shape == (2, 5, 14, 14) and B.shape == (2, 5, 14, 7)
    assert q.shape == (2, 6, 14) and r.shape == (2, 5, 7) and c.shape == (2, 6, 14)
    for M in (Q, R):
        assert torch.equal(M, M.mT)
        assert torch.linalg.eigvalsh(M.double()).min() > 0.9
    eye = torch.eye(14)
    assert (A + eye).abs().max() < 0.15


def test_a_pool_is_views_of_one_draw():
    pool = generator.make_pool(3, 2, 6, 14, 7, 9, "cpu")
    whole = generator.make_problems(6, 6, 14, 7, 9, "cpu")
    assert len(pool) == 3
    for i, batch in enumerate(pool):
        for f, w in zip(batch, whole):
            assert f.is_contiguous() and f.shape[0] == 2
            assert torch.equal(f, w[2 * i:2 * i + 2])


def test_a_pool_holds_its_megabytes_and_at_least_two_batches():
    one = generator.problem_bytes(50, 14, 7)
    assert one == 4 * (50 * 196 + 49 * (49 + 196 + 98) + 2 * 50 * 14 + 49 * 7)
    P = generator.pool_size(128, 1, 50, 14, 7)
    assert P * one >= 128e6 > (P - 1) * one
    assert generator.pool_size(0, 1, 50, 14, 7) == 2
    assert generator.pool_size(128, 8, 512, 14, 7) * 8 * generator.problem_bytes(512, 14, 7) >= 128e6
