"""The roofline's counts at IIWA (14, 7, 50), against PERF.md's formulas
evaluated by hand."""

import pytest

from benchmark import roofline

K, S, C = 50, 14, 7


def test_condensation_and_recovery_match_the_formulas():
    # K 2s^3 + (K-1) 2c^3 + (K-1)(2s^3 + 2sc^2) + (K-1)(2s^3 + 2s^2 c)
    # + K 2s^2 + (K-1)(2s^2 + 2sc)
    assert roofline.condense_flops(K, S, C) == 1_095_934
    # (2K-1) 2s^2 + (K-1)(2sc + 2c^2)
    assert roofline.recover_flops(K, S, C) == 53_214


def test_exact_and_pcg_terms_match_the_formulas():
    # block Thomas: K 2s^3 + (K-1)(4s^3 + 2s^2) + (2K-1) 2s^2
    assert roofline.thomas_flops(K, S) == 870_240
    # the stair: K 2s^3 + 4 (K-1) 2s^3; a body: two 6 K s^2 matvecs + 10 K s
    assert roofline.stair_flops(K, S) == 1_350_048
    assert roofline.pcg_body_flops(K, S) == 124_600
    assert roofline.pcg_bodies(26, True) == 28
    assert roofline.pcg_bodies(100, False) == 101
    assert roofline.solve_flops("direct", K, S, C) == 1_095_934 + 53_214 + 870_240
    assert roofline.solve_flops("pcg", K, S, C, bodies=28) == (
        1_095_934 + 53_214 + 1_350_048 + 28 * 124_600)
    with pytest.raises(ValueError):
        roofline.solve_flops("lu", K, S, C)


def test_bytes_are_inputs_read_once_and_outputs_written_once():
    inputs = 9800 + 49 * (49 + 196 + 98) + 700 + 343 + 700      # floats
    outputs = 1400 + 343
    assert roofline.solve_bytes(K, S, C) == 4 * (inputs + outputs) + 9 == 120_381


def test_least_time_is_the_larger_bound():
    assert roofline.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    # IIWA at B = 256 with 28 bodies a solve is bound by operations:
    # 256 (2,499,196 + 28 x 124,600) over 67 TFLOP/s.
    flops = 256 * roofline.solve_flops("pcg", K, S, C, bodies=28)
    nbytes = 256 * roofline.solve_bytes(K, S, C)
    assert flops / 67e12 > nbytes / 3.35e12
    assert roofline.least_seconds(flops, nbytes) == pytest.approx(256 * 5_987_996 / 67e12)
