"""p95 over all calls, rate over the window, and the idle share and gaps of
a synthetic device timeline."""

import dataclasses
import statistics

import pytest
import torch

from benchmark import harness, stats, trace


def test_p95_is_the_nearest_rank_over_all_calls():
    values = list(range(1, 101))           # 1 .. 100
    assert stats.percentile(values, 95) == 95
    assert stats.percentile(values[::-1], 95) == 95
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile(list(range(1, 21)), 95) == 19
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate_is_all_the_work_over_all_the_window():
    assert stats.rate(256 * 1000, 2.0) == 128000.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_spread_is_the_quartile_distance_over_the_median():
    values = [10.0, 10.2, 9.8, 10.1, 9.9, 10.0]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert stats.spread(values) == pytest.approx((q3 - q1) / 10.0)


def chrome(ops, spans):
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": a, "dur": b - a}
              for n, a, b in ops]
    events += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
               for n, a, b in spans]
    events += [{"ph": "X", "cat": "gpu_user_annotation", "name": "bench.call",
                "ts": 0, "dur": 1000}, {"ph": "i", "name": "marker", "ts": 3}]
    return events


# Two calls of 100 us each (us on the trace's clock): the host works in
# solve_batched for 20 us, the kernel runs 70 us, then 10 us of sync; 30 us
# of the loop's own work between the calls.
OPS = [("kernelB", 20, 90), ("fill", 15, 18), ("kernelB", 150, 220), ("fill", 145, 148)]
SPANS = [("bench.call", 0, 100), ("bench.solve_batched", 0, 20), ("bench.sync", 20, 100),
         ("bench.call", 130, 230), ("bench.solve_batched", 130, 150), ("bench.sync", 150, 230)]


def test_timeline_reads_ops_spans_and_window():
    tl = trace.from_chrome(chrome(OPS, SPANS))
    assert tl.calls == 2
    assert tl.start == pytest.approx(0.0) and tl.end == pytest.approx(230e-6)
    assert len(tl.ops) == 4 and len(tl.spans) == 6
    assert trace.from_chrome(chrome([], SPANS)) is None
    assert trace.from_chrome(chrome(OPS, [])) is None


def test_busy_and_idle_share_from_the_union_of_device_intervals():
    assert stats.busy_seconds([(0, 2), (1, 3), (5, 6)], 0, 10) == 4
    assert stats.busy_seconds([(0, 2), (1, 3), (5, 6)], 2.5, 5.5) == pytest.approx(1.0)
    assert stats.idle_gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]
    tl = trace.from_chrome(chrome(OPS, SPANS))
    run = harness.Run(None, (50, 14, 7), 256, "pcg", 1.0, 1.0, [1e-4] * 2, [2e-5] * 2,
                      timeline=tl)
    busy_us = 3 + 70 + 3 + 70
    assert harness.load_reader("device_idle_pct").read(run) == pytest.approx(
        100 * (1 - busy_us / 230))
    assert harness.load_reader("device_ms_per_call").read(run) == pytest.approx(
        busy_us * 1e-3 / 2)


def test_idle_gaps_are_named_by_the_host_span_they_fall_in():
    tl = trace.from_chrome(chrome(OPS, SPANS))
    assert trace.host_span_at(tl.spans, 10e-6) == "bench.solve_batched"
    assert trace.host_span_at(tl.spans, 95e-6) == "bench.sync"
    assert trace.host_span_at(tl.spans, 115e-6) == trace.LOOP
    bd = harness._breakdown(tl)
    assert bd["device_ops"][0][0] == "kernelB"
    assert bd["device_ops"][0][1] == pytest.approx(140e-6)
    gaps = dict(bd["idle_gaps"])
    # 0-15 and 18-20 in solve_batched; 90-100 in sync; 100-130 the loop;
    # 130-145 and 148-150 in solve_batched; 220-230 in sync.
    assert gaps["bench.solve_batched"] == pytest.approx(34e-6)
    assert gaps["bench.sync"] == pytest.approx(20e-6)
    assert gaps[trace.LOOP] == pytest.approx(30e-6)


def test_e2e_readers_take_all_calls_and_all_the_window():
    calls = [1e-3] * 95 + [2e-3] * 5
    run = harness.Run(None, (50, 14, 7), 256, "pcg", 7.5, 0.105, calls, [5e-5] * 100)
    assert harness.load_reader("solves_per_s").read(run) == pytest.approx(25600 / 0.105)
    assert harness.load_reader("call_ms_p95").read(run) == pytest.approx(1.0)
    assert harness.load_reader("setup_s").read(run) == 7.5
    assert harness.load_reader("host_call_us").read(run) == pytest.approx(50.0)


def test_roofline_and_iteration_readers():
    from benchmark import roofline
    tl = trace.from_chrome(chrome(OPS, SPANS))
    run = harness.Run(None, (50, 14, 7), 256, "pcg", 1.0, 1.0, [1e-3] * 2, [2e-4] * 2,
                      iters=[torch.full((256,), 26, dtype=torch.int32),
                             torch.full((256,), 27, dtype=torch.int32)],
                      timeline=tl, profiled_pool=[0, 1], plain_bodies=[7000, 7300])
    flops = 2 * 256 * roofline.solve_flops("pcg", 50, 14, 7) + 14300 * roofline.pcg_body_flops(50, 14)
    least = roofline.least_seconds(flops, 2 * 256 * roofline.solve_bytes(50, 14, 7))
    assert harness.load_reader("solve_roofline").read(run) == pytest.approx(
        100 * least / 146e-6)
    assert harness.load_reader("pcg_iters_mean").read(run) == pytest.approx(26.5)
    direct = dataclasses.replace(run, method="direct", plain_bodies=None)
    assert harness.load_reader("pcg_iters_mean").read(direct) is None
    flops = 2 * 256 * roofline.solve_flops("direct", 50, 14, 7)
    assert harness.load_reader("solve_roofline").read(direct) == pytest.approx(
        100 * roofline.least_seconds(flops, 2 * 256 * roofline.solve_bytes(50, 14, 7)) / 146e-6)
    assert harness.load_reader("solve_roofline").read(
        dataclasses.replace(run, timeline=None)) is None
