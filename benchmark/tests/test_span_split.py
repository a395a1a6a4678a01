"""benchmark/tools/span_split.py on canned Chrome events: the program's
spans read from a trace, the split of a call by them, and the breakdown's
idle gaps cut at them."""

import dataclasses

import pytest

from benchmark import harness, trace

split_tool = harness._load_module(harness.BENCH / "tools" / "span_split.py", "span_split")

# Two calls (us on the trace's clock), as test_harness_stats.py has them:
# the host in bench.solve_batched 0-20 and 130-150, a fill and a kernel on
# the device, then the sync.
OPS = [("kernelB", 20, 90), ("fill", 15, 18), ("kernelB", 150, 220), ("fill", 145, 148)]
SPANS = [("bench.call", 0, 100), ("bench.solve_batched", 0, 20), ("bench.sync", 20, 100),
         ("bench.call", 130, 230), ("bench.solve_batched", 130, 150), ("bench.sync", 150, 230)]
# The program's spans inside them: the first call's exported as cpu_op
# (the fast RecordFunction), the second's as user_annotation.
PROGRAM = [
    [("gato.solve_batched", 1, 19), ("gato.route", 2, 4), ("gato.stage", 5, 14),
     ("gato.solve_core", 14, 19), ("gato.launch", 16, 18)],
    [("gato.solve_batched", 131, 149), ("gato.route", 132, 135), ("gato.stage", 135, 141),
     ("gato.solve_core", 141, 149), ("gato.launch", 144, 147)],
]


def chrome(program=()):
    def x(cat, name, a, b):
        return {"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a}
    events = [x("kernel", *op) for op in OPS]
    events += [x("user_annotation", *sp) for sp in SPANS]
    for cat, call in zip(("cpu_op", "user_annotation"), program):
        events += [x(cat, *sp) for sp in call]
    # Neither is a program span: a torch op, and a Python frame of that name.
    events += [x("cpu_op", "aten::empty", 15, 16), x("python_function", "gato.route", 2, 4),
               {"ph": "i", "name": "gato.marker", "ts": 3}]
    return events


def test_program_spans_are_the_gato_annotations_and_ops_in_seconds():
    found = split_tool.program_spans(chrome(PROGRAM))
    assert len(found) == 10
    assert [n for n, *_ in found[:5]] == [n for n, *_ in PROGRAM[0]]
    name, a, b = found[5]
    assert name == "gato.solve_batched"
    assert (a, b) == (pytest.approx(131e-6), pytest.approx(149e-6))
    assert split_tool.program_spans(chrome()) == []


def test_split_reads_each_time_per_call():
    got = split_tool.split(split_tool.program_spans(chrome(PROGRAM)), 2)
    assert got["route_us"] == pytest.approx((2 + 3) / 2)
    assert got["stage_us"] == pytest.approx((9 + 6) / 2)
    assert got["launch_us"] == pytest.approx((2 + 3) / 2)
    # gato.solve_core less its gato.launch: (5 - 2) and (8 - 3).
    assert got["wrapper_us"] == pytest.approx((3 + 5) / 2)
    assert got["launches_per_call"] == 1.0
    assert got["solve_batched_us"] == pytest.approx(18.0)
    assert got["covered_pct"] == pytest.approx(100 * 16.5 / 18)
    assert got["remainder_us"] == pytest.approx(1.5)


def test_split_is_none_without_the_program_spans():
    got = split_tool.split(split_tool.program_spans(chrome()), 2)
    assert got == {k: None for k in ("route_us", "stage_us", "launch_us", "wrapper_us",
                                     "launches_per_call", "solve_batched_us")}
    # A plain solve launches nothing: no launch time or count, the rest read.
    plain = [sp for sp in split_tool.program_spans(chrome(PROGRAM))
             if sp[0] != "gato.launch"]
    got = split_tool.split(plain, 2)
    assert got["launch_us"] is None and got["launches_per_call"] is None
    assert got["wrapper_us"] == pytest.approx((5 + 8) / 2)
    assert got["covered_pct"] == pytest.approx(100 * 16.5 / 18)


def test_breakdown_without_program_spans_is_the_harness_breakdown():
    # A trace without gato. spans reads as before: cut at the benchmark's
    # spans alone (test_harness_stats.py pins its numbers).
    tl = trace.from_chrome(chrome())
    assert tl.program_spans == []
    with_program = trace.from_chrome(chrome(PROGRAM))
    assert harness._breakdown(tl) == harness._breakdown(with_program._replace(program_spans=[]))


def test_breakdown_names_idle_pieces_by_the_innermost_span():
    events = chrome(PROGRAM)
    tl = trace.from_chrome(events)
    # The benchmark's spans stay as they were; the program's are kept apart,
    # and the breakdown cuts at both.
    assert tl.spans == trace.from_chrome(chrome()).spans
    assert tl.program_spans == split_tool.program_spans(events)
    bd = harness._breakdown(tl)
    gaps = dict(bd["idle_gaps"])
    # The 34 us of idle time in bench.solve_batched, cut at the program's
    # spans: 0-1, 19-20, 130-131, 149-150 outside them; 1-2, 4-5, 131-132
    # in gato.solve_batched alone; 14-15, 18-19, 141-144, 148-149 in
    # gato.solve_core outside gato.launch; 144-145 in gato.launch.
    assert gaps["bench.solve_batched"] == pytest.approx(4e-6)
    assert gaps["gato.solve_batched"] == pytest.approx(3e-6)
    assert gaps["gato.route"] == pytest.approx(5e-6)
    assert gaps["gato.stage"] == pytest.approx(15e-6)
    assert gaps["gato.solve_core"] == pytest.approx(6e-6)
    assert gaps["gato.launch"] == pytest.approx(1e-6)
    assert gaps["bench.sync"] == pytest.approx(20e-6)
    assert gaps[trace.LOOP] == pytest.approx(30e-6)
    assert bd["idle_gaps"][0][0] == "bench.loop"
    assert bd["device_ops"] == harness._breakdown(trace.from_chrome(chrome()))["device_ops"]


def run_of(events):
    tl = trace.from_chrome(events)
    return harness.Run(None, (50, 14, 7), 1, "pcg", 1.0, 1.0, [1e-4] * 2, [2e-5] * 2,
                       timeline=tl)


DISPATCH = ("route_us", "stage_us", "wrapper_us", "launch_us", "launches_per_call")


def test_the_dispatch_readers_read_the_split_of_the_timeline():
    run = run_of(chrome(PROGRAM))
    want = split_tool.split(split_tool.program_spans(chrome(PROGRAM)), 2)
    for name in DISPATCH:
        assert harness.load_reader(name).read(run) == pytest.approx(want[name]), name
    assert harness.load_reader("route_us").read(run) == pytest.approx(2.5)
    assert harness.load_reader("launches_per_call").read(run) == 1.0
    # Nothing to read without the program's spans or without a trace.
    for name in DISPATCH:
        assert harness.load_reader(name).read(run_of(chrome())) is None, name
        assert harness.load_reader(name).read(dataclasses.replace(run, timeline=None)) is None


def test_ingest_is_the_host_outside_the_solve_and_the_device():
    # linsys_solve's calls: gato.solve inside bench.solve_batched, packing
    # before it and the lists after it, the fills standing for the copies.
    solve = [[("gato.solve", 5, 14), ("gato.route", 5, 6)],
             [("gato.solve", 135, 141), ("gato.stage", 136, 140)]]
    run = run_of(chrome(solve))
    # 0-5, 14-15, 18-20 and 130-135, 141-145, 148-150: 19 us over 2 calls.
    assert harness.load_reader("ingest_us").read(run) == pytest.approx(9.5)
    # The solve_batched cells have no gato.solve span: nothing to read.
    assert harness.load_reader("ingest_us").read(run_of(chrome(PROGRAM))) is None
    assert harness.load_reader("ingest_us").read(run_of(chrome())) is None


def test_site_cost_is_dearer_inside_a_profiler_session():
    off = split_tool.site_cost(2000, False)
    assert 0.0 < off < split_tool.site_cost(200, True)


def test_a_cpu_run_reads_the_split_of_a_plain_solve(capsys):
    """On the CPU the 'torch' backend runs: route, stage and the wrapper
    read, nothing launches."""
    import json
    assert split_tool.main([
        "--workload", "iiwa14_k50.b1.direct", "--seed", "3000000011", "--device", "cpu",
        "--seconds", "0.05", "--sites", "100", "--traffic", "pool_mb=0",
        "--traffic", "warmup_s=0.05", "--traffic", "profile_calls=3"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = line["split"]
    assert got["launches_per_call"] is None and got["launch_us"] is None
    assert all(got[k] > 0 for k in ("route_us", "stage_us", "wrapper_us"))
    assert got["covered_pct"] > 90.0
    assert "breakdown" not in line and line["card"] == "cpu"
