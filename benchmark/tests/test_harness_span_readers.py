"""The readers of the port's own spans (`airmodes.*`, `benchmark/spans.py`)
on a canned trace: nested spans on several threads, spans that cross the
window's edges, ranges that are not the port's nested inside them; each
reader gives nothing on a trace without the spans (a program that lacks
them). Then one traced run of a small cell on the CPU reports them."""

import json
import os

import pytest

from benchmark import spans as spans_mod
from benchmark import spec
from benchmark.tracing import WINDOW, Trace

from conftest import ROOT, small_cell

SPAN_METRICS = ["frame_ms_per_block.replay", "frame_ms_per_block.live",
                "source_wait_share", "result_wait_share",
                "fetch_ms_per_step", "table_ms_per_block"]
T0, T1 = 1000.0, 11000.0          # the window, us


def _x(name, tid, a, b, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": a, "dur": b - a,
            "tid": tid, "args": {}}


def canned(with_spans=True):
    """A 10 ms window. Thread 1 frames (a frame crossing the window's start
    with a wait inside it that crosses too; a frame with a wait), thread 2
    frames (a frame holding a torch op, overlapping thread 1's second frame
    in time; a frame crossing the window's end with a wait), thread 3
    dispatches (a graph range inside), thread 0 is the caller (result
    waits, fetches, decodes; one decode crossing the end). A frame outside
    the window, and the harness's ranges, count for nothing."""
    ev = [_x(WINDOW, 0, T0, T1),
          _x("bench.next", 0, 900.0, 5000.0),
          _x("bench.sink", 0, 5000.0, 6000.0),
          _x("Memcpy HtoD", 7, 2650.0, 2700.0, cat="gpu_memcpy")]
    if with_spans:
        ev += [
            _x("airmodes.frame", 1, 500.0, 2500.0),
            _x("airmodes.source_wait", 1, 600.0, 1500.0),
            _x("airmodes.frame", 1, 3000.0, 5000.0),
            _x("airmodes.source_wait", 1, 3000.0, 4000.0),
            _x("airmodes.frame", 2, 4000.0, 7000.0),
            _x("aten::copy_", 2, 4100.0, 4200.0, cat="cpu_op"),
            _x("airmodes.frame", 2, 10000.0, 12000.0),
            _x("airmodes.source_wait", 2, 10500.0, 11500.0),
            _x("airmodes.frame", 1, 12000.0, 13000.0),
            _x("airmodes.dispatch", 3, 2600.0, 2700.0),
            _x("graph demod_batch_packed_planar_jit", 3, 2610.0, 2690.0),
            _x("airmodes.result_wait", 0, 900.0, 2000.0),
            _x("airmodes.result_wait", 0, 2600.0, 3600.0),
            _x("airmodes.fetch", 0, 3600.0, 3700.0),
            _x("airmodes.decode", 0, 3700.0, 4700.0),
            _x("airmodes.fetch", 0, 8000.0, 8300.0),
            _x("airmodes.decode", 0, 8300.0, 9300.0),
            _x("airmodes.decode", 0, 10800.0, 11400.0),
        ]
    return Trace(ev)


def ctx(trace):
    return spec.ReadContext(trace=trace, sink_spans=[], trace_mono=None,
                            config={}, traffic={}, rows_per_call=8)


def test_spans_clip_and_take_self_time():
    """Clipped lengths; a frame's self time less the waits directly inside
    it on its own thread, not another thread's spans nor ranges that are
    not the port's."""
    found = spans_mod.spans(canned())
    frames = sorted(found["airmodes.frame"], key=lambda s: (s[0], s[1]))
    assert frames == [(1, 1500.0, 1000.0), (1, 2000.0, 1000.0),
                      (2, 1000.0, 500.0), (2, 3000.0, 3000.0)]
    waits = sorted(s[1] for s in found["airmodes.source_wait"])
    assert waits == [500.0, 500.0, 1000.0]
    assert found["airmodes.dispatch"] == [(3, 100.0, 100.0)]
    assert spans_mod.total_ms(found, "airmodes.decode") == \
        (pytest.approx(2.2), 3)


@pytest.mark.parametrize("name,want", [
    ("frame_ms_per_block.replay", (1000 + 1000 + 3000 + 500) / 4 * 1e-3),
    ("frame_ms_per_block.live", (1000 + 1000 + 3000 + 500) / 4 * 1e-3),
    ("source_wait_share", 100.0 * (500 + 1000 + 500) / (1500 + 2000 + 3000
                                                        + 1000)),
    ("result_wait_share", 100.0 * (1000 + 1000) / (T1 - T0)),
    ("fetch_ms_per_step", (100 + 300) / 2 * 1e-3),
    ("table_ms_per_block", (1000 + 1000 + 200) / 3 * 1e-3),
])
def test_span_reader_arithmetic(name, want):
    assert spec.reader(name)(ctx(canned())) == pytest.approx(want)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_readers_give_nothing_without_the_spans(name):
    """A trace of a program without the spans, and a run without a trace,
    give None."""
    read = spec.reader(name)
    assert read(ctx(canned(with_spans=False))) is None
    assert read(ctx(None)) is None


def test_a_wait_share_of_zero_is_a_reading():
    """Frames with no wait for the source read 0%, not nothing."""
    tr = Trace([_x(WINDOW, 0, T0, T1), _x("airmodes.frame", 1, 2000.0,
                                          3000.0)])
    assert spec.reader("source_wait_share")(ctx(tr)) == 0.0
    assert spec.reader("frame_ms_per_block.replay")(ctx(tr)) == \
        pytest.approx(1.0)


def test_entries_name_their_readers_and_cells():
    """Each span metric has its reader file, reads the profiler's trace and
    lists the cells whose runners open its spans."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entries = {m["name"]: m for m in bench["per_layer"]}
    replay = ["int8_2msps.replay_1ch", "fused_10to2.replay_1ch",
              "int8_2msps.replay_16ch"]
    want = {"frame_ms_per_block.replay": replay,
            "frame_ms_per_block.live": ["int8_2msps.live_16ch"],
            "source_wait_share": replay,
            "result_wait_share": ["int8_2msps.replay_1ch",
                                  "int8_2msps.replay_16ch"],
            "fetch_ms_per_step": replay,
            "table_ms_per_block": replay}
    for name in SPAN_METRICS:
        m = entries[name]
        assert m["source"] == "device_trace"
        assert m["workloads"] == want[name]
        assert callable(spec.reader(name))


@pytest.mark.parametrize("name,metrics", [
    ("int8_2msps.replay_1ch", ["frame_ms_per_block.replay",
                               "source_wait_share", "result_wait_share",
                               "fetch_ms_per_step", "table_ms_per_block"]),
    ("int8_2msps.replay_16ch", ["frame_ms_per_block.replay",
                                "source_wait_share", "result_wait_share",
                                "fetch_ms_per_step", "table_ms_per_block"]),
    ("fused_10to2.replay_1ch", ["frame_ms_per_block.replay",
                                "source_wait_share", "fetch_ms_per_step",
                                "table_ms_per_block"]),
    ("int8_2msps.live_16ch", ["frame_ms_per_block.live"]),
])
def test_a_traced_run_on_the_cpu_reports_the_span_metrics(name, metrics,
                                                          request):
    """A traced run of a small cell on the CPU: the port's spans reach the
    trace and each of the cell's span metrics reads a value."""
    from benchmark import run
    if name.startswith("fused"):
        request.getfixturevalue("fused_on_cpu")
    chans = {"channels": 2} if name.endswith("16ch") else {}
    cell = small_cell(name, blocks=24, trace_seconds=1.0, **chans)
    r = run.run(cell, 2147483659, 4.0, True, device="cpu",
                log=lambda line: None)
    assert r["correct"]
    span_metrics = [m for m in r["metrics"] if m in SPAN_METRICS]
    assert sorted(span_metrics) == sorted(metrics)
    for m in metrics:
        assert r["metrics"][m]["value"] >= 0, m
    # the CPU's one "idle gap" is the whole window: the port's spans name it
    assert "airmodes." in r["breakdown"]["idle_gaps"][0][0]
