"""The 20 Msps configuration demodulated at 10 samples a chip (the
benchmark's `int8_20msps_sps10`): the native int8 runner outside the planar
gate on USRP sc16 samples, against the benchmark's plain reference
(`benchmark/reference.py`, `benchmark/modes.py`, which share no code with
the port); its step as a graphed entry inside its span; the readers of
its per-layer metrics on a canned trace; and the configuration as the
benchmark loads it. Skips the runner's case where there is no C++
toolchain, as tests/test_native.py does."""

import copy
import os

import numpy as np
import pytest
import torch

from airmodes_torch.config import DspConfig
from airmodes_torch.dsp import pipeline as P
from airmodes_torch.io import native_stream
from airmodes_torch.kernels import preamble as K
from benchmark import judge, spec, traffic
from benchmark.reference import Reference
from benchmark.tracing import WINDOW, Trace

from torch_fake_graph import install_fake_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "int8_20msps_sps10.replay_1ch"
BLOCK = 1 << 15
BLOCKS = 6


def _small_cell(block=BLOCK, blocks=BLOCKS):
    """The cell at blocks of `block` samples and a capture of `blocks`
    blocks."""
    cell = spec.load_cell(CELL, ROOT)
    cell.config = copy.deepcopy(cell.config)
    cell.config["modes_rx"] = cell.config["modes_rx"] + [
        "--block-size", str(block)]
    cell.config["dsp"]["block_size"] = block
    cell.traffic = dict(cell.traffic, capture_samples=block * blocks)
    return cell


@pytest.fixture(scope="module")
def native_ok():
    from airmodes_torch import native
    try:
        native.load()
    except native.NativeUnavailable:
        pytest.skip("no C++ toolchain")


# --- (e) the configuration as the benchmark loads it -------------------------

def test_config_loads_and_matches_modes_rx():
    """The cell loads by name; the configuration's `dsp` is what modes_rx
    builds from its arguments (sps 10, outside the planar gate), nothing
    is cut, and the cell reports its end-to-end and per-layer metrics."""
    from benchmark import sut
    cell = spec.load_cell(CELL, ROOT)
    cfg = cell.config
    args = sut.modes_rx_args(cfg, ["-"], "cpu", ":memory:")
    dsp = sut.dsp_config(args)
    sut.check_config(cfg, dsp)
    assert dsp.sps == 10 and K.supported_planar_tile(dsp) is None
    assert args.int8 and args.file_format == "sc16" and args.rate == 20e6
    assert cfg["source_rate"] == dsp.channel_rate and cfg["reduced"] == []
    assert sut.stream_geometry(cfg, dsp) == (dsp.block_size, dsp.right_halo)
    assert cell.chips == 1 and cell.traffic["channels"] == 1
    assert [m["name"] for m in cell.end_to_end] == ["input_msps", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "device_idle_share", "fullblock_roofline", "fullblock_graph_nodes"]
    assert set(cfg["limits"]) == set(judge.NUMBERS)


# --- (b) the runner against the plain reference ------------------------------

def test_runner_on_sc16_matches_plain_reference(tmp_path, native_ok):
    """run_native_pipelined on a seeded 20 Msps sc16 capture of the cell's
    traffic (blocks of 2^15, batch 2) emits, block for block, the plain
    reference's messages, ties aside, and the level within the last digit
    the wire prints."""
    cell = _small_cell()
    cfg = DspConfig(**cell.config["dsp"])
    cap = traffic.build(cell.config, cell.traffic, 2876543211)[0]
    path = str(tmp_path / "cap.sc16")
    cap.data.tofile(path)
    got = list(native_stream.run_native_pipelined(
        cfg, path=path, fmt="sc16", batch=2, device="cpu"))
    assert len(got) == BLOCKS
    ref = Reference(cell.config, [cap.data], "cpu")
    assert ref.period == BLOCKS
    # block 0 has no left halo of real samples, the last no right halo in
    # a file that is not looped: the others are the looped stream's
    judged = {(0, b): (got[b], None) for b in range(1, BLOCKS - 1)}
    nums = judge.judge(judged, ref)
    assert nums["counts"]["reference_msgs"] >= 4
    assert nums["diff_share"] == 0.0
    assert nums["dbfs_gap_db"] <= 0.01


# --- (c) the step: graphed entry, span -------------------------------------

def test_step_outside_gate_replays_the_graphed_entry(monkeypatch):
    """Outside the planar gate `_planar_step` replays `_full_block_rows`'s
    graph on the planar (B, P) rows (the graph's own inputs, sliced and
    stacked inside it), one replay and one span `airmodes.full_block` a
    step with the replay's range inside it, and no hand kernel launched;
    its tables are the eager full-block path's on the stacked rows."""
    from airmodes_torch.utils import profiling
    fake = install_fake_graph(monkeypatch.setattr)
    graphed = native_stream._full_block_rows
    graphed.cache_clear()
    cfg = DspConfig(channel_rate=20e6, block_size=BLOCK, max_detections=16)
    step, width = native_stream._planar_step(cfg, "cpu")
    T = cfg.left_halo + cfg.block_size + cfg.right_halo
    assert width == -(-T // 128) * 128
    rng = np.random.default_rng(5)
    rows = [torch.from_numpy(rng.integers(-127, 128, (3, width),
                                          dtype=np.int8)) for _ in range(4)]
    K.reset_launches()
    captures, replays = graphed.captures, graphed.replays
    try:
        with profiling.profiler() as prof:
            outs = [step(rows[0], rows[1]), step(rows[2], rows[3])]
        assert graphed.captures == captures + 1
        assert graphed.replays == replays + 2
        assert len(fake.made) == 1 and fake.made[0].replays == 2
        (entry,) = graphed._cache.values()
        assert {n: tuple(t.shape) for n, t in entry.inputs.items()} == {
            "xi": (3, width), "xq": (3, width)}
        assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)
        for (xi, xq), out in zip((rows[:2], rows[2:]), outs):
            xb = torch.stack([xi[:, :T], xq[:, :T]], dim=-1)
            assert torch.equal(out, P.demod_batch_packed(xb, cfg, "cpu"))
    finally:
        graphed.cache_clear()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.name in ("airmodes.full_block",
                                 "graph _full_block_rows"))
    outer = [s for s in spans if s[2] == "airmodes.full_block"]
    inner = [s for s in spans if s[2] != "airmodes.full_block"]
    assert len(outer) == 2 and len(inner) == 2
    for (a, b, _), (c, d, _) in zip(outer, inner):
        assert a <= c and d <= b


# --- (d) the readers on a canned trace ---------------------------------------

T0, T1 = 1000.0, 101000.0          # the window, us
DISPATCH = 3


def _x(name, a, b, cat="user_annotation", tid=DISPATCH, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": a, "dur": b - a,
            "tid": tid, "args": args}


def _replay(corr, t, kernels=3, us=1000.0):
    """A graph replay's device events: a memset, then `kernels` kernels of
    `us` each, under the launch's correlation, and the copy of the
    outputs' clone under a correlation of its own."""
    ev = [_x("Memset (Device)", t - 20.0, t - 10.0, cat="gpu_memset",
             tid=7, correlation=corr)]
    ev += [_x(f"kernel_{k}", t + k * us, t + (k + 1) * us, cat="kernel",
              tid=7, correlation=corr) for k in range(kernels)]
    end = t + kernels * us
    return ev + [_x("Memcpy DtoD", end, end + 50.0, cat="gpu_memcpy",
                    tid=7, correlation=corr + 1)]


def canned(with_spans=True):
    """A 100 ms window on the dispatch thread: four full-block steps, each
    a span holding the replay's range, its `cudaGraphLaunch` and a clone,
    their device events running after the span, the fourth's past the
    window's end; a graph launched on another thread outside any
    full-block span; a lone kernel."""
    ev = [_x(WINDOW, T0, T1, tid=0)]
    for corr, t, length in ((10, 5000.0, 200.0), (20, 30000.0, 300.0),
                            (30, 60000.0, 400.0), (40, 99000.0, 200.0)):
        if with_spans:
            ev += [_x("airmodes.dispatch", t - 10.0, t + length + 10.0),
                   _x("airmodes.full_block", t, t + length)]
        ev += [_x("graph _full_block_rows", t + 20.0, t + length - 20),
               _x("cudaGraphLaunch", t + 30.0, t + 40.0,
                  cat="cuda_runtime"),
               _x("aten::clone", t + length - 15, t + length - 10,
                  cat="cpu_op")]
        ev += _replay(corr, t + length + 100.0)
    ev += [_x("cudaGraphLaunch", 80000.0, 80010.0, cat="cuda_runtime",
              tid=0)]
    ev += _replay(50, 80100.0, kernels=2)
    ev += [_x("vectorized_elementwise_kernel", 90000.0, 90100.0,
              cat="kernel", tid=7, correlation=60)]
    return Trace(ev)


def _ctx(trace, config):
    return spec.ReadContext(trace=trace, sink_spans=[], trace_mono=None,
                            config=config, traffic={}, rows_per_call=8)


def test_fullblock_readers_on_a_canned_trace():
    """Both readers take the three whole replays launched inside the span
    (the replay outside the span, the lone kernel, the clone's copy and the
    replay cut by the window's end left out). fullblock_roofline: their 3
    ms of kernels each (memsets left out) against the sps-10 bound of 8
    rows of 2^20, which binds on operations. fullblock_graph_nodes: a
    memset and 3 kernels a replay. Neither reads anything on a trace
    without the spans, or without a trace."""
    from benchmark.frozen import opcount
    config = spec.load_cell(CELL, ROOT).config
    tr = canned()
    ms, kind = opcount.bound(
        8 * (2 * (256 + (1 << 20) + 2420) + 129 * 36),
        8 * (1 << 20) * opcount.b1_ops_per_sample(10, 20))
    assert kind == "operations" and opcount.b1_ops_per_sample(10, 20) == 90
    roof = spec.reader("fullblock_roofline")(_ctx(tr, config))
    assert roof == pytest.approx(100 * 3 * ms * 1e-3 / (3 * 3000e-6))
    nodes = spec.reader("fullblock_graph_nodes")(_ctx(tr, config))
    assert nodes == 4
    for name in ("fullblock_roofline", "fullblock_graph_nodes"):
        assert spec.reader(name)(_ctx(canned(with_spans=False),
                                      config)) is None
        assert spec.reader(name)(_ctx(None, config)) is None
