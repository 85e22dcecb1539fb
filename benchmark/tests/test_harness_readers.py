"""Each per-layer reader on a canned trace, and the trace's reduction."""

import pytest

from benchmark import spec
from benchmark.tracing import WINDOW, Trace

CONFIG_I8 = {"dsp": {"channel_rate": 2e6, "threshold_db": 5.0,
                     "block_size": 1 << 20, "max_detections": 128,
                     "noise_window": 128}}
CONFIG_FUSED = dict(CONFIG_I8, resampler={"p": 1, "q": 5, "taps": 60})


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": 1, "args": args}


def canned():
    """A 1 s window: two steps 0.5 s apart, each a graph replay
    (correlation 10, 20) of 3 gemms, an add, B1's two kernels and a copy;
    the sink's range and the consumer's wait on the host."""
    ev = [{"ph": "M", "name": "thread_name", "tid": 1,
           "args": {"name": "main"}},
          _x(WINDOW, "user_annotation", 0.0, 1e6),
          _x("bench.next", "user_annotation", 0.0, 4e5),
          _x("bench.sink", "user_annotation", 4e5, 9e4)]
    for k, t in ((10, 1000.0), (20, 501000.0)):
        ev += [_x("sm90_gemm_f32", "kernel", t, 300.0, correlation=k),
               _x("sm90_gemm_f32", "kernel", t + 300, 300.0, correlation=k),
               _x("add_kernel", "kernel", t + 600, 50.0, correlation=k),
               _x("sm90_gemm_f32", "kernel", t + 650, 300.0, correlation=k),
               _x("add_kernel", "kernel", t + 950, 50.0, correlation=k),
               _x("void detect_chunk_kernel<false, true>(Params)", "kernel",
                  t + 1000, 50.0, correlation=k),
               _x("merge_unordered_kernel(Params)", "kernel", t + 1050,
                  5.0, correlation=k),
               _x("Memcpy DtoH", "gpu_memcpy", t + 1100, 100.0,
                  correlation=k + 1)]
    ev.append(_x("outside", "kernel", 2e6, 5.0, correlation=99))
    return Trace(ev)


def ctx(config, rows=8, kernels=(), spans=()):
    return spec.ReadContext(trace=canned(), sink_spans=list(spans),
                            trace_mono=(100.0, 101.0), config=config,
                            traffic={}, rows_per_call=rows,
                            resampler_kernels=list(kernels))


def test_trace_reduction():
    tr = canned()
    assert tr.window_s == pytest.approx(1.0)
    assert len(tr.device) == 16                    # "outside" is clipped
    # per step: the kernels 0-1055 us and the copy 1100-1200 us
    assert tr.busy_s == pytest.approx(2 * 1155e-6)
    assert tr.top_ops(1) == [["sm90_gemm_f32", pytest.approx(1800e-6)]]
    gaps = tr.idle_gaps(2)
    assert gaps[0][1] == pytest.approx(0.4988)    # between the steps
    assert gaps[0][0] == "main: bench.next; main: bench.sink"
    assert len(tr.steps(100e3)) == 2


def test_device_idle_share():
    v = spec.reader("device_idle_share")(ctx(CONFIG_I8))
    assert v == pytest.approx(100 * (1 - 2310e-6))


def test_b1_roofline():
    from benchmark.frozen import opcount
    v = spec.reader("b1_roofline")(ctx(CONFIG_I8, rows=8))
    # 8 rows of 2^20 at 44 instructions a sample bind on operations
    ms, kind = opcount.bound(0, 8 * (1 << 20) * 44)
    assert kind == "operations"
    assert v == pytest.approx(100 * 2 * ms * 1e-3 / (2 * 55e-6), rel=0.02)
    assert 0 < v < 100


def test_resample_roofline():
    k = ["sm90_gemm_f32", "sm90_gemm_f32", "add_kernel", "sm90_gemm_f32",
         "add_kernel"]
    v = spec.reader("resample_roofline")(ctx(CONFIG_FUSED, kernels=k))
    assert v is not None and 0 < v < 100
    from benchmark.frozen import opcount
    w = 256 + (1 << 20) + 242
    ms, kind = opcount.bound(16 * 4 * (5 * (w - 1) + 60 + w), 16 * w * 60)
    assert kind == "bytes"
    assert v == pytest.approx(100 * ms * 1e-3 / 1000e-6)
    # without the set-up's names, or on a config without a resampler:
    # nothing to read
    assert spec.reader("resample_roofline")(ctx(CONFIG_FUSED)) is None
    assert spec.reader("resample_roofline")(
        ctx(CONFIG_I8, kernels=k)) is None


def test_decode_us_per_msg():
    spans = [(100.1, 100.2, 1000), (100.5, 100.55, 500), (99.0, 99.5, 7)]
    for name in ("decode_us_per_msg.replay", "decode_us_per_msg.live"):
        v = spec.reader(name)(ctx(CONFIG_I8, spans=spans))
        assert v == pytest.approx(1e6 * 0.15 / 1500)
        assert spec.reader(name)(ctx(CONFIG_I8)) is None


def test_step_device_ms():
    # two steps; both touch the window's edges, so neither is whole
    assert spec.reader("step_device_ms.live")(ctx(CONFIG_I8)) is None
    tr = canned()
    tr.device += [(n, a + 250000.0, b + 250000.0, c, k)
                  for n, a, b, c, k in tr.device[:8]]
    tr.device.sort(key=lambda d: d[1])
    c = ctx(CONFIG_I8)
    c.trace = tr
    assert spec.reader("step_device_ms.live")(c) == pytest.approx(1.2)
