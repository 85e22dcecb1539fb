"""The port's streaming pipeline (`airmodes_torch.dist.multihost`) against the
reference's (`airmodes.dist.multihost` on its virtual 8-device CPU mesh):
twins of tests/test_multihost.py and tests/test_multiprocess.py.

One process: the port's `PodPipeline(device="cpu")` gives the reference's
messages, string for string, on the f32 path (both packages run it on the
CPU) and on the planar path (the reference's planar kernels in interpret
mode). Several processes: this file is also the worker
(`python tests/test_torch_multihost.py <coordinator> <world> <rank>
<n_channel> <n_time> <seed>`), which joins a gloo group over
`multihost.initialize` and drives the same capture through `run_stream`
on its own shards; the union of the ranks' messages must hold every
injected frame, equal the one-process run's, and hold no duplicate, and
each rank must emit only messages of its own time shards. The
reference's modules load only inside the tests, so a worker imports no
JAX.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from airmodes_torch.config import DspConfig
from airmodes_torch.dist import multihost
from airmodes_torch.dist.multihost import PodPipeline
from airmodes_torch.dsp import host as host_mod
from airmodes_torch.testing import encoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME = "8d4840d6202cc371c32ce0576098"


def _ref():
    from airmodes.config import DspConfig as JaxCfg
    from airmodes.dist import multihost as jmultihost
    return JaxCfg, jmultihost


def _both(kw, **pipe_kw):
    """(port pipeline on the CPU, reference pipeline) for DspConfig(**kw)."""
    JaxCfg, jm = _ref()
    jc = JaxCfg(**kw)
    tc = DspConfig.from_dict(dataclasses.asdict(jc))
    return (PodPipeline(tc, device="cpu", **pipe_kw),
            jm.PodPipeline(jc, **pipe_kw))


def _stream(pipe, chunks):
    return [out for out in pipe.run_stream(chunks)]


def _same_streams(port, ref, chunks):
    """Both pipelines over the same chunks: the same messages, step by
    step. Returns the port's steps."""
    got = _stream(port, chunks())
    want = _stream(ref, chunks())
    assert got == want
    return got


def test_pod_pipeline_stream_decodes():
    port, ref = _both(dict(block_size=1 << 14, max_detections=32),
                      n_channel=2, n_time=4)
    assert port.samples_per_step == ref.samples_per_step == 4 * (1 << 14)
    assert port.planar is False           # the CPU takes the f32 path
    total = port.samples_per_step
    iq, truth = encoder.make_capture(encoder.random_df17_frames(10, seed=80),
                                     snr_db=20.0, spacing=total // 12,
                                     seed=80, total_samples=total + 5000)
    ch0, ch1 = iq.copy(), np.roll(iq, 1111)

    def chunks():
        return [np.stack([ch0[: total // 2], ch1[: total // 2]]),
                np.stack([ch0[total // 2:], ch1[total // 2:]])]

    msgs = [m for out in _same_streams(port, ref, chunks) for m in out]
    assert {t.hex for t in truth} <= {m.split()[1] for m in msgs}
    assert msgs == sorted(msgs, key=lambda m: float(m.split()[5]))


def test_pod_pipeline_step_offsets():
    """Messages of later steps carry offset timestamps."""
    port, ref = _both(dict(block_size=1 << 14, max_detections=32),
                      n_channel=1, n_time=8)
    total = port.samples_per_step
    pos = total + 3 * (1 << 14) + 100      # inside the SECOND step
    iq, _ = encoder.make_capture([(int(FRAME, 16), 112)], snr_db=25.0,
                                 start=pos, seed=81, total_samples=2 * total)
    msgs = [m for out in _same_streams(port, ref, lambda: [iq[None, :]])
            for m in out]
    matching = [m for m in msgs if m.split()[1] == FRAME]
    assert len(matching) == 1
    assert abs(float(matching[0].split()[5]) - pos / 2e6) < 1e-6


@pytest.mark.parametrize("planar", [False, True])
def test_step_boundary_frame_decoded(planar):
    """A frame straddling two consecutive STEPS decodes exactly once, on
    both paths; on the planar one dBFS stays referenced to the float full
    scale."""
    port, ref = _both(dict(block_size=1 << 14, max_detections=16),
                      n_channel=1, n_time=2, planar=planar)
    S = port.samples_per_step
    iq, truth = encoder.make_capture(
        [(int(FRAME, 16), 112)], snr_db=25.0, start=S - 100, seed=8,
        total_samples=2 * S)

    def chunks():
        return [iq[None, :S // 2], iq[None, S // 2: S + 777],
                iq[None, S + 777:]]

    msgs = [m for out in _same_streams(port, ref, chunks) for m in out]
    assert [m.split()[1] for m in msgs].count(truth[0].hex) == 1
    if planar:
        assert -30.0 < float(msgs[0].split()[4]) < 1.0


def test_planar_stream_matches_f32_stream():
    """Planar and f32 streaming decode every frame of a multi-step
    capture with traffic near every boundary, each equal to the
    reference's."""
    kw = dict(block_size=1 << 14, max_detections=32)
    S = 2 * kw["block_size"]
    iq, truth = encoder.make_capture(encoder.random_df17_frames(8, seed=91),
                                     snr_db=22.0, spacing=S // 5, seed=91,
                                     total_samples=2 * S + 3000)

    def chunks():
        return [iq[None, :S - 50], iq[None, S - 50:]]

    want = {t.hex for t in truth}
    for planar in (False, True):
        port, ref = _both(kw, n_channel=1, n_time=2, planar=planar)
        got = {m.split()[1] for out in _same_streams(port, ref, chunks)
               for m in out}
        assert want <= got, planar


def test_quantize_planar_i8_np_matches_reference():
    """The numpy planar quantizer of complex input against the reference's:
    NaN to 0, +-Inf saturating to +-127, ties rounding half to even, on
    complex64 input."""
    from airmodes.dsp import host as jhost
    from airmodes_torch.dsp import host as thost
    nan, inf = np.nan, np.inf
    special = np.array([complex(nan, 0.25), complex(inf, -inf),
                        complex(-0.75, nan), complex(1.25, -1.75),
                        complex(0.75, -0.25), complex(100.0, -100.0)],
                       np.complex64)
    rng = np.random.default_rng(5)
    noise = (rng.normal(size=250) + 1j * rng.normal(size=250)) * 20.0
    iq = np.concatenate([special, noise.astype(np.complex64)])
    gain = 2.0                      # the specials' x * gain are exact ties
    xi, xq = thost.quantize_planar_i8_np(iq, gain)
    ri, rq = jhost.quantize_planar_i8_np(iq, gain)
    assert xi.dtype == xq.dtype == np.int8
    assert np.array_equal(xi, ri) and np.array_equal(xq, rq)
    assert xi[:6].tolist() == [0, 127, -2, 2, 2, 127]
    assert xq[:6].tolist() == [0, -127, 0, -4, 0, -127]


def test_planar_stream_numpy_quantizer_matches_native(monkeypatch):
    """Without the native runtime the planar stream quantizes with
    `quantize_planar_i8_np`; it gives the native quantizer's messages."""
    from airmodes_torch.dsp import host as thost
    from airmodes_torch.io import native_stream
    kw = dict(block_size=1 << 14, max_detections=32)
    S = 2 * kw["block_size"]
    iq, truth = encoder.make_capture(encoder.random_df17_frames(8, seed=93),
                                     snr_db=20.0, spacing=S // 5, seed=93,
                                     total_samples=S + 3000)
    gain = 120.0 / float(np.abs(iq).max())
    calls = []
    numpy_q = thost.quantize_planar_i8_np

    def counted(x, g):
        calls.append(x.shape)
        return numpy_q(x, g)

    def run():
        pipe = PodPipeline(DspConfig(**kw), n_channel=1, n_time=2,
                           planar=True, gain=gain, device="cpu")
        return [out for out in pipe.run_stream([iq[None, :]])]

    monkeypatch.setattr(thost, "quantize_planar_i8_np", counted)
    native = run()
    assert calls == []
    monkeypatch.setattr(native_stream, "native_available", lambda: False)
    assert run() == native
    assert calls and all(c == (1, S) for c in calls)
    assert {t.hex for t in truth} <= {m.split()[1] for o in native
                                      for m in o}


def test_pod_stream_tail_longer_than_one_step():
    """An EOF tail spanning MORE than one full step drains step by step;
    messages fall in their owning step's sample range."""
    port, ref = _both(dict(block_size=1 << 14, max_detections=16),
                      n_channel=1, n_time=2, planar=False)
    S = port.samples_per_step
    total = int(3.6 * S)
    iq, truth = encoder.make_capture(encoder.random_df17_frames(6, seed=92),
                                     snr_db=22.0, spacing=total // 7,
                                     seed=92, total_samples=total)
    outs = _same_streams(port, ref, lambda: [iq[None, :]])
    assert len(outs) == 4
    assert {t.hex for t in truth} <= {m.split()[1] for o in outs for m in o}
    for i, out in enumerate(outs):
        for m in out:
            assert i * S <= float(m.split()[5]) * 2e6 < (i + 1) * S


def test_pod_stream_many_tiny_chunks():
    """UDP-sized chunks (hundreds per step) give the same messages."""
    port, ref = _both(dict(block_size=1 << 14, max_detections=32),
                      n_channel=1, n_time=2, planar=False)
    S = port.samples_per_step
    total = 2 * S + 777
    iq, truth = encoder.make_capture(encoder.random_df17_frames(12, seed=21),
                                     snr_db=20.0, spacing=total // 13,
                                     seed=21, total_samples=total)
    rng = np.random.default_rng(4)
    cuts = [0]
    while cuts[-1] < total:
        cuts.append(cuts[-1] + int(rng.integers(1, 700)))

    def chunks():
        return iter([iq[None, a:b] for a, b in zip(cuts, cuts[1:])])

    got = {m.split()[1] for o in _same_streams(port, ref, chunks) for m in o}
    assert {t.hex for t in truth} <= got


def test_pod_stream_rejects_channel_mismatch():
    """A chunk with the wrong channel count raises (numpy would broadcast
    it across every channel)."""
    pipe = PodPipeline(DspConfig(block_size=1 << 14, max_detections=16),
                       n_channel=2, n_time=1, planar=False, device="cpu")
    with pytest.raises(ValueError, match="channel"):
        list(pipe.run_stream(iter([np.zeros((1, 2048), np.complex64)])))


def test_pod_samples_per_step_int32_guard():
    """A step past 2^31 samples overflows the int32 index: it raises at
    construction, as the reference's."""
    JaxCfg, jm = _ref()
    for mod, cfg_cls in ((multihost, DspConfig), (jm, JaxCfg)):
        kw = {"device": "cpu"} if mod is multihost else {}
        with pytest.raises(ValueError, match="2\\^31|int32"):
            mod.PodPipeline(cfg_cls(block_size=1 << 30, max_detections=16),
                            n_channel=1, n_time=2, planar=False, **kw)


def test_run_step_and_run_step_planar_match_reference():
    """The one-step entry points with host context, against the
    reference's."""
    kw = dict(block_size=1 << 14, max_detections=32)
    S = 2 * kw["block_size"]
    iq, truth = encoder.make_capture(encoder.random_df17_frames(6, seed=93),
                                     snr_db=22.0, spacing=S // 7, seed=93,
                                     total_samples=S)
    port, ref = _both(kw, n_channel=1, n_time=2, planar=False)
    step = np.stack([iq.real, iq.imag], -1).astype(np.float32)[None]
    got = port.run_step(step, 1000)
    assert got == ref.run_step(step, 1000)
    assert {t.hex for t in truth} <= {m.split()[1] for m in got}
    port, ref = _both(kw, n_channel=1, n_time=2, planar=True)
    g = 120.0 / float(np.abs(iq).max())
    xi = np.clip(np.round(iq.real * g), -127, 127).astype(np.int8)[None]
    xq = np.clip(np.round(iq.imag * g), -127, 127).astype(np.int8)[None]
    got = port.run_step_planar(xi, xq, 0, full_scale=g / 127.0)
    assert got == ref.run_step_planar(xi, xq, 0, full_scale=g / 127.0)
    with pytest.raises(ValueError, match="planar"):
        port.run_step(step, 0)


@pytest.mark.parametrize("args", [
    (1 << 22, 9300.0, 45e9, 2e-6, True),
    (1 << 22, 9300.0, 4.5e9, 2e-5, False),
    (4096, 9300.0, 4.5e9, 2e-5, True),
    (1 << 20, 2559.4, 450e9, 5e-6, True)])
def test_ici_scaling_model_matches_reference(args):
    """The model's terms equal the reference's for the same arguments; the
    port takes the link figures as required arguments."""
    JaxCfg, jm = _ref()
    block, msps, bw, lat, planar = args
    got = multihost.ici_scaling_model(DspConfig(block_size=block), msps,
                                      bw, lat, planar=planar)
    want = jm.ici_scaling_model(JaxCfg(block_size=block), msps,
                                planar=planar, ici_bytes_per_s=bw,
                                hop_latency_s=lat)
    assert got == want
    with pytest.raises(TypeError):
        multihost.ici_scaling_model(DspConfig(), msps)


def test_scaling_report_runs_on_the_cpu():
    rows = multihost.scaling_report(
        DspConfig(block_size=1 << 14, max_detections=16), [(1, 1), (1, 2)],
        n_steps=1, device="cpu")
    assert [r["mesh"] for r in rows] == [(1, 1), (1, 2)]
    assert rows[0]["efficiency"] == 1.0 and rows[1]["samples_per_s"] > 0


def test_initialize(monkeypatch):
    """initialize joins a gloo group on the CPU (NCCL on a card): explicit
    arguments over a tcp:// store, the launcher environment over env://;
    one process, or no launcher environment, does nothing."""
    import torch.distributed as dist
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    multihost.initialize(device="cpu")
    multihost.initialize("127.0.0.1:1234", 1, 0, device="cpu")
    assert calls == []
    multihost.initialize("127.0.0.1:1234", 2, 1, device="cpu")
    assert calls[-1] == (("gloo",), {"init_method": "tcp://127.0.0.1:1234",
                                     "world_size": 2, "rank": 1})
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    multihost.initialize(device="cpu")
    assert len(calls) == 1
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    multihost.initialize(device="cpu")
    assert calls[-1] == (("gloo",), {"init_method": "env://",
                                     "world_size": 4, "rank": 3})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.initialize("127.0.0.1:1234", 2, 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PodPipeline(DspConfig(block_size=1 << 14))


# --- several processes --------------------------------------------------------

def _capture(n_channel, n_time, seed):
    """The worker's capture: traffic through one step plus a tail, so a
    second (padded) step runs; channel c is the stream rolled by c*1111."""
    cfg = DspConfig(block_size=1 << 14, max_detections=32)
    S = n_time * cfg.block_size
    iq, truth = encoder.make_capture(encoder.random_df17_frames(10, seed=seed),
                                     snr_db=22.0, spacing=S // 12, seed=seed,
                                     total_samples=S + 4321)
    x = np.stack([np.roll(iq, 1111 * c) for c in range(n_channel)])
    return cfg, x, truth


def _worker(argv) -> int:
    coord, world, rank = argv[0], int(argv[1]), int(argv[2])
    n_channel, n_time, seed = (int(a) for a in argv[3:6])
    stand_in = argv[6:] == ["stand-in"]
    torch.set_num_threads(1)
    import torch.distributed as dist
    multihost.initialize(coord, world, rank, device="cpu")
    try:
        cfg, x, _ = _capture(n_channel, n_time, seed)
        out = {"rank": rank}
        for planar in (False, True):
            pipe = PodPipeline(cfg, n_channel=n_channel, n_time=n_time,
                               planar=planar, device="cpu")
            assert pipe.mesh.world == world and pipe.mesh.rank == rank
            out["planar" if planar else "f32"] = [
                m for o in pipe.run_stream([x]) for m in o]
        out["times"] = [pipe.mesh.times.start, pipe.mesh.times.stop]
        if stand_in:
            out.update(_stand_in_runs(cfg, x, n_channel, n_time))
        print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _stand_in_runs(cfg, x, n_channel, n_time) -> dict:
    """The worker's runs under the stand-in graph (tests/torch_fake_graph):
    both pipelines again, every transfer guarded against running inside a
    graph; then the planar step given the full host arrays of the first
    step, whose graph must take this rank's shards only. Returns the
    messages, the shapes of the graphs' stream buffers and the replays."""
    from airmodes_torch.dist import sharded
    from torch_fake_graph import guard_transfers, install_fake_graph
    install_fake_graph()
    ran = guard_transfers(sharded)
    out = {}
    for planar in (False, True):
        pipe = PodPipeline(cfg, n_channel=n_channel, n_time=n_time,
                           planar=planar, device="cpu")
        local = sharded._planar_local if planar else sharded._f32_local
        r0 = local.replays
        out["stand-in " + ("planar" if planar else "f32")] = [
            m for o in pipe.run_stream([x]) for m in o]
        out["replays " + ("planar" if planar else "f32")] = \
            local.replays - r0
    S = n_time * cfg.block_size
    xi, xq = (np.ascontiguousarray(host_mod.quantize_i8_np(f, 120.0))
              for f in (x[:, :S].real, x[:, :S].imag))
    sharded._planar_local.cache_clear()
    table = sharded.make_sharded_demod_planar(pipe.mesh, cfg)(xi, xq)
    out["table shape"] = list(table.index.shape[:2])
    out["buffer shapes"] = [list(e.inputs["xi"].shape) for e in
                            sharded._planar_local._cache.values()]
    out["transfers"] = len(ran)
    return out


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_ranks(world, n_channel, n_time, seed, *extra):
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), coord, str(world),
         str(r), str(n_channel), str(n_time), str(seed), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=150)
            assert p.returncode == 0, f"worker failed:\n{err[-4000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.mark.parametrize("world,shape", [(2, (1, 8)), (4, (2, 4))],
                         ids=["2 ranks, (1, 8)", "4 ranks, (2, 4)"])
def test_ranks_union_matches_one_process(world, shape):
    """`world` gloo processes, each owning its run of a `shape` mesh (on
    (2, 4) over 4 ranks, rank 1 owns (0, 2), (0, 3) and rank 2 (1, 0),
    (1, 1): the shards span a channel boundary across ranks). On both
    paths the union of the ranks' messages holds every frame, has no
    duplicate and equals the one-process run's (on the f32 path also the
    reference's); every rank emits only its own time shards."""
    n_channel, n_time = shape
    seed = 77
    outs = _run_ranks(world, n_channel, n_time, seed)
    cfg, x, truth = _capture(n_channel, n_time, seed)
    want_hex = {t.hex for t in truth}
    blk_s = cfg.block_size / cfg.channel_rate
    step_s = n_time * blk_s
    for o in outs:
        t0, t1 = o["times"]
        for m in o["f32"] + o["planar"]:
            t = int(float(m.split()[5]) % step_s / blk_s)
            assert t0 <= t < t1, (o["rank"], m)
        assert o["f32"] and o["planar"], o["rank"]

    JaxCfg, jm = _ref()
    ref = jm.PodPipeline(JaxCfg(block_size=cfg.block_size,
                                max_detections=cfg.max_detections),
                         n_channel=n_channel, n_time=n_time, planar=False)
    one = {"f32": [m for o in ref.run_stream([x]) for m in o]}
    pipe = PodPipeline(cfg, n_channel=n_channel, n_time=n_time, planar=True,
                       device="cpu")
    one["planar"] = [m for o in pipe.run_stream([x]) for m in o]
    for mode in ("f32", "planar"):
        union = [m for o in outs for m in o[mode]]
        assert len(union) == len(set(union)), mode
        assert sorted(union) == sorted(one[mode]), mode
        assert want_hex <= {m.split()[1] for m in union}, mode



@pytest.mark.parametrize("world,shape", [(2, (1, 8)), (4, (2, 4))],
                         ids=["2 ranks, (1, 8)", "4 ranks, (2, 4)"])
def test_ranks_with_stand_in_graph_match_eager(world, shape):
    """The gloo runs of test_ranks_union_matches_one_process again, each
    rank's pipelines also under the stand-in graph: every rank's messages
    equal its eager pipeline's, message for message, one replay of the
    local step per step, no transfer inside a graph (the guard raises in
    the worker) and transfers outside wherever a row spans ranks; the
    planar step given the full host arrays keeps this rank's shards in
    its graph and returns this rank's table."""
    n_channel, n_time = shape
    outs = _run_ranks(world, n_channel, n_time, 78, "stand-in")
    per = n_channel * n_time // world
    local = (max(per // n_time, 1), min(per, n_time))
    cfg, _, _ = _capture(n_channel, n_time, 78)
    for o in outs:
        for mode in ("f32", "planar"):
            assert o["stand-in " + mode] == o[mode], (o["rank"], mode)
            assert o["replays " + mode] == 2, (o["rank"], mode)
        assert o["table shape"] == list(local)
        assert o["buffer shapes"] == [[local[0], local[1] * cfg.block_size]]
        assert (o["transfers"] > 0) == (per < n_time)
    assert any(o["planar"] for o in outs)


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1:]))
