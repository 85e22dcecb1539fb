"""The sharded steps as compiled steps (`airmodes_torch.dist.sharded`'s
`_f32_local`, `_planar_local`, `_resample_local`; `PodPipeline`'s steps):
each factory's step against the reference's jitted `shard_map` program on
its 8-device CPU mesh, and the graph mechanism under the stand-in graph
(`torch_fake_graph.FakeGraph`, with `graphs._on_card` answering yes).

Parity (ROADMAP "Parity contract"): the (C, T) tables identical in every
integer field, `noise` within rtol 1e-5 on the planar steps and 1e-4 on the
full-block (f32) steps; the resampled steps by messages, field by field,
ref_dbfs within 0.1 dB (tests/test_torch_resample.py: the resampler's f32
matmuls sum in another order than XLA's).

The mechanism: a replay equals the eager step on a new input, one capture
per key and two factories with equal arguments share it, no transfer
between ranks runs inside a warm-up, capture or replay, and a rank given
the full host array puts only its own shards into the graph. The gloo
runs of several processes with the stand-in are in
tests/test_torch_multihost.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from airmodes.config import DspConfig as JaxCfg
from airmodes.dist import sharded as jsharded
from airmodes.dsp.pipeline import iq_to_device_layout
from airmodes.testing import encoder
from airmodes_torch.config import DspConfig
from airmodes_torch.dist import sharded
from airmodes_torch.dist.multihost import PodPipeline
from airmodes_torch.dsp import host
from airmodes_torch.dsp.pipeline import DetectionTable
from torch_fake_graph import guard_transfers, install_fake_graph

JC = JaxCfg(block_size=1 << 14, max_detections=32)
RJC = JaxCfg(channel_rate=4e6, block_size=1 << 14, max_detections=16)
P_UP, Q_DN = 2, 3          # 6 Msps raw -> 4 Msps (sps 2)
SHAPE = (2, 4)
CPU = torch.device("cpu")


def _tc(jc):
    return DspConfig.from_dict(dataclasses.asdict(jc))


def _stream(seed, total, rate, start):
    """Two channels (the second the first rolled by 1111 samples) of DF17
    traffic at 22 dB, the first frame at `start`: complex64 (2, total)."""
    iq, _ = encoder.make_capture(
        encoder.random_df17_frames(10, seed=seed), rate=rate, snr_db=22.0,
        spacing=total // 12, start=start, seed=seed, total_samples=total)
    return np.stack([iq, np.roll(iq, 1111)])


def _quantize(x):
    """complex64 (C, N) -> int8 planar (I, Q) at 120 over the peak."""
    f = iq_to_device_layout(x)
    x8 = np.clip(np.round(f * (120.0 / float(np.max(np.abs(f))))),
                 -127, 127).astype(np.int8)
    return np.ascontiguousarray(x8[..., 0]), np.ascontiguousarray(x8[..., 1])


def _ctx(seed, left, right):
    """A step's context: the streams just before and just after it."""
    before = _stream(seed, 1 << 14, 2e6, 1 << 13)
    return before[:, -left:], _stream(seed + 1, 1 << 14, 2e6, 0)[:, :right]


def _inputs(case, seed, n_time=SHAPE[1]):
    """(port arguments, reference arguments) of one step's call: host
    arrays of two channels, which the port's front shards and the
    reference places."""
    tc = _tc(JC)
    total = n_time * JC.block_size
    x = _stream(seed, total, 2e6, JC.block_size - 130)
    if case in ("demod", "demod_ctx"):
        f = iq_to_device_layout(x)
        args = (f,)
        if case == "demod_ctx":
            lc, rc = _ctx(seed, tc.left_halo, tc.right_halo)
            args += (iq_to_device_layout(lc), iq_to_device_layout(rc))
        return args, args
    if case in ("planar", "planar_ctx"):
        args = _quantize(x)
        if case == "planar_ctx":
            lc, rc = (_quantize(c) for c in _ctx(seed, tc.left_halo,
                                                 tc.right_halo))
            args += (lc[0], lc[1], rc[0], rc[1])
        return args, args
    raw_total = n_time * RJC.block_size * Q_DN // P_UP
    raw = _stream(seed, raw_total, 6e6, RJC.block_size * Q_DN // P_UP - 150)
    if case == "resample":
        f = iq_to_device_layout(raw)
        return (f,), (f,)
    iqp = np.stack([raw.real, raw.imag], axis=1).astype(np.float32)
    gain = np.float32(120.0 / float(np.abs(raw).max()))
    return (iqp, gain), (iqp, gain)


# case: (the port's factory on (mesh, cfg), its graphed local step, the
# reference's step on (jmesh, jcfg), the noise rtol or None for messages)
CASES = {
    "demod": (lambda m, c: sharded.make_sharded_demod(m, c), "_f32_local",
              lambda m, c: jsharded.make_sharded_demod(m, c), 1e-4),
    "demod_ctx": (lambda m, c: sharded.make_sharded_demod_ctx(m, c),
                  "_f32_local",
                  lambda m, c: jsharded.make_sharded_demod_ctx(m, c), 1e-4),
    "planar": (lambda m, c: sharded.make_sharded_demod_planar(m, c),
               "_planar_local",
               lambda m, c: jsharded.make_sharded_demod_planar(
                   m, c, interpret=True), 1e-5),
    "planar_ctx": (lambda m, c: sharded.make_sharded_demod_planar_ctx(m, c),
                   "_planar_local",
                   lambda m, c: jsharded.make_sharded_demod_planar_ctx(
                       m, c, interpret=True), 1e-5),
    "resample": (lambda m, c: sharded.make_sharded_resample_demod(
        m, c, P_UP, Q_DN), "_resample_local",
        lambda m, c: jsharded.make_sharded_resample_demod(m, c, P_UP, Q_DN),
        None),
    "resample_planar": (lambda m, c: sharded.make_sharded_resample_demod(
        m, c, P_UP, Q_DN, planar=True), "_resample_local",
        lambda m, c: jsharded.make_sharded_resample_demod(
            m, c, P_UP, Q_DN, planar=True, interpret=True), None),
}


def _cfg_of(case):
    return RJC if case.startswith("resample") else JC


def _ref_args(case, args, jmesh):
    """The reference's arguments: the streams placed on its mesh."""
    if case in ("demod", "demod_ctx", "resample"):
        return (jsharded.shard_input(args[0], jmesh),) + args[1:]
    if case in ("planar", "planar_ctx"):
        return jsharded.shard_input_planar(args[0], args[1], jmesh) + args[2:]
    return (jsharded.shard_input_resample_planar(args[0], jmesh),) + args[1:]


def _messages(table, cfg, full_scale=1.0):
    arr = [np.asarray(f.cpu() if isinstance(f, torch.Tensor) else f)
           for f in table]
    msgs = []
    for c in range(arr[0].shape[0]):
        for t in range(arr[0].shape[1]):
            msgs += host.table_to_messages(
                DetectionTable(*(a[c, t] for a in arr)), 0, cfg.channel_rate,
                full_scale=full_scale)
    return sorted(msgs, key=lambda m: (float(m.split()[5]), m))


def _same_messages(got, want):
    """Field by field, in order; ref_dbfs within 0.1 dB."""
    assert len(got) == len(want), (len(got), len(want))
    for a, b in zip(got, want):
        fa, fb = a.split(), b.split()
        assert fa[:4] + fa[5:] == fb[:4] + fb[5:], (a, b)
        assert abs(float(fa[4]) - float(fb[4])) <= 0.1, (a, b)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("case", list(CASES))
def test_graphed_sharded_step_matches_reference(case):
    """Each factory's step (its host front, then its compiled local step)
    on a (2, 4) mesh against the reference's jitted step on its (2, 4)
    CPU mesh, under the parity contract; every frame decodes."""
    make, _, ref, rtol = CASES[case]
    jc = _cfg_of(case)
    tc = _tc(jc)
    args, rargs = _inputs(case, seed=40)
    jmesh = jsharded.make_mesh(*SHAPE)
    want = jax.block_until_ready(ref(jmesh, jc)(*_ref_args(case, rargs,
                                                           jmesh)))
    got = make(sharded.make_mesh(*SHAPE, device="cpu"), tc)(*args)
    if rtol is None:
        fs = float(args[1]) / 127.0 if case == "resample_planar" else 1.0
        msgs = _messages(got, tc, fs)
        _same_messages(msgs, _messages(want, tc, fs))
        assert len({m.split()[1] for m in msgs}) >= 8
        return
    for name, g, w in zip(DetectionTable._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if name == "noise":
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
    assert len({m.split()[1] for m in _messages(got, tc)}) >= 8


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_replays_its_eager_step(case, monkeypatch):
    """Under the stand-in graph: a factory's first call captures its local
    step once and equals the eager step, a second call on another input
    replays it and equals the eager step on that input; a second factory
    built on equal arguments replays the same graph; no transfer runs."""
    make, local, _, _ = CASES[case]
    tc = _tc(_cfg_of(case))
    a0, _ = _inputs(case, seed=41)
    a1, _ = _inputs(case, seed=42)
    mesh = sharded.make_mesh(*SHAPE, device="cpu")
    fn = make(mesh, tc)
    eager = [fn(*a0), fn(*a1)]
    g = getattr(sharded, local)
    g.cache_clear()
    fake = install_fake_graph(monkeypatch.setattr)
    ran = guard_transfers(sharded, monkeypatch.setattr)
    c0 = g.captures
    got = [fn(*a0), fn(*a1)]
    assert _equal(got[0], eager[0]) and _equal(got[1], eager[1])
    assert not _equal(got[0], got[1])
    assert g.captures - c0 == 1 and len(g) == 1 and len(fake.made) == 1
    again = make(sharded.make_mesh(*SHAPE, device="cpu"), tc)(*a1)
    assert _equal(again, eager[1])
    assert g.captures - c0 == 1 and len(fake.made) == 1
    assert fake.made[0].replays == 3
    assert ran == []


def _by_rank(monkeypatch, meshes, run):
    """Run `run(mesh)` for every rank with transfers served in-process
    (tests/test_torch_dist.py's helper, under the transfer guard): first
    every rank's sends are recorded, then each rank runs again and its
    receives take them, in order per sender, receiver and tag (the fused
    resample step's two exchanges use the same tags, one after the
    other). Returns each rank's second result."""
    sent = {}

    def record(mesh, plan):
        for kind, t, peer, tag in plan:
            if kind == "send":
                sent.setdefault((mesh.rank, peer, tag), []).append(t.clone())

    def serve(mesh, plan):
        for kind, t, peer, tag in plan:
            if kind == "recv":
                queue = sent[(peer, mesh.rank, tag)]
                t.copy_(queue.pop(0))
                if not queue:
                    del sent[(peer, mesh.rank, tag)]

    monkeypatch.setattr(sharded, "_transfer", record)
    guard_transfers(sharded, monkeypatch.setattr)
    for m in meshes:
        run(m)
    monkeypatch.setattr(sharded, "_transfer", serve)
    ran = guard_transfers(sharded, monkeypatch.setattr)
    out = [run(m) for m in meshes]
    assert not sent and ran
    return out


@pytest.mark.parametrize("case", ["planar", "resample_planar"])
def test_host_array_is_sharded_before_the_graph(case, monkeypatch):
    """Each rank of a (1, 8) mesh over 2 ranks, given the full host
    arrays every rank passes: its graph's input buffers hold its own four
    shards only, and its table is its slice of the one-process table
    (transfers served in-process, outside every graph). The fused
    resample step, whose row continues on the other rank, runs two graphs
    with the demod halos' transfers between them."""
    tc = _tc(_cfg_of(case))
    make = CASES[case][0]
    args, _ = _inputs(case, seed=43, n_time=8)
    if case == "planar":
        args = tuple(a[:1] for a in args)
    else:
        args = (args[0][:1], args[1])
    whole = make(sharded.make_mesh(1, 8, device="cpu"), tc)(*args)
    install_fake_graph(monkeypatch.setattr)
    for name in ("_planar_local", "_resample_local"):
        getattr(sharded, name).cache_clear()
    meshes = [sharded.Mesh(1, 8, "group", CPU, r, 2) for r in range(2)]
    got = _by_rank(monkeypatch, meshes, lambda m: make(m, tc)(*args))
    for m, table in zip(meshes, got):
        t = m.times
        assert _equal(table, [f[:, t.start:t.stop] for f in whole])
    raw = (tc.block_size * Q_DN // P_UP if case == "resample_planar"
           else tc.block_size)
    first = {"planar": ("_planar_local", "xi", (1, 4 * raw)),
             "resample_planar": ("_resample_local", "x", (1, 2, 4 * raw))}
    name, arg, shape = first[case]
    buffers = [e.inputs[arg].shape for e in getattr(sharded, name)._cache
               .values()]
    assert buffers and all(tuple(s) == shape for s in buffers), buffers
    if case == "resample_planar":
        assert len(sharded._planar_local) == 2      # the demod graph


def _pod_stream(pipe, x):
    return list(pipe.run_stream(x[:, i: i + 20000]
                                for i in range(0, x.shape[1], 20000)))


@pytest.mark.parametrize("planar", [False, True], ids=["f32", "planar"])
def test_pod_pipeline_replays_equal_the_eager_pipeline(planar, monkeypatch):
    """PodPipeline on a (2, 4) mesh: run_stream and run_step[_planar]
    under the stand-in graph give the eager pipeline's messages, message
    for message; run_stream replays one graph (the packed local step) per
    step, captured once."""
    tc = _tc(JC)
    S = SHAPE[1] * tc.block_size
    x = _stream(44, 2 * S + 4321, 2e6, tc.block_size - 130)
    pipe = PodPipeline(tc, *SHAPE, planar=planar, device="cpu")

    def one_step(p):
        if not planar:
            return p.run_step(iq_to_device_layout(x[:, :S]), 0)
        xi, xq = (host.quantize_i8_np(f, p.gain) for f in (x[:, :S].real,
                                                            x[:, :S].imag))
        return p.run_step_planar(xi, xq, 0, full_scale=p.gain / 127.0)

    eager = _pod_stream(pipe, x), one_step(pipe)
    g = sharded._planar_local if planar else sharded._f32_local
    g.cache_clear()
    install_fake_graph(monkeypatch.setattr)
    ran = guard_transfers(sharded, monkeypatch.setattr)
    r0 = g.replays
    steps = _pod_stream(pipe, x)
    assert steps == eager[0] and sum(map(len, steps)) >= 8
    assert g.replays - r0 == len(steps) == 3 and len(g) == 1
    assert one_step(pipe) == eager[1] and len(g) == 1
    assert ran == []
