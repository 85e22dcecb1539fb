"""The port's benchmark (`airmodes_torch.bench`, run with `device="cpu"`)
against the reference's `bench.py`, imported by path, at small sizes.

What is compared:
- the capture builders: the same planar int8 rows, ground truth, uc8
  bytes and ICAO sets;
- the planar step on that capture: the port's packed tables equal
  `demod_batch_packed_planar_jit(..., interpret=True)`'s in every int32
  column, `noise` within rtol 1e-5 (the two frameworks reduce the
  128-sample mean in different orders);
- the decode accounting: the port's `account` over its table against the
  reference's own statements (lifted from its `main` with `ast`) over the
  reference's table: per-DF counts, spurious counts by status, DF17
  misses;
- the figures that decode (`bench_host_only`, `bench_e2e`,
  `bench_e2e_multichannel`, `bench_podpipeline`): each passes its check
  and decodes what the reference function decodes on the CPU (blocks
  framed, SQLite aircraft rows, decoded hexes); `bench_sps5` and
  `bench_sharded_resample` at a shrunk block decode what a planar path on
  the CPU decodes;
- `main()` at shrunk module constants: exit 0 and a last line that holds
  every key of the reference's result (the TPU's VPU canary and relay keys
  under their card names) and the port's own.

The reference's `modes_rx` runs with its compile cache under the test's
temporary directory. On the CPU the kernels' launch counters stay at 0.
"""

import ast
import dataclasses
import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

from airmodes.config import DspConfig as JaxCfg
from airmodes.dsp import host as jhost
from airmodes.dsp import pipeline as JP
from airmodes.io import sources as jsources
from airmodes.kernels import preamble_pallas as JK
from airmodes.testing import encoder as jencoder
from airmodes_torch import bench as B
from airmodes_torch.config import DspConfig
from airmodes_torch.dist import sharded
from airmodes_torch.dsp import host as thost
from airmodes_torch.dsp.pipeline import DetectionTable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench.py")
INT_COLS = [0, 1, 2, 3, 5, 6, 7, 8]        # every packed column but noise

_spec = importlib.util.spec_from_file_location("reference_bench", BENCH)
RB = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(RB)

# the reference's result keys that name a TPU quantity, and the port's
# keys for the card's counterpart
RENAMED = {"vpu_util_est": "f32_op_share_est",
           "vpu_ops_per_sample": "b1_ops_per_sample",
           "vpu_util_est_sps5": "f32_op_share_est_sps5",
           "vpu_ops_per_sample_sps5": "b1_ops_per_sample_sps5",
           "streaming_incl_relay_msps": "streaming_incl_h2d_msps"}
PORT_KEYS = {"block_size", "channels", "warm_s", "build_s", "capture_s",
             "spread", "launches", "gates", "ok", "wall_s", "card", "device"}


def _cfgs(**kw):
    jc = JaxCfg(**kw)
    return jc, DspConfig.from_dict(dataclasses.asdict(jc))


def _small():
    return _cfgs(block_size=1 << 16, max_detections=256)


def _truth_rows(truth):
    return [(t.frame, t.nbits, t.sample_index, t.amplitude, t.snr_db, t.sps)
            for t in truth]


def _main_of(tree):
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def _assigns(stmt, name):
    return (isinstance(stmt, ast.Assign)
            and any(getattr(t, "id", None) == name for t in stmt.targets))


def _reference_accounting(arr0, truth, cfg, n_blocks):
    """Run the reference main's decode accounting (from `arr = arr0` up to
    the parse fan-out, and its DF17 count) over `arr0`."""
    with open(BENCH) as f:
        body = _main_of(ast.parse(f.read(), BENCH)).body
    start = next(i for i, s in enumerate(body) if _assigns(s, "arr"))
    stop = next(i for i, s in enumerate(body) if _assigns(s, "density"))
    n17 = next(i for i, s in enumerate(body) if _assigns(s, "n17"))
    mod = ast.Module(body=body[start:stop] + body[n17:n17 + 2],
                     type_ignores=[])
    ns = {"arr0": arr0, "truth": truth, "cfg": cfg, "C": n_blocks,
          "unpack_table": JP.unpack_table, "host": jhost}
    exec(compile(mod, BENCH, "exec"), ns)
    return ns


def _reference_result_keys():
    with open(BENCH) as f:
        body = _main_of(ast.parse(f.read(), BENCH)).body
    result = next(s for s in body if _assigns(s, "result"))
    return [k.value for k in result.value.keys]


@pytest.fixture
def ref_rx(monkeypatch, tmp_path):
    """The reference's modes_rx main with its compile cache moved under
    the test's temporary directory."""
    import airmodes.apps.modes_rx as mr
    orig = mr.main

    def main(argv):
        argv = list(argv)
        if "--compile-cache" in argv:
            argv[argv.index("--compile-cache") + 1] = str(tmp_path / "cc")
        return orig(argv)

    monkeypatch.setattr(mr, "main", main)


def _stderr_counts(err, what):
    m = re.findall(rf"(\d+)/(\d+) {what}", err)
    assert m, err
    return tuple(int(v) for v in m[-1])


# --- captures ----------------------------------------------------------------

def test_build_capture_matches_reference():
    jc, tc = _small()
    xi, xq, truth = B.build_capture(tc, 2)
    rxi, rxq, rtruth = RB.build_capture(jc, 2)
    assert np.array_equal(xi, rxi) and np.array_equal(xq, rxq)
    assert xi.dtype == np.int8 and xi.shape == rxi.shape
    assert _truth_rows(truth) == _truth_rows(rtruth)


def test_write_uc8_capture_matches_reference(tmp_path):
    jc, tc = _small()
    icaos = B.write_uc8_capture(tc, str(tmp_path / "port.uc8"), 2)
    ricaos = RB.write_uc8_capture(jc, str(tmp_path / "ref.uc8"), 2)
    port = (tmp_path / "port.uc8").read_bytes()
    assert port == (tmp_path / "ref.uc8").read_bytes()
    assert len(port) == 2 * 2 * tc.block_size
    assert icaos == ricaos and len(icaos) > 0


# --- the step and the decode accounting --------------------------------------

@pytest.mark.parametrize("n, rate_hz", [(4, 100.0), (4, 2000.0),
                                        (8, 3000.0)])
def test_step_and_accounting_match_reference(n, rate_hz):
    """The capture at the bench's traffic rate and at 20-30x it (every DF,
    crowded tiles: frames missed, at 3000 msg/s one spurious frame of
    status addr): the same packed tables, and the same per-DF and spurious
    counts."""
    jc, tc = _small()
    xi, xq, truth = B.build_capture(tc, n, msg_rate_hz=rate_hz)
    name, step, arr = B.pick_step(tc, xi, xq, device="cpu")
    assert name == "plain-planar-i8"
    want = np.asarray(JK.demod_batch_packed_planar_jit(xi, xq, jc,
                                                       interpret=True))
    np.testing.assert_array_equal(arr[..., INT_COLS], want[..., INT_COLS])
    np.testing.assert_allclose(arr[..., :-1, 4].view(np.float32),
                               want[..., :-1, 4].view(np.float32), rtol=1e-5)
    np.testing.assert_array_equal(arr[..., -1, 4], want[..., -1, 4])

    acc = B.account(arr, truth, tc)
    ref = _reference_accounting(want, truth, jc, n)
    assert acc["decoded_by_df"] == ref["df_decode"]
    assert acc["spurious"] == ref["spurious"]
    assert acc["missing"] == ref["missing"]
    assert acc["spurious_by_status"] == ref["spurious_by_status"]
    assert acc["df_ok"] == ref["df_ok"]
    assert [acc["df17_injected"], acc["df17_missed"]] == ref["n17"]
    assert acc["msgs"] == ref["msgs"]
    if rate_hz > 100.0:
        assert len(acc["decoded_by_df"]) == 9 and len(acc["got"]) > 200
        assert acc["missing"] + acc["spurious"] > 0


# --- the figures that decode -------------------------------------------------

@pytest.fixture
def uc8(tmp_path):
    jc, tc = _small()
    path = str(tmp_path / "cap.uc8")
    icaos = B.write_uc8_capture(tc, path, 4)
    return jc, tc, path, icaos


def test_host_only_frames_every_block(uc8):
    jc, tc, path, _ = uc8
    fig = B.bench_host_only(tc, path, 4)
    assert fig.ok and fig.decoded == 4 and len(fig.runs) == 3
    assert fig.value == max(fig.runs)
    assert RB.bench_host_only(jc, path, 4) > 0      # its own block assert
    with pytest.raises(AssertionError):             # a wrong count fails it
        RB.bench_host_only(jc, path, 5)
    assert not B.bench_host_only(tc, path, 5).ok


def test_e2e_matches_reference(uc8, ref_rx, capsys):
    jc, tc, path, icaos = uc8
    fig = B.bench_e2e(tc, path, icaos, n_blocks=4, n_runs=2, device="cpu")
    _, ok = RB.bench_e2e(jc, path, icaos, n_blocks=4)
    rows, injected = _stderr_counts(capsys.readouterr().err,
                                    "aircraft in DB")
    assert fig.ok and ok
    assert fig.injected == icaos
    assert (fig.decoded, len(fig.injected)) == (rows, injected) == \
        (len(icaos), len(icaos))
    assert len(fig.runs) == 2 and fig.launches == {"B1": 0, "B2": 0}


def test_e2e_multichannel_matches_reference(ref_rx, capsys):
    jc, tc = _small()
    fig = B.bench_e2e_multichannel(tc, n_channels=2, n_blocks=2, n_runs=1,
                                   device="cpu")
    capsys.readouterr()
    _, ok = RB.bench_e2e_multichannel(jc, n_channels=2, n_blocks=2)
    rows, injected = _stderr_counts(capsys.readouterr().err,
                                    "aircraft in DB")
    assert fig.ok and ok and fig.capture_s > 0
    assert (fig.decoded, len(fig.injected)) == (rows, injected)


def test_podpipeline_matches_reference(monkeypatch):
    """The port's f32 pipeline on the CPU decodes the reference's set (the
    first stream's 3 steps), and rates the interior steps."""
    from airmodes.dist.multihost import PodPipeline as JPod
    seen = []
    orig = JPod.run_stream

    def run_stream(self, *a, **kw):
        for msgs in orig(self, *a, **kw):
            seen.append(msgs)
            yield msgs

    monkeypatch.setattr(JPod, "run_stream", run_stream)
    jc, tc = _small()
    fig = B.bench_podpipeline(tc, n_steps=6, device="cpu")
    _, ok = RB.bench_podpipeline(jc, n_steps=6)
    ref_got = {m.split()[1] for msgs in seen[:3] for m in msgs}
    assert fig.ok and ok
    assert fig.decoded == ref_got and len(ref_got) >= 8
    assert len(fig.runs) == 2 and min(fig.runs) <= fig.value <= \
        max(fig.runs)


def test_sps5_matches_reference_planar():
    """10 Msps at a block of 2^16: the port's figure decodes what the
    reference's planar step (interpret mode) decodes from the reference's
    own int8 rows, built as its bench_sps5 builds them."""
    block, channels, seed = 1 << 16, 2, 100
    fig = B.bench_sps5(n_runs=1, block_size=block, channels=channels,
                       reps=2, iters=2, device="cpu")
    cfg5 = JaxCfg(channel_rate=10e6, block_size=block, max_detections=256)
    P = JK.planar_length(cfg5)
    xi = np.zeros((channels, P), np.int8)
    xq = np.zeros((channels, P), np.int8)
    want = set()
    for k in range(channels):
        frames = jencoder.random_df17_frames(42, seed=seed + k)
        iq, truth = jencoder.make_capture(
            frames, rate=10e6, snr_db=15.0, spacing=block // 43,
            seed=seed + k, total_samples=block)
        want |= {t.hex for t in truth}
        b, _ = next(jsources.frame_blocks(iq, cfg5))
        x2 = np.stack([b.real, b.imag], -1)
        b8 = np.clip(np.round(x2 / float(np.abs(x2).max()) * 120), -127,
                     127).astype(np.int8)
        pi, pq = JK.to_planar_i8(b8, cfg5)
        xi[k], xq[k] = pi[0], pq[0]
    arr = np.asarray(JK.demod_batch_packed_planar_jit(xi, xq, cfg5,
                                                      interpret=True))
    got = {m.split()[1] for k in range(channels)
           for m in jhost.table_to_messages(JP.unpack_table(arr[k]),
                                            k * block, 10e6)}
    assert fig.ok and fig.decoded == got
    assert fig.injected == want and len(want) == 84
    assert len(got & want) >= 83


def test_sharded_resample_matches_planar_path():
    """On the CPU the figure takes the f32 path; it decodes what the planar
    path (group matmuls, int8 quantize, plain B1/B2) decodes on the CPU."""
    block, seed = 1 << 15, 55
    fig = B.bench_sharded_resample(seed=seed, block_size=block, channels=2,
                                   R=2, iters=2, n_runs=1, device="cpu")
    cfgr = DspConfig(channel_rate=4e6, block_size=block, max_detections=64)
    raw = block * 3 // 2
    from airmodes_torch.testing import encoder
    iq, truth = encoder.make_capture(
        encoder.random_df17_frames(24, seed=seed), rate=6e6, snr_db=25.0,
        spacing=raw // 25, seed=seed, total_samples=raw)
    mesh = sharded.make_mesh(1, 1, device="cpu")
    fn = sharded.make_sharded_resample_demod(mesh, cfgr, 2, 3, planar=True)
    gain = float(np.float32(120.0 / float(np.abs(iq).max())))
    x = torch.from_numpy(np.stack([iq.real, iq.imag]).astype(np.float32)[None])
    table = fn(x, gain)
    sub = DetectionTable(*(f.numpy()[0, 0] for f in table))
    got = {m.split()[1] for m in thost.table_to_messages(
        sub, 0, 4e6, full_scale=gain / 127.0)}
    assert fig.ok and fig.decoded == got == fig.injected
    assert fig.injected == {t.hex for t in truth} and len(fig.runs) == 1


def test_device_and_streaming_loops_check_their_tables():
    _, tc = _small()
    xi, xq, _ = B.build_capture(tc, 2)
    _, step, arr = B.pick_step(tc, xi, xq, device="cpu")
    for sync_sum in (True, False):
        fig = B.bench_device(step, tc, xi, xq, arr, 2, n_runs=2, iters=2,
                             sync_sum=sync_sum, device="cpu")
        assert fig.ok and len(fig.runs) == 2
        bad = arr.copy()
        bad[0, 0, 0] += 1
        assert not B.bench_device(step, tc, xi, xq, bad, 2, n_runs=1,
                                  iters=1, sync_sum=sync_sum,
                                  device="cpu").ok
    assert B.bench_streaming(step, tc, xi, xq, arr, iters=2, n_runs=2,
                             device="cpu").ok
    assert B.h2d_control(xi, xq, tc.block_size, device="cpu").ok


# --- main --------------------------------------------------------------------

def test_main_on_the_cpu(monkeypatch, capsys):
    for name, value in (("C", 2), ("BLOCK", 1 << 16), ("REPS", 1),
                        ("E2E_BLOCKS", 4), ("POD_BLOCK", 1 << 16)):
        monkeypatch.setattr(B, name, value)
    assert B.main(["--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    result = json.loads(last)
    want = {RENAMED.get(k, k) for k in _reference_result_keys()} | PORT_KEYS
    assert set(result) == want
    assert result["ok"] and all(result["gates"].values())
    assert result["kernel"] == "plain-planar-i8"
    assert result["batch_blocks"] == 2 and result["card"] is None
    assert result["device"] == {"platform": "cpu", "kind": "cpu",
                                "count": 1}
    assert all(lo <= mid <= hi for lo, mid, hi in result["spread"].values())


@pytest.mark.parametrize("call", [
    lambda: B.main(["--device", "cuda"]),
    lambda: B.main([]),
    lambda: B.pick_step(DspConfig(), None, None),
    lambda: B.bench_sps5(),
    lambda: B.bench_sharded_resample(),
    lambda: B.bench_podpipeline(DspConfig()),
    lambda: B.bench_e2e(DspConfig(), "unused.uc8", set()),
    lambda: B.bench_e2e_multichannel(DspConfig()),
    lambda: B.h2d_control(None, None, 1),
], ids=["main --device cuda", "main", "pick_step", "bench_sps5",
        "bench_sharded_resample", "bench_podpipeline", "bench_e2e",
        "bench_e2e_multichannel", "h2d_control"])
def test_the_card_is_the_default_and_is_required(call):
    if torch.cuda.is_available():
        pytest.skip("a card is present: these calls would run the bench")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
