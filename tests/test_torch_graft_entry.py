"""The port's graft entry points (`airmodes_torch.graft_entry`) against the
reference's (`__graft_entry__.py`, on conftest's 8-device CPU mesh, its
planar steps in Pallas interpret mode).

The contract (ROADMAP "Parity contract"): every int32 column of a table
exact, `noise` within rtol 1e-5 on the planar steps and 1e-4 on the
full-block ones, messages string for string. The reference draws its
inputs randomly and checks shapes only; the tests record each of its steps'
inputs and outputs by wrapping its `make_sharded_*` factories and
`PodPipeline.run_stream` with monkeypatch, so that the draw order, the
composition and every table are held, not only the shapes.

Several processes: this file is also the worker of the 2-rank gloo run
(`python tests/test_torch_graft_entry.py <host:port> <world> <rank>
<out.pkl>`), which runs `_dryrun_steps(8, device="cpu")` on its run of
the (1, 8) mesh and pickles its steps' outputs. A worker imports no JAX.
"""

import contextlib
import importlib.util
import io
import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from airmodes_torch import graft_entry
from airmodes_torch.dist import sharded
from airmodes_torch.dsp.pipeline import DetectionTable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DEVICES = [1, 2, 6, 8]
# the reference's factories the dry run calls, by the port's step names
FACTORIES = ("make_sharded_demod", "make_sharded_demod_planar",
             "make_sharded_demod_planar_ctx", "make_sharded_resample_demod")


def _reference():
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record_reference(n_devices):
    """Run the reference's dryrun_multichip(n_devices) with its steps
    recorded: [(name, host inputs, host outputs)], and its printed
    lines."""
    import jax
    from airmodes.dist import multihost as jmultihost
    from airmodes.dist import sharded as jsharded
    steps = []
    mp = pytest.MonkeyPatch()

    def host(x):
        return jax.tree.map(np.asarray, x)

    def wrap(name, orig):
        def factory(*a, **kw):
            fn = orig(*a, **kw)
            label = name + ("(planar=True)" if kw.get("planar") else "")

            def step(*args):
                out = fn(*args)
                # PodPipeline's jitted steps call the factories' steps on
                # tracers; run_stream's wrapper records those
                if not any(isinstance(x, jax.core.Tracer) for x in args):
                    steps.append((label, tuple(host(x) for x in args),
                                  host(out)))
                return out
            return step
        return factory

    def run_stream(self, chunks, *a, **kw):
        chunks = list(chunks)
        outs = list(orig_stream(self, iter(chunks), *a, **kw))
        name = ("PodPipeline(planar=True).run_stream" if self.planar
                else "PodPipeline.run_stream")
        steps.append((name, tuple(chunks), outs))
        return iter(outs)

    orig_stream = jmultihost.PodPipeline.run_stream
    with mp.context() as m:
        for name in FACTORIES:
            m.setattr(jsharded, name, wrap(name, getattr(jsharded, name)))
        m.setattr(jmultihost.PodPipeline, "run_stream", run_stream)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _reference().dryrun_multichip(n_devices)
    return steps, buf.getvalue().splitlines()


def _run_port(n_devices):
    """The port's dryrun_multichip(n_devices, "cpu"): its steps and its
    printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        steps = graft_entry.dryrun_multichip(n_devices, device="cpu")
    return steps, buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def runs():
    """Each package's dry run by n_devices, run once per module."""
    cache = {}

    def get(who, n):
        if (who, n) not in cache:
            cache[who, n] = (_record_reference(n) if who == "reference"
                             else _run_port(n))
        return cache[who, n]
    return get


def _same_table(got, want, noise_rtol, what):
    for name, g, w in zip(DetectionTable._fields, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        if name == "noise":
            np.testing.assert_allclose(g, w, rtol=noise_rtol,
                                       err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype),
                                          err_msg=f"{what} {name}")


def _noise_rtol(name):
    """1e-5 on the planar steps, 1e-4 on the full-block ones."""
    return 1e-5 if "planar" in name else 1e-4


def test_entry_matches_reference():
    """entry()'s step on the CPU against the reference's jitted entry()
    step, on the same example block."""
    import jax
    rfn, (riq,) = _reference().entry()
    want = jax.jit(rfn)(riq)
    fn, (iq,) = graft_entry.entry(device="cpu")
    np.testing.assert_array_equal(iq, riq)
    assert iq.dtype == riq.dtype == np.float32
    assert fn.keywords["cfg"] == graft_entry._tiny_cfg(1 << 15, 32)
    got = fn(iq)
    _same_table(DetectionTable(*(f.numpy() for f in got)), want, 1e-4,
                "entry")
    assert {k: tuple(v.shape) for k, v in got._asdict().items()} == \
        {k: tuple(np.shape(v)) for k, v in want._asdict().items()}


def test_entry_step_decodes_frames_like_reference():
    """The example block is noise and detects nothing in either package:
    entry()'s step again on a block of its shape holding DF17 frames,
    against the reference's jitted step on the same block; every frame
    decodes."""
    import jax
    from airmodes.testing import encoder
    from airmodes_torch.dsp import host
    rfn, (riq,) = _reference().entry()
    fn, _ = graft_entry.entry(device="cpu")
    cfg = fn.keywords["cfg"]
    iq, truth = encoder.make_capture(encoder.random_df17_frames(6, seed=16),
                                     snr_db=20.0, spacing=4000,
                                     start=cfg.left_halo + 500, seed=16,
                                     total_samples=riq.shape[0])
    block = np.stack([iq.real, iq.imag], -1).astype(np.float32)
    assert block.shape == riq.shape
    want = jax.jit(rfn)(block)
    got = DetectionTable(*(f.numpy() for f in fn(block)))
    _same_table(got, want, 1e-4, "entry with frames")
    msgs = host.table_to_messages(got, 0, cfg.channel_rate)
    assert int(got.n_detected) >= len(truth)
    assert {t.hex for t in truth} <= {m.split()[1] for m in msgs}


@pytest.mark.parametrize("n_devices", N_DEVICES,
                         ids=[f"{n} devices" for n in N_DEVICES])
def test_dryrun_steps_match_reference(runs, n_devices):
    """_dryrun_steps on the (1, 1), (1, 2), (3, 2) and (1, 8) meshes: the
    same steps in the same order, each on the reference's inputs (the
    draw order), with its tables and messages; the printed line is the
    reference's. On the CPU no hand kernel launches."""
    want, want_lines = runs("reference", n_devices)
    got, got_lines = runs("port", n_devices)
    assert [s.name for s in got] == [w[0] for w in want]
    assert len(got) == 7
    for s, (name, w_in, w_out) in zip(got, want):
        assert len(s.inputs) == len(w_in), name
        for a, b in zip(s.inputs, w_in):
            assert np.asarray(a).dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        if isinstance(s.outputs, DetectionTable):
            _same_table(s.outputs, w_out, _noise_rtol(name), name)
        else:
            assert s.outputs == w_out, name
            assert len(s.outputs) == 2
        assert not any(s.launches.values()), (name, s.launches)
    assert got_lines == want_lines
    assert got_lines[0].startswith("dryrun_multichip OK: mesh=(")


PLANAR_STEPS = ("make_sharded_demod_planar", "make_sharded_demod_planar_ctx")


@pytest.mark.parametrize("step", PLANAR_STEPS)
def test_dryrun_planar_steps_decode_frames_like_reference(step):
    """The dry run's inputs are noise, and its planar tables hold no
    detection in either package: its planar steps again at its (1, 8)
    mesh and config, on a block holding 32 DF17 frames, against the
    reference's steps on the same int8 block; every frame decodes."""
    import jax
    from airmodes.config import DspConfig as RefConfig
    from airmodes.dist import sharded as jsharded
    from airmodes.testing import encoder
    from airmodes_torch.config import DspConfig
    from airmodes_torch.dsp import host
    n_channel, n_time = graft_entry._mesh_shape(8)
    pcfg = DspConfig(block_size=4096, max_detections=16)
    total = n_time * pcfg.block_size
    iq, truth = encoder.make_capture(encoder.random_df17_frames(32, seed=21),
                                     snr_db=20.0, spacing=999, start=603,
                                     seed=21, total_samples=total)
    assert len(truth) == 32
    gain = 120.0 / float(np.max(np.abs(iq)))
    xi, xq = (np.tile(host.quantize_i8_np(v, gain)[None], (n_channel, 1))
              for v in (iq.real, iq.imag))
    ctx = () if step == "make_sharded_demod_planar" else (
        np.zeros((n_channel, pcfg.left_halo), np.int8),) * 2 + (
        np.zeros((n_channel, pcfg.right_halo), np.int8),) * 2
    jmesh = jsharded.make_mesh(n_channel=n_channel, n_time=n_time)
    jfn = getattr(jsharded, step)(
        jmesh, RefConfig(block_size=4096, max_detections=16))
    want = jax.block_until_ready(
        jfn(*jsharded.shard_input_planar(xi, xq, jmesh), *ctx))
    mesh = sharded.make_mesh(n_channel, n_time, None, "cpu")
    got = getattr(sharded, step)(mesh, pcfg)(
        *sharded.shard_input_planar(xi, xq, mesh), *ctx)
    got = DetectionTable(*(f.numpy() for f in got))
    _same_table(got, want, 1e-5, step)
    hexes = set()
    for c in range(n_channel):
        for t in range(n_time):
            shard = DetectionTable(*(f[c, t] for f in got))
            hexes |= {m.split()[1] for m in host.table_to_messages(
                shard, 0, pcfg.channel_rate)}
    assert {t.hex for t in truth} <= hexes


def test_multiprocess_check_refuses_the_card(monkeypatch):
    """GRAFT_MULTIPROCESS=1's workers are CPU processes on gloo: the dry
    run asked for the card refuses the check before it runs a step, and a
    worker refuses --device cuda."""
    monkeypatch.setenv("GRAFT_MULTIPROCESS", "1")
    monkeypatch.setattr(graft_entry, "_dryrun_steps", None)
    with pytest.raises(ValueError, match="CPU worker processes on gloo"):
        graft_entry.dryrun_multichip(1, device="cuda")
    with pytest.raises(SystemExit) as exc:
        graft_entry.main(["--worker", "127.0.0.1:1", "2", "0", "--device",
                          "cuda"])
    assert exc.value.code == 2


def test_dryrun_steps_mesh_shapes():
    """The factorisation: time 8, 4 or 2 ways where that divides."""
    assert [graft_entry._mesh_shape(n) for n in (1, 2, 3, 4, 6, 8, 12, 16)] \
        == [(1, 1), (1, 2), (3, 1), (1, 4), (3, 2), (1, 8), (3, 4), (2, 8)]


# --- a 2-rank gloo group -----------------------------------------------------

def _worker(argv) -> int:
    from airmodes_torch.dist import multihost
    import torch.distributed as dist
    coord, world, rank, path = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    multihost.initialize(coord, world, rank, device="cpu")
    try:
        steps = graft_entry._dryrun_steps(8, device="cpu")
        with open(path, "wb") as f:
            pickle.dump([(s.name, s.outputs) for s in steps], f)
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_ranks_union_matches_one_process(runs, tmp_path):
    """_dryrun_steps(8) in a 2-rank gloo group: each rank's tables are its
    run of the (1, 8) mesh, and the ranks' shards together equal the
    one-process run's tables; the union of the ranks' run_stream messages
    equals the one-process run's, with no duplicate."""
    world = 2
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    paths = [str(tmp_path / f"rank{r}.pkl") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), coord, str(world),
         str(r), paths[r]], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=env, text=True) for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=150)
            assert p.returncode == 0, f"worker failed:\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = []
    for path in paths:
        with open(path, "rb") as f:
            ranks.append(pickle.load(f))
    one, _ = runs("port", 8)
    cpu = torch.device("cpu")
    for i, s in enumerate(one):
        if isinstance(s.outputs, DetectionTable):
            full = [np.zeros_like(f) for f in s.outputs]
            for r, rank in enumerate(ranks):
                name, table = rank[i]
                assert name == s.name
                mesh = sharded.Mesh(1, 8, None, cpu, r, world)
                assert table.index.shape[:2] == mesh.local_shape == (1, 4)
                c, t = mesh.channels, mesh.times
                for dst, src in zip(full, table):
                    dst[c.start:c.stop, t.start:t.stop] = src
            _same_table(full, s.outputs, 0.0, s.name)
        else:
            assert [len(rank[i][1]) for rank in ranks] == [2, 2]
            for k in range(2):
                union = [m for rank in ranks for m in rank[i][1][k]]
                assert len(union) == len(set(union)), s.name
                assert sorted(union) == sorted(s.outputs[k]), s.name


# --- the multi-process check -------------------------------------------------

def _reference_workers():
    """Start tests/mp_worker.py, the reference's workers of the same
    check (jax.distributed, 4 virtual CPU devices each)."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "mp_worker.py"), coord,
         "2", str(pid)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=env, text=True) for pid in range(2)]


def test_dryrun_multiprocess_matches_reference_workers(monkeypatch):
    """dryrun_multichip(8, "cpu") under GRAFT_MULTIPROCESS=1 returns
    normally and prints the reference's two lines; its two gloo workers'
    messages equal the reference workers' (tests/mp_worker.py), rank for
    rank, string for string: no duplicate, every truth frame decoded."""
    ref_procs = _reference_workers()
    try:
        seen = []
        orig = graft_entry._multiprocess

        def spy():
            out = orig()
            seen.append(out)
            return out

        monkeypatch.setattr(graft_entry, "_multiprocess", spy)
        monkeypatch.setenv("GRAFT_MULTIPROCESS", "1")
        _, lines = _run_port(8)
        ref = []
        for p in ref_procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"reference worker:\n{err[-4000:]}"
            ref.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in ref_procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ref.sort(key=lambda o: o["pid"])
    (per_proc, want), = seen
    assert want == ref[0]["want"]
    assert per_proc == [o["msgs"] for o in ref]
    assert all(per_proc)
    union = [m for msgs in per_proc for m in msgs]
    assert len(union) == len(set(union))
    assert set(want) <= {m.split()[1] for m in union}
    assert lines[1] == (f"dryrun multiprocess OK: 2 procs, {len(union)} "
                        f"msgs, {len(want)} truth decoded")


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry._dryrun_steps(8)


def test_main_on_the_cpu(runs):
    """`python -m airmodes_torch.graft_entry --device cpu`: exit 0, the
    entry table's shapes, then the reference's dryrun line of one
    device."""
    out = subprocess.run(
        [sys.executable, "-m", "airmodes_torch.graft_entry", "--device",
         "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    _, want_lines = runs("reference", 1)
    assert lines[0].startswith("entry OK: {'index': (32,)")
    assert lines[1:] == want_lines


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1:]))
