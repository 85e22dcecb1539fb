"""The probes of the PyTorch port (`airmodes_torch/probes/`) against the
Pallas kernels of the TPU scripts they replace.

The scripts in `scripts/` measure as they are imported (they put a 1 GiB
array, or hundreds of MB of samples, on the device at module level and
time it), so they cannot be imported here. Each test lifts the named
`def` nodes out of a script's source with `ast` and executes only those,
into a namespace that holds the globals they read (sizes cut small), a
`pl` whose `pallas_call` adds `interpret=True`, and the returns' slicing
dropped (on the TPU a small slice was fetched to synchronise). The port
runs its kernels' plain versions on the CPU. Inputs are made with numpy
from fixed seeds and handed to both.
"""

import ast
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from airmodes.config import DspConfig as JaxCfg
from airmodes.constants import PREAMBLE_PULSE_CHIPS, PREAMBLE_QUIET_CHIPS
from airmodes.dsp import pipeline as JP
from airmodes.io import sources
from airmodes.kernels import preamble_pallas as JK
from airmodes.testing import encoder
from airmodes_torch.config import DspConfig
from airmodes_torch.kernels import opcount
from airmodes_torch.kernels import preamble as TK
from airmodes_torch.probes import bw_probe as BW
from airmodes_torch.probes import kernel_ablate as KA
from airmodes_torch.probes import unordered_stage_probe as US

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")


class _StripSlice(ast.NodeTransformer):
    """`return y[::a, ::b]` (or a tuple of such) -> `return y`."""

    def visit_Return(self, node):
        def strip(e):
            return e.value if isinstance(e, ast.Subscript) else e
        if isinstance(node.value, ast.Tuple):
            node.value.elts = [strip(e) for e in node.value.elts]
        elif node.value is not None:
            node.value = strip(node.value)
        return node


class _InterpretPl:
    """`pl` as the scripts use it, with pallas_call in interpret mode."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kw):
        return pl.pallas_call(*args, interpret=True, **kw)


def _load(script, names, **globals_):
    """The named top-level functions of scripts/<script>, executed alone
    into a namespace of `globals_` (plus jax, jnp, pl, pltpu)."""
    path = os.path.join(SCRIPTS, script)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    nodes = [_StripSlice().visit(n) for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name in names]
    assert {n.name for n in nodes} == set(names)
    mod = ast.fix_missing_locations(ast.Module(body=nodes, type_ignores=[]))
    ns = dict(jax=jax, jnp=jnp, pl=_InterpretPl(), pltpu=pltpu,
              functools=functools, np=np, **globals_)
    exec(compile(mod, path, "exec"), ns)
    return ns


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- P1-P3: scripts/tpu_bw_probe.py ------------------------------------------

ROWS = 4096          # 28 windows of 144 rows; the last 64 rows are not read
READ_FNS = ("pallas_dma_read", "pallas_dma2_read")
# P2 and P3 beyond ROWS: 6 windows (fewer than the card's SMs) and 3
# windows with a 77-row tail
READ_CASES = [pytest.param(fn, ROWS, id=fn) for fn in READ_FNS] + [
    pytest.param(fn, rows, id=f"{fn}-{rows}") for rows in (1000, 144 * 3 + 77)
    for fn in READ_FNS]


@functools.lru_cache(maxsize=None)
def _bw_script(rows):
    return _load("tpu_bw_probe.py",
                 ["copy_kernel", "pallas_copy", "dma_kernel",
                  "pallas_dma_read", "dma2_kernel", "pallas_dma2_read"],
                 ROWS=rows, LANES=BW.LANES, TROWS=1024, WROWS=BW.WROWS)


def _bw_input(rows):
    return np.random.default_rng(0).standard_normal(
        (rows, BW.LANES)).astype(np.float32)


@pytest.fixture(scope="module")
def bw():
    return _bw_script(ROWS), _bw_input(ROWS)


def test_copy_plain_equals_copy_kernel(bw):
    """P1: x + 1, exactly."""
    ns, x = bw
    want = np.asarray(ns["pallas_copy"](x))
    got = BW.copy(_t(x))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(BW.copy_plain(_t(x)).numpy(), want)


@pytest.mark.parametrize("fn, rows", READ_CASES)
def test_read_plain_matches_dma_kernels(fn, rows):
    """P2 and P3: each window's column sums on its 8 output rows, to rtol
    1e-5 (XLA sums the window in another order than the port's row
    order). Rows past the last whole window are read by neither side:
    NaN there changes nothing."""
    ns, x = _bw_script(rows), _bw_input(rows)
    steps = rows // BW.WROWS
    want = np.asarray(ns[fn](x))
    got = BW.dma2_read(_t(x)) if fn == "pallas_dma2_read" else \
        BW.dma_read(_t(x))
    assert got.shape == want.shape == (steps * 8, BW.LANES)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    tail = x.copy()
    tail[steps * BW.WROWS:] = np.nan
    np.testing.assert_array_equal(np.asarray(ns[fn](tail)), want)
    np.testing.assert_array_equal(BW.read_plain(_t(tail)).numpy(),
                                  got.numpy())


def test_read_plain_sums_in_row_order():
    """The plain version's sums are the row-order f32 sums the kernels
    take, bit for bit."""
    x = np.random.default_rng(1).standard_normal(
        (2 * BW.WROWS + 5, BW.LANES)).astype(np.float32)
    want = np.empty((2, BW.LANES), np.float32)
    for w in range(2):
        s = x[w * BW.WROWS].copy()
        for r in range(1, BW.WROWS):
            s = (s + x[w * BW.WROWS + r]).astype(np.float32)
        want[w] = s
    got = BW.read_plain(_t(x)).numpy().reshape(2, 8, BW.LANES)
    np.testing.assert_array_equal(got, np.repeat(want[:, None], 8, axis=1))


def test_window_sums_is_the_windows_column_sums():
    """The yardstick of P2 and P3 sums each window's columns (in
    PyTorch's order, so to rtol 1e-5) and reads no row past the last
    whole window."""
    x = _bw_input(144 * 3 + 77)
    x[3 * BW.WROWS:] = np.nan
    got = BW.window_sums(_t(x)).numpy()
    assert got.shape == (3, BW.LANES)
    want = BW.read_plain(_t(x)).numpy()[::BW.OUT_ROWS]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


SMS = 132                              # an H100 SXM's SMs
GEOMETRY_ROWS = [BW.ROWS, BW.ROWS - 3, 1000, 100]


@pytest.mark.parametrize("rows", GEOMETRY_ROWS)
def test_ring_geometry_fits_and_walks_every_window_once(rows):
    """P3's launch geometry fits a CTA's 232,448 bytes of shared memory
    (the ring after its barriers and slot windows), and the kernel's walk
    reads every window once. Its pipelines (RING_GROUPS per CTA) draw
    tickets from one counter in whatever order the card runs them (here a
    seeded random one); each ends on its first ticket past the last
    window, and its half-windows j (two per window, then the end at the
    next even j) fill slot j % per of its own ring as fill j // per, so
    each slot's fills come in order (one parity bit names a barrier's
    phase). At 100 rows no window is drawn."""
    grid, stages, smem = BW.ring_geometry(rows, SMS)
    steps = BW.windows(rows)
    assert smem <= 232_448 == BW.SMEM_PER_CTA
    assert smem >= BW.RING_OFFSET + stages * BW.HALF_BYTES
    assert stages * (2 * 8 + 4) <= BW.RING_OFFSET
    groups = BW.RING_GROUPS
    per = stages // groups
    assert stages % groups == 0 and per >= 2
    assert grid == max(1, min(steps, SMS))
    pipes = grid * groups
    rng = np.random.default_rng(rows)
    taken = [[] for _ in range(pipes)]
    live, ticket = list(range(pipes)), 0
    while live:
        p = live[rng.integers(len(live))]
        taken[p].append(ticket)
        ticket += 1
        if taken[p][-1] >= steps:
            live.remove(p)
    assert ticket == steps + pipes
    assert sorted(w for t in taken for w in t[:-1]) == list(range(steps))
    for p, t in enumerate(taken):
        g = p % groups
        fills = {}
        for j in range(2 * len(t) - 1):
            fills.setdefault(g * per + j % per, []).append(j // per)
        for slot, got in fills.items():
            assert slot // per == g and got == list(range(len(got)))


def _copy_walk(length):
    """How often the P1 kernel's threads touch each float4 of a CTA whose
    span holds `length` of them."""
    hits = np.zeros(length, np.int64)
    for tid in range(BW.COPY_THREADS):
        hits[tid:length:BW.COPY_THREADS] += 1
    return hits


@pytest.mark.parametrize("rows", GEOMETRY_ROWS)
def test_copy_geometry_walks_every_float4_once(rows):
    """P1's spans tile the array's float4s, every CTA has some, the grid
    fits a launch, and the kernel's walk of a full span and of the last
    (cut) span touches each float4 once."""
    span4, grid = BW.copy_geometry(rows)
    n4 = rows * BW.LANES // 4
    assert span4 % BW.COPY_THREADS == 0
    assert (grid - 1) * span4 < n4 <= grid * span4
    assert grid < 2 ** 31
    assert (_copy_walk(span4) == 1).all()
    assert (_copy_walk(n4 - (grid - 1) * span4) == 1).all()


# --- P4: scripts/tpu_kernel_ablate.py ----------------------------------------

AB_C, AB_TILE = 2, 16384


@pytest.fixture(scope="module")
def ablate():
    """The script's `make` at C = 2, blocks of 2^15, tile 16384, and two
    int8 blocks of DF17 traffic at 15 dB."""
    jc = JaxCfg(block_size=1 << 15, max_detections=256)
    tc = DspConfig.from_dict(dataclasses.asdict(jc))
    ns = _load("tpu_kernel_ablate.py", ["body", "make"], cfg=jc, C=AB_C,
               TILE=AB_TILE, _LOOKBACK=JK._LOOKBACK, _HALO_R2=JK._HALO_R2,
               _shift2d=JK._shift2d, PREAMBLE_PULSE_CHIPS=PREAMBLE_PULSE_CHIPS,
               PREAMBLE_QUIET_CHIPS=PREAMBLE_QUIET_CHIPS)
    frames = encoder.random_df17_frames(40, seed=9)
    iq, _ = encoder.make_capture(frames, snr_db=15.0, spacing=1500, seed=9)
    blocks = [JP.iq_to_device_layout(b) for b, _ in
              sources.frame_blocks(iq, jc)][:AB_C]
    x = np.stack(blocks)
    x = x / np.float32(np.max(np.abs(x)) * 1.05)
    iq8 = np.clip(np.round(x * 127.0), -127, 127).astype(np.int8)
    return ns, jc, tc, iq8


@pytest.mark.parametrize("stages", KA.STAGES)
def test_ablate_plain_matches_body(ablate, stages):
    """Each cut's plain version == the script's kernel cut after the same
    stage: mask and ref exact (int8 in, the int8 -> f32 pass on both
    sides)."""
    ns, jc, tc, iq8 = ablate
    mask, ref = (np.asarray(a).reshape(AB_C, -1)
                 for a in ns["make"](stages)(iq8))
    got = KA.ablate(_t(iq8), tc, stages, AB_TILE)
    np.testing.assert_array_equal(got[0].numpy(), mask)
    np.testing.assert_array_equal(got[1].numpy().view(np.int32),
                                  ref.view(np.int32))
    if stages >= 3:
        assert 0 < mask.sum() < mask.size // 100


def test_ablate_stage5_is_b4(ablate):
    """The full cut is kernel B4: equal to the port's B4 plain version and
    to the reference's `preamble_detect_pallas_2d_batch`."""
    ns, jc, tc, iq8 = ablate
    got = KA.ablate(_t(iq8), tc, 5, AB_TILE)
    b4 = TK.detect_mask_plain(*TK.b4_operands(_t(iq8), tc, AB_TILE), tc)
    want = JK.preamble_detect_pallas_2d_batch(iq8, jc, tile=AB_TILE,
                                              interpret=True)
    for g, p, w in zip(got, b4, want):
        np.testing.assert_array_equal(g.numpy(), p.numpy())
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].sum() >= 20


def test_ablate_takes_the_sps1_rule_only():
    cfg = DspConfig(channel_rate=4e6, block_size=1 << 15)
    x = torch.zeros((1, cfg.left_halo + cfg.block_size + cfg.right_halo, 2))
    with pytest.raises(ValueError, match="sps-1"):
        KA.ablate(x, cfg, 5, AB_TILE)
    with pytest.raises(ValueError, match="stages"):
        KA.ablate(x, KA.probe_config(1 << 15), 6, AB_TILE)


def test_ablate_input_is_the_scripts():
    """make_input draws, a channel at a time, what the script draws at
    once from one generator."""
    cfg = KA.probe_config(1 << 12)
    n_in = cfg.left_halo + cfg.block_size + cfg.right_halo
    rng = np.random.default_rng(0)
    want = (rng.standard_normal((3, n_in, 2)) * 0.05 * 127).astype(np.int8)
    np.testing.assert_array_equal(KA.make_input(cfg, 3), want)


# --- P5: scripts/tpu_unordered_stage_probe.py --------------------------------

FL_C, FL_TILE = 2, 65536


@pytest.fixture(scope="module")
def floor():
    """The script's `step_floor` at blocks of 2^17, tile 65536, NBUF 2, C
    = 2, on independent random int8 rows."""
    jc = JaxCfg(block_size=1 << 17, max_detections=256)
    tc = DspConfig.from_dict(dataclasses.asdict(jc))
    ns = _load("tpu_unordered_stage_probe.py",
               ["_floor_kernel", "step_floor"], cfg=jc, TILE=FL_TILE,
               NBUF=2, CAND_ROWS=JK.CAND_ROWS,
               _planar_geometry=JK._planar_geometry)
    p = JK.planar_length(jc, FL_TILE)
    rng = np.random.default_rng(3)
    xi = rng.integers(-127, 128, (FL_C, p)).astype(np.int8)
    xq = rng.integers(-127, 128, (FL_C, p)).astype(np.int8)
    return ns, tc, xi, xq


def test_floor_plain_matches_step_floor(floor):
    """P5: each tile's (8, 128) block holds the planar I sample at the
    tile's start. The script's kernel reads that sample from buffer slot
    0 (`win_i[0, ...]`), not from the step's slot, so it writes it at the
    even grid steps only; at an odd step slot 0 holds the window started
    for the next step (interpret mode completes a copy at its start; on
    the TPU it is a race), or the one before at the last step. The port
    writes each tile's own sample: equal at the even steps, and the odd
    steps' values are the windows the script's slot 0 held."""
    ns, tc, xi, xq = floor
    tiles = tc.block_size // FL_TILE
    want = np.asarray(ns["step_floor"](xi, xq)).reshape(FL_C * tiles, 8, 128)
    got = US.step_floor(_t(xi), _t(xq), tc, FL_TILE).numpy().reshape(
        FL_C * tiles, 8, 128)
    own = xi[:, 0:tiles * FL_TILE:FL_TILE].reshape(-1).astype(np.int32)
    np.testing.assert_array_equal(got, np.broadcast_to(
        own[:, None, None], got.shape))
    nsteps = FL_C * tiles
    slot0 = [g if g % 2 == 0 else (g + 1 if g + 1 < nsteps else g - 1)
             for g in range(nsteps)]
    np.testing.assert_array_equal(want, np.broadcast_to(
        own[slot0][:, None, None], want.shape))
    np.testing.assert_array_equal(got[0::2], want[0::2])
    assert (got[1::2] != want[1::2]).any()


def test_probe_inputs_are_the_scripts():
    """make_input: one noise row per plane from seed 0, I then Q, the same
    in every channel."""
    cfg = US.probe_config(1 << 17)
    xi, xq = US.make_input(cfg, 3, FL_TILE, "cpu")
    p = TK.planar_length(cfg, FL_TILE)
    rng = np.random.default_rng(0)
    one_i = (rng.standard_normal(p) * 0.05 * 127).astype(np.int8)
    one_q = (rng.standard_normal(p) * 0.05 * 127).astype(np.int8)
    for got, one in ((xi, one_i), (xq, one_q)):
        np.testing.assert_array_equal(got.numpy(),
                                      np.broadcast_to(one, (3, p)))


def _same(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    else:
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)


def test_split_variants_return_the_port_functions():
    """Each variant of the stage split, at C = 2 and blocks of 2^17 of
    DF17 traffic, returns what the port's public functions return."""
    cfg = US.probe_config(1 << 17)
    jc = JaxCfg(block_size=1 << 17, max_detections=256)
    frames = encoder.random_df17_frames(60, seed=4)
    iq, _ = encoder.make_capture(frames, snr_db=15.0, spacing=3000, seed=4)
    blocks = np.stack([JP.iq_to_device_layout(b) for b, _ in
                       sources.frame_blocks(iq, jc)][:2])
    blocks = blocks / np.float32(np.max(np.abs(blocks)) * 1.05)
    iq8 = np.clip(np.round(blocks * 127.0), -127, 127).astype(np.int8)
    xi, xq = (_t(a) for a in TK.to_planar_i8(iq8, cfg, FL_TILE))
    v = US.variants(cfg, FL_TILE)
    assert list(v) == ["floor", "k", "kc", "kcg", "kcgx", "full"]
    cands = TK.preamble_detect_cands_planar(xi, xq, cfg, tile=FL_TILE,
                                            ordered=False)
    assert int(cands[:, :, 4].sum()) > 20
    want = {
        "floor": US.step_floor(xi, xq, cfg, FL_TILE),
        "k": cands,
        "kc": TK.compact_candidates_unordered(cands, cfg, FL_TILE),
        "kcg": TK.demod_batch_planar(xi, xq, cfg, tile=FL_TILE),
        "kcgx": TK.demod_batch_planar(xi, xq, cfg, tile=FL_TILE,
                                      xla_gather=True),
        "full": TK.demod_batch_packed_planar(xi, xq, cfg, tile=FL_TILE,
                                             device="cpu"),
    }
    for name, fn in v.items():
        _same(fn(xi, xq), want[name])


# --- entry points, counts and bounds -----------------------------------------

# each module's entry point at a small size: the module constants it reads
MODULES = {"bw_probe": (BW, {"ROWS": 1024}),
           "kernel_ablate": (KA, {"C": 1, "BLOCK": 16384}),
           "unordered_stage_probe": (US, {"C": 1, "BLOCK": 65536})}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_entry_point_defaults_to_the_card(name, monkeypatch):
    """With no card each entry point raises unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod, small = MODULES[name]
    for k, v in small.items():
        monkeypatch.setattr(mod, k, v)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


@pytest.mark.parametrize("name", sorted(MODULES))
def test_entry_point_runs_the_plain_versions_on_the_cpu(name, capsys,
                                                         monkeypatch):
    """`--device cpu` at a small size: every line printed, no device
    number, and no launch counted."""
    mod, small = MODULES[name]
    for k, v in small.items():
        monkeypatch.setattr(mod, k, v)
    mod.reset_launches()
    assert mod.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "device not measured" in out and "GB/s" not in out
    assert sum(mod.LAUNCHES.values()) == 0
    n_lines = {"bw_probe": 6, "kernel_ablate": 7,
               "unordered_stage_probe": 6}[name]
    assert out.count("device not measured") == n_lines


def test_probe_bounds():
    """P1 moves 2 GiB (~0.64 ms at 3.35 TB/s), P2 and P3 read 1 GiB but its
    last 80 rows and write 8 rows per window; P4 charges B4's instructions
    at stage 5 only; P5 reads the planar rows once."""
    nb, ni = opcount.copy_probe_cost(BW.ROWS)
    assert nb == 2 << 30 and ni == BW.ROWS * 128
    ms, by = opcount.bound(nb, ni)
    assert by == "bytes" and abs(ms - 0.641) < 0.001
    nb, ni = opcount.read_probe_cost(BW.ROWS)
    steps = BW.ROWS // 144
    assert steps == 14563 and BW.ROWS - steps * 144 == 80
    assert nb == steps * 152 * 128 * 4
    assert opcount.bound(nb, ni)[1] == "bytes"
    assert opcount.ablate_probe_instr(100, 4, 1, 2) == 0
    assert opcount.ablate_probe_instr(100, 5, 1, 2) == \
        100 * opcount.b34_ops_per_sample(1, 2)
    cfg = US.probe_config()
    p = TK.planar_length(cfg, US.TILE)
    assert US.floor_bytes(cfg, US.C) == 2 * US.C * p + \
        US.C * 64 * (8 * 128 + 16) * 4
