"""The port's golden harness (`airmodes_torch.testing.golden`) against the
reference's (`airmodes.testing.golden`), and the port's full-block pipeline
(`demod_block`, `device="cpu"`) against the oracle in the cases of
tests/test_golden.py.

The oracle is numpy in both packages: its (index, hex) lists, the corrupted
captures of `inject_chip_errors` and the SNR sweep's points must be equal,
not close. The port's pipeline must give the oracle's (index, hex) set
exactly, as the reference's pipeline does.
"""

import dataclasses

import numpy as np
import pytest

from airmodes.config import DspConfig as JaxCfg
from airmodes.testing import encoder as jencoder
from airmodes.testing import golden as jgolden
from airmodes_torch import crc
from airmodes_torch.config import DspConfig
from airmodes_torch.constants import STATUS_CRC_OK
from airmodes_torch.dsp import host
from airmodes_torch.dsp.pipeline import demod_block_packed, unpack_table
from airmodes_torch.io import sources
from airmodes_torch.testing import encoder, golden

CFG = DspConfig(block_size=1 << 16, max_detections=64)
JCFG = JaxCfg(block_size=1 << 16, max_detections=64)
FRAME = "8d4840d6202cc371c32ce0576098"


def port_decode(iq, cfg=CFG):
    """(index, hex) of every message of the port's full-block path."""
    out = []
    for table, start in _tables(iq, cfg):
        for m in host.table_to_messages(table, start, cfg.channel_rate):
            parts = m.split()
            out.append((int(float(parts[5]) * cfg.channel_rate + 0.5),
                        parts[1]))
    return sorted(out)


def _tables(iq, cfg):
    for block, start in sources.frame_blocks(iq, cfg):
        yield unpack_table(demod_block_packed(block, cfg, device="cpu")), \
            start


def _one_frame(seed):
    return encoder.make_capture([(int(FRAME, 16), 112)], snr_db=25.0,
                                seed=seed, random_phase=False)


# --- the oracle: the same numpy in both packages ------------------------------

def _captures():
    """(name, capture, truth, cfg) of the oracle cases of
    tests/test_golden.py, and one at 4 Msps."""
    frames = encoder.random_df17_frames(25, seed=40)
    frames += [(encoder.df11_frame(0x600000 + i), 56) for i in range(5)]
    yield ("healthy", *encoder.make_capture(frames, snr_db=14.0,
                                            spacing=2000, seed=40), CFG)
    yield ("threshold", *encoder.make_capture(
        encoder.random_df17_frames(30, seed=41), snr_db=8.0, spacing=2000,
        seed=41), CFG)
    yield ("start", *encoder.make_capture(
        encoder.random_df17_frames(3, seed=77), snr_db=20.0, start=40,
        spacing=9000, seed=77), CFG)
    yield ("4 Msps", *encoder.make_capture(
        encoder.random_df17_frames(6, seed=5), rate=4e6, snr_db=12.0,
        spacing=6000, seed=5), DspConfig(channel_rate=4e6,
                                         block_size=1 << 16,
                                         max_detections=32))


def _case(case):
    return next(c[1:] for c in _captures() if c[0] == case)


@pytest.mark.parametrize("case", ["healthy", "threshold", "start", "4 Msps"])
def test_oracle_matches_reference_oracle(case):
    iq, _, cfg = _case(case)
    jc = JaxCfg(**dataclasses.asdict(cfg))
    want = jgolden.reference_decode(iq, jc)
    assert golden.reference_decode(iq, cfg) == want
    assert want


@pytest.mark.parametrize("mode", ["erase", "flip", "dim", "dim_keep"])
def test_inject_chip_errors_matches_reference(mode):
    """The same corrupted capture, sample for sample, from the same
    truth; and the oracle reads it the same."""
    iq, truth = _one_frame(46)
    _, jtruth = jencoder.make_capture([(int(FRAME, 16), 112)], snr_db=25.0,
                                      seed=46, random_phase=False)
    for bits in ([55], [30, 77], [0], [10, 30, 50, 70, 90, 100]):
        got = golden.inject_chip_errors(iq, truth[0], bits, mode=mode)
        want = jgolden.inject_chip_errors(iq, jtruth[0], bits, mode=mode)
        np.testing.assert_array_equal(got, want)
        assert golden.reference_decode(got, CFG) == \
            jgolden.reference_decode(want, JCFG)


def test_slice_and_check_matches_reference():
    """The oracle's slicer and CRC/ECC on power traces of every kind of
    frame: clean, DF11 with an interrogator, one and two low-confidence
    errors, and noise."""
    rng = np.random.default_rng(9)
    frames = [(int(FRAME, 16), 112),
              (encoder.df11_frame(0x3C6614, interrogator=5), 56)]
    for frame, nbits in frames:
        iq, truth = encoder.make_capture([(frame, nbits)], snr_db=25.0,
                                         seed=3, random_phase=False)
        for bits in ([], [55], [20, 40]):
            x = golden.inject_chip_errors(iq, truth[0], bits, mode="dim")
            m = np.abs(x.astype(np.complex64)) ** 2
            i = truth[0].sample_index
            ref = float(np.mean([m[i + c] for c in (0, 2, 7, 9)]))
            assert golden._slice_and_check(m, i, ref, CFG) == \
                jgolden._slice_and_check(m, i, ref, JCFG)
    m = rng.random(4096).astype(np.float32)
    for i in range(0, 3000, 97):
        assert golden._slice_and_check(m, i, 0.5, CFG) == \
            jgolden._slice_and_check(m, i, 0.5, JCFG)


def test_snr_sweep_matches_reference():
    """The sweep's points through the port's pipeline equal the
    reference's through its own, at 2 and 4 Msps; the decode rate is
    (near-)monotone in SNR, with a bound at every point."""
    snrs = [3.0, 7.0, 10.0, 14.0, 20.0]
    pts = golden.snr_sweep(snrs, n_msgs=25, seed=7, device="cpu")
    want = jgolden.snr_sweep(snrs, n_msgs=25, seed=7)
    assert [dataclasses.astuple(p) for p in pts] == \
        [dataclasses.astuple(p) for p in want]
    rates = [p.rate for p in pts]
    assert pts[0].injected == 25
    for lo, hi in zip(rates, rates[1:]):
        assert hi >= lo - 1.0 / 25, rates
    assert rates[0] <= 0.8 and rates[2] >= 0.5
    assert rates[3] >= 0.9 and rates[4] >= 0.95
    cfg4 = dict(channel_rate=4e6, block_size=1 << 16, max_detections=32)
    got = golden.snr_sweep([25.0], n_msgs=4, seed=5, cfg=DspConfig(**cfg4),
                           device="cpu")
    want = jgolden.snr_sweep([25.0], n_msgs=4, seed=5, cfg=JaxCfg(**cfg4))
    assert got[0].decoded == want[0].decoded and got[0].rate >= 0.75


def test_snr_sweep_needs_a_card_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        golden.snr_sweep([20.0], n_msgs=2)


# --- the port's pipeline against the oracle -----------------------------------

@pytest.mark.parametrize("case", ["healthy", "threshold", "start", "4 Msps"])
def test_pipeline_matches_oracle(case):
    """The vectorized path and the sequential oracle give the identical
    (index, hex) set; at the healthy SNR at most 2 frames fall below the
    threshold; at the capture start the frame at sample 40 decodes."""
    iq, truth, cfg = _case(case)
    got = port_decode(iq, cfg)
    assert got == sorted(golden.reference_decode(iq, cfg))
    if case == "healthy":
        hexes = {h for _, h in got}
        assert sum(t.hex not in hexes for t in truth) <= 2
    if case == "start":
        assert any(idx == 40 for idx, _ in got)


def test_noise_only_false_positive_bound():
    """Pure noise mints no CRC-validated message (DF11/17/18) and no ECC
    correction, over 4 blocks of 2^20 samples."""
    cfg = DspConfig(block_size=1 << 20, max_detections=128)
    rng = np.random.default_rng(123)
    n = 4 * cfg.block_size
    iq = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64) * 0.05
    stats = host.BlockStats()
    msgs = []
    for table, start in _tables(iq, cfg):
        msgs.extend(host.table_to_messages(table, start, cfg.channel_rate,
                                           stats=stats))
    assert [m for m in msgs if int(m.split()[0]) in (11, 17, 18)] == []
    assert stats.corrected == 0 and stats.emitted == len(msgs)


@pytest.mark.parametrize("seed,bits,mode,decodes", [
    (42, [55], "erase", True),            # one low-confidence bit
    (43, [30, 77], "erase", True),        # two
    (44, [40], "flip", False),            # a confident wrong bit
    (45, [10, 30, 50, 70, 90, 100], "erase", False),   # too many
    (46, [55], "dim", True),              # the oracle's 1-bit branch
    (47, [30, 77], "dim", True)])         # its 2-bit branch
def test_ecc_fault_injection(seed, bits, mode, decodes):
    """The brute-force ECC corrects one or two low-confidence bits, and
    only those; on the dim cases the pipeline equals the oracle."""
    iq, truth = _one_frame(seed)
    bad = golden.inject_chip_errors(iq, truth[0], bits, mode=mode)
    got = port_decode(bad)
    assert (FRAME in {h for _, h in got}) == decodes
    if mode == "dim":
        assert got == sorted(golden.reference_decode(bad, CFG))


def test_oracle_class_flip_rejected_matches_pipeline():
    """A frame read as DF17 whose one correction crosses the 56/112 class
    boundary: both the pipeline and the oracle drop it."""
    payload = (1 << 83) | (0x123456 << 56) | 0xABCDEF   # df=1, 112-bit
    F, n = encoder.build_frame(payload, 88)
    assert n == 112
    R = F ^ (1 << 111)
    iq, truth = encoder.make_capture([(R, 112)], snr_db=25.0, seed=48,
                                     random_phase=False)
    bad = golden.inject_chip_errors(iq, truth[0], [0], mode="dim_keep")
    assert golden.reference_decode(bad, CFG) == []
    assert port_decode(bad) == []


def test_df11_interrogator_and_garbage_syndrome():
    """A clean DF11 with II != 0 decodes in both; one whose syndrome is a
    nonzero multiple of 128 does not."""
    frame = encoder.df11_frame(0x3C6614, interrogator=5)
    assert crc.crc24(frame, 56) == 5
    iq, truth = encoder.make_capture([(frame, 56)], snr_db=25.0, seed=11)
    got = port_decode(iq)
    assert any(h == truth[0].hex for _, h in got)
    assert sorted(golden.reference_decode(iq, CFG)) == got
    base = encoder.df11_frame(0x3C6614, interrogator=0)
    bad = next(c for c in (base ^ (1 << f) ^ (1 << (f + 7))
                           for f in range(6, 30))
               if crc.crc24(c, 56) and not crc.crc24(c, 56) & 0x7F)
    iq, _ = encoder.make_capture([(bad, 56)], snr_db=25.0, seed=12)
    assert f"{bad:014x}" not in {h for _, h in port_decode(iq)}


def test_marginal_snr_spurious_provenance():
    """On marginal traffic any spurious decode comes from the ECC
    re-targeting a damaged frame (never a clean CRC pass), at most ~1% of
    the injected count."""
    cfg = DspConfig(block_size=1 << 17, max_detections=128)
    n_inj, spurious = 0, []
    for seed in (60, 61, 62):
        frames = encoder.random_df17_frames(70, seed=seed)
        iq, truth = encoder.make_capture(frames, snr_db=10.0, spacing=5500,
                                         seed=seed)
        want = {t.hex for t in truth}
        n_inj += len(want)
        seen = set()
        for table, start in _tables(iq, cfg):
            for m in host.table_to_messages(table, start, cfg.channel_rate):
                p = m.split()
                if p[1] not in want and p[1] not in seen \
                        and int(p[0]) in (11, 17, 18):
                    seen.add(p[1])
                    spurious.append(int(p[3]))
    assert [s for s in spurious if s == STATUS_CRC_OK] == []
    assert len(spurious) <= max(1, n_inj // 100), spurious
