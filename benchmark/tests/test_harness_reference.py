"""The reference against the generator's ground truth on a tiny looped
capture, across the loop's seam; its classes of blocks; its control."""

import numpy as np

from benchmark import traffic
from benchmark.reference import Reference, period_blocks

N = 1 << 14
CONFIG = {"source_rate": 2e6, "sample_format": "uc8",
          "dsp": {"channel_rate": 2e6, "threshold_db": 5.0, "block_size": N,
                  "max_detections": 128, "noise_window": 128}}
TRAFFIC = {"channels": 2, "capture_samples": 2 * N, "msg_rate_hz": 600.0,
           "snr_db": 15.0}


def _truth_by_block(cap, b):
    T = cap.samples
    lo = b * N
    out = {}
    for p, hx in cap.truth:
        k = -(-(lo - p) // T)
        s = p + k * T
        if s < lo + N:
            out[s] = hx
    return out


def test_reference_decodes_every_injected_frame_across_the_seam():
    caps = traffic.build(CONFIG, TRAFFIC, 2 ** 32 + 3)
    ref = Reference(CONFIG, [c.data for c in caps], "cpu")
    assert ref.period == 2
    blocks = [(c, b) for c in range(2) for b in range(1, 6)]
    ref.prepare(blocks)
    n = 0
    for c, b in blocks:
        got = {}
        for m in ref.messages(c, b):
            f = m.split()
            got[int(f[6]) // 500] = f[1]
        want = _truth_by_block(caps[c], b)
        assert want, (c, b)
        for s, hx in want.items():
            assert got.get(s) == hx, (c, b, s)
            n += 1
    assert n >= 20


def test_blocks_of_one_class_give_the_same_messages_but_their_time():
    caps = traffic.build(CONFIG, dict(TRAFFIC, channels=1), 11)
    ref = Reference(CONFIG, [caps[0].data], "cpu")
    ref.prepare([(0, 1), (0, 3)])
    a = [m.split()[:5] for m in ref.messages(0, 1)]
    b = [m.split()[:5] for m in ref.messages(0, 3)]
    assert a == b and a
    assert ref.messages(0, 1) != ref.messages(0, 3)   # timestamps differ


def test_period_of_a_resampled_stream():
    fused = dict(CONFIG, source_rate=1e7, sample_format="sc16")
    assert period_blocks(fused, 1 << 16) == 4       # 2^16 raw, q = 5
    assert period_blocks(CONFIG, 1 << 16) == 4


def test_control_levels_coarsen_the_samples():
    caps = traffic.build(CONFIG, dict(TRAFFIC, channels=1), 11)
    a = Reference(CONFIG, [caps[0].data], "cpu")
    b = Reference(CONFIG, [caps[0].data], "cpu", levels=7)
    a.prepare([(0, 1)])
    b.prepare([(0, 1)])
    la = [float(m.split()[4]) for m in a.messages(0, 1)]
    lb = {m.split()[1]: float(m.split()[4]) for m in b.messages(0, 1)}
    assert la and lb
    assert np.isfinite(la).all()
    assert a.messages(0, 1) != b.messages(0, 1)
