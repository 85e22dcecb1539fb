"""The reference's plain Mode S receiver (`benchmark/modes.py`), checked
against frames that the frozen encoder builds from known fields: its
CRC-24, its correction of one and two bits, its acceptance by DF, its wire
format and the three report fields it decodes; and the ground-truth count
of the comparison."""

import numpy as np
import pytest

from benchmark import judge, modes
from benchmark.frozen import encoder
from benchmark.frozen.config import DspConfig
from benchmark.frozen.fieldcodes import encode_alt_12bit, encode_alt_q

CFG = DspConfig(block_size=1 << 12)
ICAO = 0x4CA2D6


def _bits(frame: int, n: int) -> np.ndarray:
    out = np.zeros(112, np.uint8)
    out[:n] = [(frame >> (n - 1 - i)) & 1 for i in range(n)]
    return out


def _synd(frame: int, n: int) -> int:
    return int(modes.syndromes(_bits(frame, n)[None], np.array([n]))[0])


def _detections(frames, unsure=()):
    """Detections whose chips spell `frames` ((frame, nbits) pairs), with
    the chips of the bits in `unsure` (frame, bit) pairs set ambiguous."""
    chips = np.zeros((len(frames), 224))
    for k, (f, n) in enumerate(frames):
        b = _bits(f, n)
        chips[k, 0::2] = np.where(b == 1, 10.0, 1.0)
        chips[k, 1::2] = np.where(b == 1, 1.0, 10.0)
    for k, i in unsure:        # both chips above the level, order kept
        one = chips[k, 2 * i] > chips[k, 2 * i + 1]
        chips[k, 2 * i], chips[k, 2 * i + 1] = (9.0, 8.5) if one else \
            (8.5, 9.0)
    return modes.Detections(np.arange(len(frames)) * 300,
                            np.full(len(frames), 8.0), chips, len(frames))


def test_syndromes_by_df():
    me = encoder.me_identification("KLM1023")
    assert _synd(encoder.df17_frame(ICAO, me), 112) == 0
    assert _synd(encoder.df11_frame(ICAO, interrogator=9), 56) == 9
    for frame, n in ((encoder.df0_frame(ICAO, encode_alt_q(3000)), 56),
                     (encoder.df5_frame(ICAO, 0x1234), 56),
                     (encoder.df20_frame(ICAO, encode_alt_q(3000), 77), 112),
                     (encoder.df24_frame(ICAO, 3, 12345), 112)):
        assert _synd(frame, n) == ICAO


def test_one_flip_of_a_frame_adds_its_flip_syndrome():
    f = encoder.df17_frame(ICAO, encoder.me_identification("AB"))
    for i in (0, 7, 55, 111):
        assert _synd(f ^ (1 << (111 - i)), 112) == modes.FLIP_112[i]


def test_decide_corrects_one_and_two_unsure_bits_and_fails_more():
    f = encoder.df17_frame(ICAO, encoder.me_airborne_position(
        35000.0, 52.1, 4.3, odd=False))
    one = f ^ (1 << (111 - 40))
    two = f ^ (1 << (111 - 40)) ^ (1 << (111 - 90))
    sure_err = f ^ (1 << (111 - 60))
    det = _detections([(f, 112), (one, 112), (two, 112), (sure_err, 112)],
                      unsure=[(1, 40), (1, 3), (2, 40), (2, 90), (3, 61)])
    bits, df, nbits, synd, status, tied = modes.decide(det, CFG)
    assert list(status) == [modes.OK, modes.FIXED_1, modes.FIXED_2,
                            modes.FAIL]
    for k in (0, 1, 2):
        assert (bits[k] == _bits(f, 112)).all() and synd[k] == 0
    assert list(df) == [17, 17, 17, 17] and not tied.any()


def test_decide_by_df_and_the_wire_format():
    frames = [(encoder.df11_frame(ICAO, interrogator=5), 56),
              (encoder.df11_frame(ICAO) ^ (1 << 30), 56),
              (encoder.df4_frame(ICAO, encode_alt_q(12000)), 56),
              (encoder.df24_frame(ICAO, 1, 99), 112)]
    det = _detections(frames)
    decided = modes.decide(det, CFG)
    assert list(decided[4]) == [modes.OK, modes.FAIL, modes.ADDRESS,
                                modes.ADDRESS]
    msgs = modes.messages(modes.emitted(det, decided, 120.0 / 127.0),
                          2_000_000, 2e6)
    assert len(msgs) == 3
    f = msgs[0].split()
    assert f[:4] == ["11", f"{frames[0][0]:014x}", "000005", "0"]
    assert f[5:] == ["1.000000000", "1000000000"]
    lvl = 10 * np.log10(8.0 / 127 ** 2 / (120.0 / 127 / 127) ** 2)
    assert float(f[4]) == pytest.approx(lvl, abs=0.006)
    assert msgs[1].split()[2] == f"{ICAO:06x}"
    assert msgs[2].split()[0] == "24" and msgs[2].split()[5] == \
        "1.000450000"


@pytest.mark.parametrize("alt", [-1000.0, 25.0, 12350.0, 40000.0])
def test_fields_from_the_frame(alt):
    df17 = encoder.df17_frame(ICAO, encoder.me_airborne_position(
        alt, 48.0, 11.0, odd=True))
    assert encode_alt_12bit(alt) & 0x10
    got = modes.fields(f"{df17:028x}")
    assert got == {"df": 17, "icao": ICAO, "altitude_ft": int(alt)}
    df0 = encoder.df0_frame(ICAO, encode_alt_q(alt))
    assert modes.fields(f"{df0:014x}") == {"df": 0, "icao": ICAO,
                                           "altitude_ft": int(alt)}
    df21 = encoder.df21_frame(ICAO, 0x0ABC, mb=5)
    assert modes.fields(f"{df21:028x}") == {"df": 21, "icao": ICAO,
                                            "altitude_ft": None}
    ident = encoder.df17_frame(ICAO, encoder.me_identification("X"))
    assert modes.fields(f"{ident:028x}")["altitude_ft"] is None


def test_truth_counts_frames_by_block_across_the_loop():
    # one channel, a period of 10 samples at q = 1, blocks of 8: frame
    # "aa" at 3 (stream 3, 13, 23, ...), "bb" at 7 (7, 17, 27, ...)
    truth = {0: ([(3, "aa"), (7, "bb")], 10)}

    def msg(hx, s):
        return f"17 {hx} 000000 0 -3.00 {s / 2e6:.9f} {s * 500}"
    judged = {(0, 1): ([msg("aa", 13), msg("bb", 9)], None),
              (0, 2): ([msg("aa", 23)], None)}
    # block 1 (8..15) holds aa at 13, found; block 2 (16..23) holds bb
    # at 17, missed (bb was emitted at 9 only), and aa at 23, found
    assert judge.truth_missed(judged, truth, 8, 1, 2e6) == (1, 3, 1, 3)
    late = judge.truth_missed(judged, truth, 8, 1, 2e6, lambda s: s > 15)
    assert late == (1, 2, 1, 3)


def test_resolvable_phases_behind_a_resampler():
    from benchmark import traffic
    from benchmark.reference import Reference
    cfg = {"source_rate": 1e7, "sample_format": "sc16",
           "dsp": {"channel_rate": 2e6, "threshold_db": 5.0,
                   "block_size": 1 << 12, "max_detections": 128,
                   "noise_window": 128}}
    caps = traffic.build(cfg, {"channels": 1, "capture_samples": 1 << 14,
                               "msg_rate_hz": 1000.0, "snr_db": 15.0}, 5)
    ref = Reference(cfg, [caps[0].data], "cpu")
    # 60 taps: channel sample m stands for source samples centred on
    # 5m + 0.5; a chip of 5 samples from s is centred on s + 2
    assert [ref.resolvable(s) for s in range(10, 15)] == \
        [False, False, False, True, True]
    plain = Reference(dict(cfg, source_rate=2e6, sample_format="uc8"),
                      [caps[0].data], "cpu")
    assert all(plain.resolvable(s) for s in range(10, 15))


def test_a_frame_on_an_exact_tie_is_marked():
    f = encoder.df11_frame(ICAO)
    det = _detections([(f, 56), (f, 56), (f, 56), (f, 56)])
    det.chips[1, 20] = det.chips[1, 21]          # bit 10: on == off
    det.chips[2, 40] = 4.0                       # the level: ref 8 * 0.5
    det.chips[3, 150] = det.chips[3, 151]        # past a short frame's end
    tied = modes.decide(det, CFG)[5]
    assert list(tied) == [False, True, True, False]
    frames = modes.emitted(det, modes.decide(det, CFG), 1.0)
    assert modes.tied_stamps(frames, 0, 2e6) == {modes.stamp(300, 2e6),
                                                 modes.stamp(600, 2e6)}
