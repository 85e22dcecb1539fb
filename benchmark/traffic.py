"""The captures a cell replays, made from the seed.

One general generator for every traffic mix: a mix is a data file of
parameters (`benchmark/traffic/<name>.json`), a configuration says the
source's rate and sample format (`benchmark/configs/<name>.json`). Each
channel's capture is the traffic of the port's bench (`build_capture`,
`write_uc8_capture`): Mode S frames of every supported downlink format,
~60% DF17 (`random_mixed_frames`, the frozen encoder), evenly spaced at
`msg_rate_hz` per second of air time, each at `snr_db` over complex
Gaussian noise of power 1e-2 with a random carrier phase, written in the
source's wire format (rtl-sdr's offset uc8 or USRP's sc16, I and Q
interleaved) at one full scale per seed: 0.9 of it is the noise's largest
component plus a frame's amplitude, so nothing clips.

Every channel carries the same frames, as the receivers of one site hear
the same aircraft, in a rotation drawn from the channel's seed, with
carrier phases of its own. The noise comes from one seeded pool shared by
every channel: each `SEGMENT` samples of a channel are a window of the
pool at an offset drawn from the channel's seed. The pool is put in the
wire format once and its windows copied, and only the frames' samples
are quantized again, so sixteen channels cost little more than one. The
same seed gives the same captures, byte for byte, in every process that
builds them (the generator, and the harness again for the reference).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .frozen import encoder

NOISE_POWER = 1e-2
POOL = 1 << 22          # complex samples in the shared noise pool
SEGMENT = 1 << 16       # samples of a channel drawn from one pool offset
CHIP_RATE = 2e6
BYTES_PER_SAMPLE = {"uc8": 2, "sc16": 4}


@dataclasses.dataclass
class Capture:
    """One channel: `data`, the interleaved wire samples (uint8 or int16,
    2 * samples values), and the frames injected, as (sample index, hex)
    pairs in sample order."""

    data: np.ndarray
    truth: List[tuple]

    @property
    def samples(self) -> int:
        return self.data.size // 2


def derive_seed(*words: int) -> int:
    """A 63-bit seed from the cell's seed (any whole number) and indices."""
    ent = [w % (1 << 64) for w in words]
    return int(np.random.SeedSequence(ent).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def noise_pool(seed: int) -> np.ndarray:
    rng = np.random.default_rng(derive_seed(seed, 0xB0B))
    z = rng.standard_normal(2 * POOL, dtype=np.float32)
    z *= np.float32(np.sqrt(NOISE_POWER / 2))
    return z.view(np.complex64)


class _Quantizer:
    """The wire format at a fixed full scale: every component is scaled
    by 0.9 of full scale over `peak` (the pool's largest component plus a
    frame's amplitude, so nothing clips) and rounded; uc8 is offset by
    127.5."""

    def __init__(self, fmt: str, peak: float):
        if fmt == "uc8":
            self.scale, self.off, self.dtype = 0.9 * 127.5 / peak, 127.5, \
                np.uint8
        elif fmt == "sc16":
            self.scale, self.off, self.dtype = 0.9 * 32767 / peak, 0.0, \
                np.int16
        else:
            raise ValueError(f"unknown sample format {fmt!r}")

    def __call__(self, iq: np.ndarray) -> np.ndarray:
        x = iq.view(np.float32) * np.float32(self.scale) + \
            np.float32(self.off)
        return np.rint(x).astype(self.dtype)


def build_channel(pool: np.ndarray, pool_q: np.ndarray, quant: _Quantizer,
                  all_frames: list, seed: int, channel: int, *, rate: float,
                  samples: int, snr_db: float) -> Capture:
    """One channel's capture of `samples` samples at `rate` (a multiple of
    the 2 MHz chip rate): windows of the pool, already in the wire format
    (`pool_q`), and the frames, in a rotation of `all_frames` drawn from
    the channel's seed, each frame's samples quantized again with the
    frame added."""
    sps = int(round(rate / CHIP_RATE))
    if sps < 1 or abs(sps * CHIP_RATE - rate) > 1e-3:
        raise ValueError(f"rate {rate:g} is not a multiple of the chip rate")
    seg = min(SEGMENT, samples)
    if samples % seg:
        raise ValueError(f"capture of {samples} samples is not whole "
                         f"segments of {seg}")
    rng = np.random.default_rng(derive_seed(seed, 1 + channel))
    offs = rng.integers(0, POOL - seg, size=samples // seg)
    data = np.empty(2 * samples, quant.dtype)
    for j, o in enumerate(offs):
        data[2 * j * seg:2 * (j + 1) * seg] = pool_q[2 * o:2 * (o + seg)]

    n_msgs = len(all_frames)
    rot = int(rng.integers(0, n_msgs))
    frames = all_frames[rot:] + all_frames[:rot]
    spacing = samples // n_msgs
    amp = float(np.sqrt(NOISE_POWER * 10 ** (snr_db / 10.0)))
    phases = np.exp(2j * np.pi * rng.random(n_msgs)).astype(np.complex64)
    pos = 1024 + np.arange(n_msgs) * spacing
    wire = data.reshape(samples, 2)
    truth = []
    for nbits in (56, 112):
        sel = [i for i, (_, nb) in enumerate(frames) if nb == nbits
               and pos[i] + (16 + 2 * nbits) * sps <= samples]
        if not sel:
            continue
        pulse = np.repeat(_chips([frames[i][0] for i in sel], nbits), sps,
                          axis=1)
        s = pos[sel][:, None] + np.arange(pulse.shape[1])
        iq = pool[offs[s // seg] + s % seg] + \
            (amp * phases[sel][:, None] * pulse).astype(np.complex64)
        wire[s] = quant(iq).reshape(*s.shape, 2)
        truth += [(int(pos[i]), f"{frames[i][0]:0{nbits // 4}x}")
                  for i in sel]
    return Capture(data, sorted(truth))


def _chips(frames: List[int], nbits: int) -> np.ndarray:
    """(n, 16 + 2 * nbits) f32 chip amplitudes of frames of nbits bits:
    the preamble, then each bit as PPM, 1 in its first chip for a one and
    in its second for a zero (the encoder's `frame_to_chips`)."""
    raw = np.frombuffer(b"".join(f.to_bytes(nbits // 8, "big")
                                 for f in frames), np.uint8)
    bits = np.unpackbits(raw).reshape(len(frames), nbits).astype(np.float32)
    out = np.zeros((len(frames), 16 + 2 * nbits), np.float32)
    out[:, :16] = encoder.PREAMBLE_CHIP_PATTERN
    out[:, 16::2] = bits
    out[:, 17::2] = 1.0 - bits
    return out


def build(config: dict, traffic: dict, seed: int) -> List[Capture]:
    """Every channel's capture of a cell, several channels at once."""
    from concurrent.futures import ThreadPoolExecutor
    pool = noise_pool(seed)
    flat = pool.view(np.float32)
    amp = float(np.sqrt(NOISE_POWER * 10 ** (traffic["snr_db"] / 10.0)))
    quant = _Quantizer(config["sample_format"],
                       max(float(flat.max()), -float(flat.min())) + amp)
    pool_q = quant(pool)
    samples = traffic["capture_samples"]
    n_msgs = max(int(samples / config["source_rate"]
                     * traffic["msg_rate_hz"]), 8)
    frames = encoder.random_mixed_frames(n_msgs, seed=derive_seed(seed, 7))

    def one(c):
        return build_channel(pool, pool_q, quant, frames, seed, c,
                             rate=config["source_rate"], samples=samples,
                             snr_db=traffic["snr_db"])
    n = traffic["channels"]
    with ThreadPoolExecutor(max_workers=min(n, 8)) as ex:
        return list(ex.map(one, range(n)))


def due_time(t0: float, sample: int, chunk: int, rate: float) -> float:
    """When stream sample `sample` is due on an open-loop stream that
    starts at t0 and writes chunks of `chunk` samples, each once its last
    sample exists: chunk n at t0 + (n + 1) * chunk / rate."""
    return t0 + (sample // chunk + 1) * chunk / rate
