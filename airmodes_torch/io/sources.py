"""IQ sources and block framing: a copy of `airmodes.io.sources` (the port
imports nothing of the JAX package). Files, UDP datagrams and the encoder's
synthetic traffic become framed blocks; `resampled_file_source` puts the
streaming polyphase resampler (`resample.polyphase`, on a device) in front
of the framer when the capture's rate is not the channel rate. SDR hardware
sources (UHD, osmosdr) raise: their hardware libraries are not part of
the port.

A block is a (samples, start_sample) pair where samples has length
left_halo + block_size + right_halo and start_sample is the global sample
index of the first *owned* sample (int64 counter — the timestamp base).
Every sample is owned by exactly one block, so a detection belongs to the
block that owns its preamble start.
"""

from __future__ import annotations

import socket
from typing import Iterator, Optional, Tuple

import numpy as np

from ..config import DspConfig, SourceConfig

Block = Tuple[np.ndarray, int]


def frame_blocks(iq: np.ndarray, cfg: DspConfig,
                 start_sample: int = 0) -> Iterator[Block]:
    """Split a contiguous capture into overlapped demod blocks.

    Zero-pads the edges (start of capture / tail). Every sample is owned by
    exactly one block, so detections are never duplicated or lost at block
    boundaries (the dedup rule: a detection belongs to the block that owns
    its preamble start).
    """
    left, n, right = cfg.left_halo, cfg.block_size, cfg.right_halo
    total = len(iq)
    pos = 0
    while pos < total:
        chunk = np.zeros(left + n + right, dtype=np.complex64)
        lo = max(pos - left, 0)
        hi = min(pos + n + right, total)
        chunk[left - (pos - lo): left + (hi - pos)] = iq[lo:hi]
        yield chunk, start_sample + pos
        pos += n


class buffered_framer:
    """Incremental framer for streaming sources: push raw sample chunks in,
    pull fully-formed overlapped blocks out. Keeps the halo tail between
    blocks (the streaming equivalent of GR history).

    Copy-minimal: pushed chunks are queued as views and each emitted block
    is assembled with ONE gathered copy into its own buffer."""

    def __init__(self, cfg: DspConfig, start_sample: int = 0,
                 geometry=None):
        """geometry=(left, block, right) overrides cfg's halo geometry: the
        fused resample path frames raw-rate windows with it
        (io/stream.run_resampled_fused; the raw halos come from
        resample.fused.raw_geometry, not cfg)."""
        left, block, right = geometry or (cfg.left_halo, cfg.block_size,
                                          cfg.right_halo)
        if block < left:
            raise ValueError(
                f"block_size {block} < left_halo {left}: "
                "the inter-block carry needs a full halo of owned samples")
        self.cfg = cfg
        self._geom = (left, block, right)
        self._carry = np.zeros(left, dtype=np.complex64)
        self._chunks: list = []
        self._have = 0
        self._next_start = start_sample

    def _peek_into(self, out: np.ndarray, count: int) -> None:
        pos, i = 0, 0
        while pos < count:
            c = self._chunks[i]
            take = min(len(c), count - pos)
            out[pos: pos + take] = c[:take]
            pos += take
            i += 1

    def _drop(self, n: int) -> None:
        self._have -= n
        while n:
            c = self._chunks[0]
            if len(c) <= n:
                n -= len(c)
                self._chunks.pop(0)
            else:
                self._chunks[0] = c[n:]        # view, no copy
                n = 0

    def push(self, samples: np.ndarray) -> Iterator[Block]:
        left, n, right = self._geom
        if len(samples):
            self._chunks.append(np.asarray(samples, dtype=np.complex64))
            self._have += len(samples)
        while self._have >= n + right:
            block = np.empty(left + n + right, dtype=np.complex64)
            block[:left] = self._carry
            self._peek_into(block[left:], n + right)
            yield block, self._next_start
            self._carry = block[n: n + left]   # owned tail, view into block
            self._drop(n)
            self._next_start += n

    def flush(self) -> Iterator[Block]:
        """Emit the remaining samples as zero-padded full-size blocks.

        Loops until every pending sample is OWNED by some block: push()
        holds back up to block_size + right_halo - 1 samples, more than one
        block's worth, so a single final block would leave up to
        right_halo - 1 trailing samples only ever seen as someone's right
        halo — frames there would be silently lost (the native
        iqstream.cc EOF path loops the same way)."""
        left, n, right = self._geom
        while self._have > 0:
            m = min(self._have, n + right)
            block = np.zeros(left + n + right, dtype=np.complex64)
            block[:left] = self._carry
            self._peek_into(block[left: left + m], m)
            yield block, self._next_start
            if self._have <= n:
                break
            self._carry = block[n: n + left]
            self._drop(n)
            self._next_start += n
        self._chunks = []
        self._have = 0


# a capture's file format -> (numpy type of its I and Q words, offset,
# scale): a sample's I or Q is (word - offset) * scale in f32, one rounding
# each (complex64 words are the samples). Read by raw_file_chunks and by
# the fused runners, whose kernel R1 converts the words on the card.
WIRE_FORMATS = {
    "complex64": (np.float32, 0.0, 1.0),
    "sc16": (np.int16, 0.0, 1.0 / 32768.0),
    "uc8": (np.uint8, 127.5, 1.0 / 127.5),
}


def raw_file_chunks(path: str, *, dtype: str = "complex64",
                    chunk_samples: int = 1 << 20,
                    offset_samples: int = 0) -> Iterator[np.ndarray]:
    """Raw complex64 chunks from a recorded capture (no framing), converted
    from complex64, interleaved int16 ("sc16", /32768) or rtl-sdr uint8
    ("uc8", offset 127.5) as WIRE_FORMATS says. offset_samples seeks into
    the capture."""
    if dtype not in WIRE_FORMATS:
        raise ValueError(f"unknown file dtype {dtype}")
    word, offset, scale = WIRE_FORMATS[dtype]
    with open(path, "rb") as f:
        if offset_samples:
            f.seek(offset_samples * 2 * np.dtype(word).itemsize)
        while True:
            # I/Q are interleaved in the file exactly as complex64 lays out
            # (re, im) — scale the flat f32 stream in place and VIEW it as
            # complex, instead of strided real/imag extraction + rebuild
            # (3 sequential passes instead of 6 strided ones)
            if dtype == "complex64":
                samples = np.fromfile(f, np.complex64, chunk_samples)
            else:
                raw = np.fromfile(f, word, chunk_samples * 2)
                raw = raw[: len(raw) // 2 * 2]   # drop a truncated half-sample
                flat = raw.astype(np.float32)
                if offset:
                    flat -= np.float32(offset)
                flat *= np.float32(scale)
                samples = flat.view(np.complex64)
            if len(samples) == 0:
                return
            yield samples


def file_source(path: str, cfg: DspConfig, *, dtype: str = "complex64",
                start_sample: int = 0) -> Iterator[Block]:
    """Replay a recorded capture (ref: blocks.file_source, complex64).

    dtype: complex64 | interleaved int16 ("sc16") | interleaved uint8 ("uc8",
    rtl-sdr style offset-127.5). start_sample > 0 seeks into the capture and
    resumes the global sample counter there (checkpoint/resume: the stream
    position IS the sample counter, SURVEY.md §5.4).
    """
    framer = buffered_framer(cfg, start_sample)
    for samples in raw_file_chunks(path, dtype=dtype,
                                   chunk_samples=1 << 22,
                                   offset_samples=start_sample):
        yield from framer.push(samples)
    yield from framer.flush()


def udp_source(cfg: DspConfig, host: str = "0.0.0.0", port: int = 10000,
               *, max_blocks: Optional[int] = None, timeout_s: float = 5.0,
               sock: Optional[socket.socket] = None) -> Iterator[Block]:
    """Receive complex64 IQ over UDP (ref: radio.py UDP source branch).

    `sock` injects a pre-bound socket (port 0 / testing); the stream ends
    after `timeout_s` of silence and flushes the buffered tail.
    timeout_s <= 0 or None blocks forever: a live receiver must survive
    upstream feeder restarts of any length (modes_rx passes this by
    default via --udp-timeout 0)."""
    if sock is None:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind((host, port))
    sock.settimeout(timeout_s if timeout_s and timeout_s > 0 else None)
    framer = buffered_framer(cfg)
    emitted = 0
    try:
        while max_blocks is None or emitted < max_blocks:
            try:
                data, _ = sock.recvfrom(1 << 16)
            except socket.timeout:
                break
            # tolerate malformed/truncated datagrams (the port is open to
            # the network): drop the partial trailing sample, skip empties
            data = data[: len(data) - len(data) % 8]
            if not data:
                continue
            samples = np.frombuffer(data, dtype=np.complex64)
            for block in framer.push(samples):
                yield block
                emitted += 1
                if max_blocks is not None and emitted >= max_blocks:
                    break
        # stream ended (timeout or block cap): emit the buffered tail so a
        # short transmission is not dropped wholesale (file_source flushes
        # in the identical situation)
        for block in framer.flush():
            if max_blocks is not None and emitted >= max_blocks:
                break
            yield block
            emitted += 1
    finally:
        sock.close()


def synthetic_source(cfg: DspConfig, *, n_messages: int = 100,
                     snr_db: float = 20.0, seed: int = 0,
                     n_blocks: int = 4) -> Iterator[Block]:
    """Encoder-driven source for self-test / benchmarking."""
    from ..testing import encoder
    frames = encoder.random_df17_frames(n_messages, seed=seed)
    total = n_blocks * cfg.block_size
    spacing = max(total // max(n_messages, 1), 600 * cfg.sps)
    iq, _ = encoder.make_capture(
        frames, rate=cfg.channel_rate, snr_db=snr_db, spacing=spacing,
        seed=seed, total_samples=total)
    yield from frame_blocks(iq, cfg)


def open_source(src: SourceConfig, cfg: DspConfig) -> Iterator[Block]:
    """Dispatch on SourceConfig.kind (ref: modes_rx -s option).

    Raises when src.sample_rate != cfg.channel_rate: this dispatcher does
    no resampling, and framing a wrong-rate capture would demodulate
    garbage — route other rates through `resampled_file_source` the way
    apps/modes_rx.py does."""
    if abs(src.sample_rate - cfg.channel_rate) > 1e-3:
        raise ValueError(
            f"source rate {src.sample_rate:g} != channel rate "
            f"{cfg.channel_rate:g}: resample first "
            "(resample.polyphase.streaming_resampler; see modes_rx -r)")
    if src.kind == "file":
        if not src.path:
            raise ValueError("file source needs a path")
        return file_source(src.path, cfg)
    if src.kind == "udp":
        # default timeout 0: survive feeder restarts of any length
        return udp_source(cfg, src.udp_host, src.udp_port,
                          timeout_s=src.udp_timeout_s)
    if src.kind == "synthetic":
        return synthetic_source(cfg)
    if src.kind in ("uhd", "osmocom"):
        raise RuntimeError(
            f"SDR hardware source '{src.kind}' requires the UHD/osmosdr "
            "libraries, which the port does not include; use file/udp "
            "sources")
    raise ValueError(f"unknown source kind {src.kind}")


def resampled_file_source(path: str, cfg: DspConfig, *, dtype: str,
                          rate_in: float, start_sample: int = 0,
                          device="cuda") -> Iterator[Block]:
    """File capture at rate_in -> streaming polyphase resample to the
    channel rate (on `device`) -> framed blocks: the resampling twin of
    file_source.

    start_sample is in output (channel-rate) samples; the input seek is
    the nearest raw sample (resume phase approximate to < 1 chip, fine
    for re-acquisition) and the global counter resumes there so
    timestamps stay continuous. Raises without a card unless `device`
    asks for the CPU, before the capture is opened."""
    from ..resample.polyphase import rational_rate, streaming_resampler
    p_up, q_dn = rational_rate(rate_in, cfg.channel_rate)
    rs = streaming_resampler(p_up, q_dn, device=device)
    in_skip = (start_sample * q_dn) // p_up
    framer = buffered_framer(cfg, start_sample)
    for chunk in raw_file_chunks(path, dtype=dtype,
                                 offset_samples=in_skip):
        yield from framer.push(rs.push(chunk))
    yield from framer.push(rs.flush())
    yield from framer.flush()
