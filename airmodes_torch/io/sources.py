"""IQ sources and block framing: a copy of the framers of
`airmodes.io.sources` (the port imports nothing of the JAX package).

A block is a (samples, start_sample) pair where samples has length
left_halo + block_size + right_halo and start_sample is the global sample
index of the first *owned* sample (int64 counter — the timestamp base).
Every sample is owned by exactly one block, so a detection belongs to the
block that owns its preamble start.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from ..config import DspConfig

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

    def __init__(self, cfg: DspConfig, start_sample: int = 0):
        left, block, right = cfg.left_halo, cfg.block_size, cfg.right_halo
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


def raw_file_chunks(path: str, *, dtype: str = "complex64",
                    chunk_samples: int = 1 << 20,
                    offset_samples: int = 0) -> Iterator[np.ndarray]:
    """Raw complex64 chunks from a recorded capture (no framing), converted
    from complex64, interleaved int16 ("sc16", /32768) or rtl-sdr uint8
    ("uc8", offset 127.5). offset_samples seeks into the capture."""
    bytes_per = {"complex64": 8, "sc16": 4, "uc8": 2}.get(dtype)
    if bytes_per is None:
        raise ValueError(f"unknown file dtype {dtype}")
    with open(path, "rb") as f:
        if offset_samples:
            f.seek(offset_samples * bytes_per)
        while True:
            # I/Q are interleaved in the file exactly as complex64 lays out
            # (re, im) — scale the flat f32 stream in place and VIEW it as
            # complex, instead of strided real/imag extraction + rebuild
            # (3 sequential passes instead of 6 strided ones)
            if dtype == "complex64":
                samples = np.fromfile(f, np.complex64, chunk_samples)
            elif dtype == "sc16":
                raw = np.fromfile(f, np.int16, chunk_samples * 2)
                raw = raw[: len(raw) // 2 * 2]   # drop a truncated half-sample
                flat = raw.astype(np.float32)
                flat *= np.float32(1.0 / 32768.0)
                samples = flat.view(np.complex64)
            else:  # uc8 (validated above)
                raw = np.fromfile(f, np.uint8, chunk_samples * 2)
                raw = raw[: len(raw) // 2 * 2]
                flat = raw.astype(np.float32)
                flat -= np.float32(127.5)
                flat *= np.float32(1.0 / 127.5)
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
