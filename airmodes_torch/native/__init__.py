"""ctypes binding for the native host runtime: the IQ streaming runtime
(iqstream.cc) and the wire-line formatter (wire.cc).

A copy of `airmodes.native` (the C++ framer: a file or UDP pump thread,
ring buffer, overlap-save framing as f32 blocks, or int8 quantization with
per-block AGC or a fixed gain and the planar I/Q split) and of its loader,
which imports only the standard library, numpy and the port's profiler
span (`utils.profiling.span`, around a wait for the source). The port adds
`WireLines`, one native pass from a block's packed table to its wire
lines. Builds the one shared library from both sources on first use with
g++ (cached next to them). Python<->C boundary is a C ABI — no pybind11
dependency."""

from __future__ import annotations

import ctypes
import numbers
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from ..utils.profiling import span

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, n) for n in ("iqstream.cc", "wire.cc")]
_LIB = os.path.join(_HERE, "libiqstream.so")

_lib = None
_lib_error: Optional["NativeUnavailable"] = None
_lib_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def _build() -> str:
    # build to a temp path and os.replace into place: two processes
    # racing the first build must never dlopen a half-written .so
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-pthread", *_SRCS, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    return _LIB


def load() -> ctypes.CDLL:
    """Load (building if needed) the native library. A failure is kept:
    later calls raise it again without another build."""
    global _lib, _lib_error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _lib_error is not None:
            raise _lib_error
        # a prebuilt .so with no source alongside (installed package) is
        # fine — only rebuild when a source exists and is newer
        srcs = [p for p in _SRCS if os.path.exists(p)]
        if not os.path.exists(_LIB) or any(
                os.path.getmtime(_LIB) < os.path.getmtime(p) for p in srcs):
            try:
                if len(srcs) < len(_SRCS):
                    raise NativeUnavailable(
                        f"no prebuilt {_LIB} and not every source of "
                        f"{_SRCS} to build from")
                try:
                    _build()
                except (OSError, subprocess.CalledProcessError) as e:
                    raise NativeUnavailable(
                        f"cannot build iqstream: {e}") from e
            except NativeUnavailable as e:
                _lib_error = e
                raise
        lib = ctypes.CDLL(_LIB)
        u64, i64, f32 = ctypes.c_uint64, ctypes.c_int64, ctypes.c_float
        vp, cp, ip = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
        lib.iq_stream_create.restype = vp
        lib.iq_stream_create.argtypes = [u64, u64, u64, u64]
        lib.iq_stream_destroy.argtypes = [vp]
        lib.iq_stream_push_f32.restype = u64
        lib.iq_stream_push_f32.argtypes = [vp, ctypes.c_void_p, u64]
        lib.iq_stream_set_eof.argtypes = [vp]
        lib.iq_stream_dropped.restype = u64
        lib.iq_stream_dropped.argtypes = [vp]
        lib.iq_stream_rcvbuf.restype = ip
        lib.iq_stream_rcvbuf.argtypes = [vp]
        lib.iq_quantize_planar_i8.restype = None
        lib.iq_quantize_planar_i8.argtypes = [vp, vp, vp, u64, f32]
        lib.iq_stream_start_file.restype = ip
        lib.iq_stream_start_file.argtypes = [vp, cp, ip, ctypes.c_double,
                                             u64]
        lib.iq_stream_start_udp.restype = ip
        lib.iq_stream_start_udp.argtypes = [vp, cp, ip, ctypes.c_double]
        lib.iq_stream_next_block.restype = ip
        lib.iq_stream_next_block.argtypes = [vp, ctypes.c_void_p,
                                             ctypes.POINTER(i64)]
        lib.iq_stream_next_block_i8.restype = ip
        lib.iq_stream_next_block_i8.argtypes = [vp, ctypes.c_void_p,
                                                ctypes.POINTER(i64), f32]
        lib.iq_stream_next_block_planar_i8.restype = ip
        lib.iq_stream_next_block_planar_i8.argtypes = [
            vp, ctypes.c_void_p, ctypes.c_void_p, u64,
            ctypes.POINTER(i64), f32]
        lib.iq_stream_next_block_planar_agc.restype = ip
        lib.iq_stream_next_block_planar_agc.argtypes = [
            vp, ctypes.c_void_p, ctypes.c_void_p, u64,
            ctypes.POINTER(i64), f32, ctypes.POINTER(f32)]
        lib.iq_stream_available.restype = u64
        lib.iq_stream_available.argtypes = [vp]
        lib.iq_stream_ready.restype = ctypes.c_int
        lib.iq_stream_ready.argtypes = [vp]
        # called holding the GIL (PyDLL): the pass takes tens of
        # microseconds, and a thread that lets go of the interpreter for it
        # waits up to the switch interval (5 ms) to win it back from the
        # framing threads
        lib.wire_lines = ctypes.PyDLL(_LIB).wire_lines
        lib.wire_lines.restype = i64
        lib.wire_lines.argtypes = [vp, i64, i64, ctypes.c_double,
                                   ctypes.c_double, i64, ctypes.c_double,
                                   vp, i64, vp]
        _lib = lib
        return lib


_FMT = {"complex64": 0, "f32": 0, "sc16": 1, "uc8": 2}


def quantize_planar_i8(iq: np.ndarray, gain: float):
    """complex64 (..., N) -> planar int8 (I, Q) arrays of the same shape,
    int8 = round(f32 * gain) clipped to +-127 (np.round half-to-even
    semantics, matching the Python quantizer bit for bit) in one fused
    native pass."""
    lib = load()
    arr = np.ascontiguousarray(iq, dtype=np.complex64)
    out_i = np.empty(arr.shape, np.int8)
    out_q = np.empty(arr.shape, np.int8)
    lib.iq_quantize_planar_i8(
        arr.ctypes.data_as(ctypes.c_void_p),
        out_i.ctypes.data_as(ctypes.c_void_p),
        out_q.ctypes.data_as(ctypes.c_void_p), arr.size, float(gain))
    return out_i, out_q


# BlockStats fields, in the order `wire_lines` writes their counts
WIRE_COUNTS = ("preambles", "overflow", "crc_ok", "corrected", "emitted",
               "crc_fail")
_LINE_BYTES = 160        # room a slot's line has in the output buffer
_I64 = 1 << 63


class WireLines:
    """One native pass from a block's packed (K+1, 9) int32 table to its
    wire lines: `self(row, start, rate, epoch, full_scale)` is byte for
    byte `dsp.host.table_to_messages(dsp.pipeline.unpack_table(row),
    start, rate, epoch, full_scale)`, and leaves the BlockStats counts
    that rule adds in `counts` (fields `WIRE_COUNTS`). It returns None for
    a row the pass does not take, which the caller hands to that rule: a
    frame of neither 56 nor 112 bits, a number past what the pass holds
    exactly (sample counts past 2^53, nanoseconds past int64, a rate of
    2^62 or more, a time of 1.8e10 s or more), a rate, epoch or full scale
    of another type than Python's numbers (or numpy's float64), or a value
    the rule raises on. A start of numpy's integer types is taken as
    `int(start)`: the rule, handed one, would scale it in int64. One
    object serves one thread; its buffer holds the last row's lines until
    the next call.
    Raises NativeUnavailable where the library cannot load."""

    def __init__(self, k: int):
        self._lib = load()
        self.k = k
        self._out = ctypes.create_string_buffer(k * _LINE_BYTES)
        self.counts = np.zeros(len(WIRE_COUNTS), np.int64)

    def __call__(self, row: np.ndarray, start, rate, epoch,
                 full_scale) -> Optional[list]:
        if (row.dtype != np.int32 or row.shape != (self.k + 1, 9)
                or not row.flags.c_contiguous):
            raise ValueError(
                f"row must be C-contiguous int32 ({self.k + 1}, 9); got "
                f"{row.dtype} {row.shape}")
        if not (isinstance(start, numbers.Integral)
                and isinstance(rate, (int, float))
                and isinstance(epoch, (int, float))
                and isinstance(full_scale, (int, float))):
            return None
        start = int(start)
        if not -(1 << 62) < start < (1 << 62):
            return None
        try:
            # the rule's own expressions on the caller's objects
            epoch_ns = int(round(epoch * 1e9))
            fs2 = float(full_scale ** 2)
            frate, fepoch = float(rate), float(epoch)
        except (ValueError, OverflowError):
            return None
        if frate != rate or not -_I64 <= epoch_ns < _I64:
            return None
        n = self._lib.wire_lines(
            row.ctypes.data, self.k, start, frate, fepoch, epoch_ns, fs2,
            self._out, len(self._out), self.counts.ctypes.data)
        if n < 0:
            return None
        return ctypes.string_at(self._out, n).decode("ascii").split("\n") \
            if n else []


class IQStream:
    """Native streaming source: ring buffer + overlap-save framer, read
    as f32 or int8 (total, 2) blocks or as planar int8 rows, with per-block
    AGC or a fixed gain. Filled from a file or a UDP socket by the C++ pump
    thread, or by `push` and `set_eof` from Python."""

    def __init__(self, cfg, ring_samples: Optional[int] = None):
        lib = load()
        self._lib = lib
        self.cfg = cfg
        self.left, self.block, self.right = (
            cfg.left_halo, cfg.block_size, cfg.right_halo)
        self.total = self.left + self.block + self.right
        if self.block < self.left:
            # the carry (previous block's tail) is read from the ring
            # slots of ONE block; block < left would index below tail
            # (uint64 wrap in C) into producer-writable slots
            raise ValueError(
                f"block_size {self.block} < left_halo {self.left}: "
                "unsupported framer geometry")
        if ring_samples is None:
            # size follows the FRAME (2 frames of pump-ahead, >= 2^22
            # floor for UDP burst absorption = 2.1 s at 2 Msps; the C
            # side's round-up to a power of two adds >= 2x headroom on
            # top): a fixed 2^24 default allocated 128 MiB of ring per
            # channel regardless of block size (1 GiB for an 8-channel
            # run) and would hang ("ring too small") past 2^24-sample
            # blocks anyway. 2x (not 4x): at the common 2^22-sample
            # block, 4x total crosses 2^24 and the round-up DOUBLES the
            # allocation the old default made.
            ring_samples = max(2 * self.total, 1 << 22)
        elif ring_samples < self.block + self.right:
            raise ValueError(
                f"ring_samples {ring_samples} < block+right_halo "
                f"{self.block + self.right}: the framer could never emit")
        self._h = lib.iq_stream_create(ring_samples, self.left, self.block,
                                       self.right)
        # guards every C call against close() from another thread: a bare
        # `while self._h` check-then-call left a use-after-free window
        # (destroy frees the Stream between the check and the call).
        # The C calls are non-blocking, so hold times are short.
        import threading as _threading
        self._lock = _threading.Lock()

    def _handle(self):
        """The open C handle, or raise — every post-close call used to
        hand NULL to C and segfault the process."""
        h = self._h
        if not h:
            raise RuntimeError("IQStream is closed")
        return h

    # --- producer -----------------------------------------------------------

    def push(self, iq: np.ndarray) -> int:
        """Push complex64 or float32 (N,2) samples; returns samples taken.
        Other dtypes are converted (the C side reinterprets raw bytes as
        f32 pairs — handing it, say, complex128 silently fills the ring
        with garbage)."""
        arr = np.ascontiguousarray(iq)
        if arr.dtype == np.complex64:
            arr = arr.view(np.float32)
        elif np.iscomplexobj(arr):
            arr = np.ascontiguousarray(
                arr.astype(np.complex64)).view(np.float32)
        elif arr.dtype != np.float32:
            arr = np.ascontiguousarray(arr.astype(np.float32))
        n = arr.size // 2
        with self._lock:
            return int(self._lib.iq_stream_push_f32(
                self._handle(), arr.ctypes.data_as(ctypes.c_void_p), n))

    def start_file(self, path: str, fmt: str = "complex64",
                   throttle_sps: float = 0.0,
                   offset_samples: int = 0) -> None:
        with self._lock:
            rc = self._lib.iq_stream_start_file(
                self._handle(), path.encode(), _FMT[fmt],
                float(throttle_sps), int(offset_samples))
        if rc == -5:
            raise OSError("stream already started")
        if rc != 0:
            raise OSError(f"cannot open {path}")

    def start_udp(self, host: str = "0.0.0.0", port: int = 10000,
                  timeout_s: float = 5.0) -> None:
        """Receive complex64 datagrams on host:port in the C++ pump thread.
        timeout_s > 0 ends the stream after that much receive silence
        (parity with io.sources.udp_source); <= 0 never times out."""
        with self._lock:
            rc = self._lib.iq_stream_start_udp(self._handle(),
                                               host.encode(), port,
                                               float(timeout_s))
        if rc == -5:
            raise OSError("stream already started")
        if rc == -3:
            # the C side fails loudly on non-numeric hosts (inet_pton)
            raise OSError(f"udp host {host!r} is not a numeric IPv4 "
                          "address (hostnames are not resolved here — "
                          "use e.g. 127.0.0.1 or 0.0.0.0)")
        if rc != 0:
            raise OSError(f"cannot bind udp {host}:{port}")

    def set_eof(self) -> None:
        with self._lock:
            if self._h:
                self._lib.iq_stream_set_eof(self._h)

    @property
    def dropped(self) -> int:
        """Cumulative samples lost to ring overrun (real-time sources)."""
        with self._lock:
            return int(self._lib.iq_stream_dropped(self._handle()))

    @property
    def rcvbuf(self) -> int:
        """Effective UDP socket receive buffer (bytes): the kernel may
        silently clamp the requested 8 MB to net.core.rmem_max."""
        with self._lock:
            return int(self._lib.iq_stream_rcvbuf(self._handle()))

    @property
    def available(self) -> int:
        with self._lock:
            return int(self._lib.iq_stream_available(self._handle()))

    # --- consumer -----------------------------------------------------------

    def _frame(self, stop, call, *args) -> bool:
        """Make the framing call `call(handle, *args)`, under the lock,
        until it frames a block: True once it has (rc 1); False at the end
        of stream (rc -1), on a closed handle or once `stop` is set.
        Between two calls that find no block it waits in
        `_wait_for_block`. rc -2 comes only from the planar calls, whose
        third argument is the row length."""
        while not (stop is not None and stop.is_set()):
            with self._lock:
                if not self._h:
                    return False
                rc = call(self._h, *args)
            if rc == 1:
                return True
            if rc == -1:
                return False
            if rc == -2:
                raise ValueError(
                    f"planar row too short: {args[2]} < {self.total}")
            self._wait_for_block(stop)
        return False

    def next_block(self, out: Optional[np.ndarray] = None, stop=None
                   ) -> Optional[Tuple[np.ndarray, int]]:
        """Next framed block as float32 (total, 2), in `out` or a buffer of
        its own, or None at end of stream. Waits (`_wait_for_block`)
        until data is available; a set `stop` threading.Event ends the
        wait early (returns None), so a consumer waiting on a quiet live
        source can be torn down."""
        if out is None:
            out = np.empty((self.total, 2), np.float32)
        self._check_out(out, np.float32)
        start = ctypes.c_int64(0)
        if not self._frame(stop, self._lib.iq_stream_next_block,
                           out.ctypes.data_as(ctypes.c_void_p),
                           ctypes.byref(start)):
            return None
        return out, int(start.value)

    def next_block_i8(self, scale: float = 127.0,
                      out: Optional[np.ndarray] = None, stop=None
                      ) -> Optional[Tuple[np.ndarray, int]]:
        """Next framed block quantized to int8 (total, 2) with the fixed
        gain int8 = round(f32 * scale), or None at end of stream."""
        if out is None:
            out = np.empty((self.total, 2), np.int8)
        self._check_out(out, np.int8)
        start = ctypes.c_int64(0)
        if not self._frame(stop, self._lib.iq_stream_next_block_i8,
                           out.ctypes.data_as(ctypes.c_void_p),
                           ctypes.byref(start), float(scale)):
            return None
        return out, int(start.value)

    def blocks(self, i8: bool = False, scale: float = 127.0):
        """Generator over all blocks until end of stream: f32, or int8 with
        the fixed gain `scale` when i8."""
        while True:
            nxt = self.next_block_i8(scale) if i8 else self.next_block()
            if nxt is None:
                return
            yield nxt

    def next_block_planar_i8(self, out_i: np.ndarray, out_q: np.ndarray,
                             scale: float = 127.0, stop=None
                             ) -> Optional[int]:
        """Fill planar int8 I and Q rows (each len >= left+block+right,
        zero-padded past the frame) in one fused native pass, with the
        fixed gain int8 = round(f32 * scale); returns the start sample, or
        None at end of stream. Blocks until data is available."""
        self._check_planar_out(out_i, out_q)
        start = ctypes.c_int64(0)
        if not self._frame(stop, self._lib.iq_stream_next_block_planar_i8,
                           out_i.ctypes.data_as(ctypes.c_void_p),
                           out_q.ctypes.data_as(ctypes.c_void_p), out_i.size,
                           ctypes.byref(start), float(scale)):
            return None
        return int(start.value)

    def next_block_planar_agc(self, out_i: np.ndarray, out_q: np.ndarray,
                              target: float = 120.0, stop=None
                              ) -> Optional[Tuple[int, float]]:
        """Planar int8 framing with per-block AGC (gain = target/peak over
        the framed block, Python quantize_i8 semantics); returns
        (start_sample, gain) or None at end of stream."""
        self._check_planar_out(out_i, out_q)
        start = ctypes.c_int64(0)
        gain = ctypes.c_float(1.0)
        if not self._frame(stop, self._lib.iq_stream_next_block_planar_agc,
                           out_i.ctypes.data_as(ctypes.c_void_p),
                           out_q.ctypes.data_as(ctypes.c_void_p), out_i.size,
                           ctypes.byref(start), float(target),
                           ctypes.byref(gain)):
            return None
        return int(start.value), float(gain.value)

    def _wait_for_block(self, stop) -> None:
        """After a framing call found no block: wait, in one span
        `airmodes.source_wait`, until the ring holds a whole block or the
        source has ended (or `stop` is set, or the stream is closed),
        polling the ring's fill every 1 ms rather than the framing call, so
        the framing that follows is not billed to the wait."""
        import time as _t
        with span("airmodes.source_wait"):
            while True:
                _t.sleep(0.001)
                if stop is not None and stop.is_set():
                    return
                with self._lock:
                    if not self._h or self._lib.iq_stream_ready(self._h):
                        return

    def _check_out(self, out, dtype) -> None:
        # the C side unconditionally writes total*2 elements: a wrong
        # dtype/shape/layout buffer is silent heap corruption, and these
        # must be real raises (asserts vanish under python -O)
        if out.dtype != dtype or out.shape != (self.total, 2) \
                or not out.flags.c_contiguous:
            raise ValueError(
                f"out must be C-contiguous {np.dtype(dtype).name} "
                f"({self.total}, 2); got {out.dtype} {out.shape}")

    def _check_planar_out(self, out_i, out_q) -> None:
        if out_i.dtype != np.int8 or out_q.dtype != np.int8 \
                or not out_i.flags.c_contiguous \
                or not out_q.flags.c_contiguous \
                or out_q.size < out_i.size:
            # the C side writes BOTH buffers up to out_len (= out_i.size)
            raise ValueError(
                "planar outputs must be C-contiguous int8 with "
                f"out_q.size >= out_i.size; got {out_i.dtype} "
                f"{out_i.shape} / {out_q.dtype} {out_q.shape}")

    def close(self) -> None:
        with self._lock:
            if self._h:
                h, self._h = self._h, None
                self._lib.iq_stream_destroy(h)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
