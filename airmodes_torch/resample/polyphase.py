"""Polyphase FIR rational resampler, in PyTorch.

The counterpart of `airmodes/resample/polyphase.py`: the classic P/Q
polyphase structure

    y[n] = sum_k h[k*P + (n*Q mod P)] * x[floor(n*Q/P) - k]

is linear and periodic (output n and n + 128P use the same coefficients
against inputs shifted by 128Q), so output groups of 128P samples are three
consecutive 128Q-sample input groups times three constant block-Toeplitz
matrices. The filter design, the bank and the matrices are numpy copies of
the reference's, so they agree exactly; the products run as torch f32
matmuls on whatever device holds the samples, summed as the reference adds
them, `(prev @ A_prev + cur @ A_cur) + next @ A_next`, with TF32 off
(`f32_matmul_exact`). The matrices live on the device, cached per
`(p, q, taps, device)`.

Torch on the CPU, cuBLAS on a card and XLA sum each output's 1,152-1,920
products in different orders, so the outputs agree to a few ulp, not bit
for bit (the reference's own streaming and offline forms differ by 1 ulp
for the same reason).

Entry points (`resample`, `resample_planar`, `resample_to_rate`,
`streaming_resampler`) take `device`, default "cuda": numpy or tensor input
moves there, and without a card they raise. As the reference jits
`resample`, `resample_planar` and the streaming stride, each runs as a
compiled step (`utils.graphs`: one captured CUDA graph per key on a card,
the function itself on the CPU), keyed on (p, q, taps), the device and
the input's shape; `resample` keys on whether its input is complex too.

Operational note: fractional-rate SDR captures (e.g. rtl-sdr 2.4 Msps)
decode most robustly resampled UP to 4 Msps (2 samples/chip); at 2 Msps
output a single sample per chip lands at an arbitrary sub-chip phase and
marginal messages drop. The input must be anti-alias filtered by the SDR.
"""

from __future__ import annotations

import functools
from fractions import Fraction
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp.pipeline import resolve_device
from ..utils.graphs import graphed


def design_lowpass(num_taps: int, cutoff: float, beta: float = 8.6,
                   delay: float = None) -> np.ndarray:
    """Kaiser-windowed sinc low-pass; cutoff in (0, 1] of Nyquist.

    delay sets the filter's group delay in samples (default (N-1)/2, the
    symmetric linear-phase center). The polyphase bank passes N/2: its
    anchor arithmetic advances by p*(taps_eff//2) = N/2 upsampled ticks,
    so a (N-1)/2-delay prototype would leave every resampled stream half
    an upsampled tick early, a constant 1/(2*p*rate_in) timestamp bias."""
    c = (num_taps - 1) / 2 if delay is None else delay
    n = np.arange(num_taps) - c
    h = np.sinc(cutoff * n) * cutoff
    # kaiser window evaluated about the SAME center (np.kaiser is only
    # symmetric about (N-1)/2)
    half = max(c, num_taps - 1 - c) + 0.5
    h *= np.i0(beta * np.sqrt(np.clip(1 - (n / half) ** 2, 0.0, 1.0))) \
        / np.i0(beta)
    return (h / h.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _polyphase_bank(p: int, q: int, taps_per_phase: int) -> np.ndarray:
    """(p, taps_eff) filter bank for interpolate-by-p/decimate-by-q.

    Prototype low-pass cutoff = 1/max(p, q) of the upsampled Nyquist, gain p
    (to compensate zero-stuffing). The prototype length scales with
    max(p, q): taps_eff = taps_per_phase * ceil(max(p, q) / p) keeps
    per-phase work proportional and pushes the p=1, q=5 worst alias band
    below -50 dB."""
    taps_eff = taps_per_phase * (-(-max(p, q) // p))
    num_taps = p * taps_eff
    h = design_lowpass(num_taps, cutoff=1.0 / max(p, q),
                       delay=num_taps / 2) * p
    return h.reshape(taps_eff, p).T.copy()  # [phase, tap]


@functools.lru_cache(maxsize=None)
def _group_matrices(p: int, q: int, taps_per_phase: int):
    """Three (128q, 128p) block-Toeplitz matrices (prev, cur, next), numpy
    f32: y_grp[G] = x_grp[G-1] @ A_prev + x_grp[G] @ A_cur +
    x_grp[G+1] @ A_next."""
    bank = _polyphase_bank(p, q, taps_per_phase)
    t = bank.shape[1]          # effective taps per phase
    gi, go = 128 * q, 128 * p
    mats = [np.zeros((gi, go), np.float32) for _ in range(3)]
    for nl in range(go):
        b = (nl * q) // p + t // 2
        ph = (nl * q) % p
        for k in range(t):
            i = b - k + gi            # position in [prev | cur | next]
            assert 0 <= i < 3 * gi
            mats[i // gi][i % gi, nl] = bank[ph, k]
    return tuple(mats)


# matrices cost 3 * 128^2 * p * q * 4 bytes; beyond this use the slice form
_GROUP_PQ_CAP = 256


@functools.lru_cache(maxsize=None)
def _device_matrices(p: int, q: int, taps_per_phase: int,
                     device: torch.device):
    """_group_matrices as f32 tensors on `device`, made once per device."""
    return tuple(torch.from_numpy(m).to(device)
                 for m in _group_matrices(p, q, taps_per_phase))


def f32_matmul_exact() -> None:
    """Turn TF32 off for f32 matmuls and convolutions, and check that
    PyTorch's matmul precision is then "highest": a TF32 product keeps a
    10-bit mantissa (~1e-3 relative), which would flip int8 samples after
    the quantize that follows the resampler. These are process-wide torch
    settings; the resampler sets them before each of its matmuls."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "f32 matmul precision is "
            f"{torch.get_float32_matmul_precision()!r}, not 'highest': the "
            "resampler needs IEEE f32 products")


def _as_tensor(x, dev: torch.device) -> torch.Tensor:
    """x (numpy or tensor) on `dev`, as complex64 if complex, else f32."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    t = t.to(torch.complex64 if t.is_complex() else torch.float32)
    return t.to(dev)


def resample_groups_halo(xc: torch.Tensor, p: int, q: int,
                         taps_per_phase: int = 12) -> torch.Tensor:
    """Group-matmul resample with real neighbour halos, on xc's device.

    xc: (C, gi + N + gi) f32 planar, where N is a multiple of gi = 128q and
    the first/last gi samples are the neighbouring input groups (zeros at
    the stream boundary). Returns (C, N*p//q): output group G takes input
    groups G-1, G and G+1."""
    c, n_tot = xc.shape
    gi, go = 128 * q, 128 * p
    n_in = n_tot - 2 * gi
    if n_in < 0 or n_in % gi:
        raise ValueError(f"resample_groups_halo: {n_tot} samples is not "
                         f"2 halo groups plus whole groups of {gi}")
    ng = n_in // gi
    xg = xc.contiguous().reshape(c, ng + 2, gi)
    ap, a0, an = _device_matrices(p, q, taps_per_phase, xc.device)
    f32_matmul_exact()
    y = torch.matmul(xg[:, 0:ng], ap)
    y += torch.matmul(xg[:, 1:ng + 1], a0)
    y += torch.matmul(xg[:, 2:ng + 2], an)
    return y.reshape(c, ng * go)


def _resample_groups(xc: torch.Tensor, p: int, q: int,
                     taps_per_phase: int) -> torch.Tensor:
    """(C, N) planar -> (C, floor(N*p/q)) via the group matmuls. Zero-pads
    one input group on each side (out-of-range taps read zeros)."""
    c, n_in = xc.shape
    n_out = (n_in * p) // q
    gi, go = 128 * q, 128 * p
    ng = -(-n_out // go)
    back = (ng + 1) * gi - n_in
    assert back >= 0
    xp = F.pad(xc, (gi, back))
    return resample_groups_halo(xp, p, q, taps_per_phase)[:, :n_out]


def _resample_cols(x2: torch.Tensor, p: int, q: int,
                   taps_per_phase: int) -> torch.Tensor:
    """Rational-resample (N, C) columns jointly; output (floor(N*p/q), C),
    for p*q above _GROUP_PQ_CAP.

    Outputs n = r + m*p share subfilter phase (r*q) mod p and anchors in
    arithmetic progression base0(r) + m*q, so each (row, tap) term is a
    strided slice times a scalar coefficient:

        y[r + m*p] = sum_k bank[(r*q) % p, k] * x[(r*q)//p + t//2 + m*q - k]

    Out-of-range taps at the edges read zeros, the edge rule of the group
    matmuls."""
    n_in, nc = x2.shape
    n_out = (n_in * p) // q
    if n_out <= 0:
        return x2.new_zeros((0, nc))
    bank = _polyphase_bank(p, q, taps_per_phase)          # numpy (p, T)
    t = bank.shape[1]   # effective taps per phase
    m_rows = -(-n_out // p)                               # outputs per row

    base0 = [(r * q) // p + (t // 2) for r in range(p)]
    phase = [(r * q) % p for r in range(p)]
    lpad = max(0, t - min(base0))
    rpad = max(0, max(base0) + (m_rows - 1) * q - (n_in - 1)) + 1
    xp = torch.cat([x2.new_zeros((lpad, nc)), x2,
                    x2.new_zeros((rpad, nc))])
    rows = []
    for r in range(p):
        acc = x2.new_zeros((m_rows, nc))
        h = bank[phase[r]]
        for k in range(t):
            s = lpad + base0[r] - k
            acc = acc + float(h[k]) * xp[s: s + (m_rows - 1) * q + 1: q]
        rows.append(acc)
    y = torch.stack(rows, dim=1).reshape(m_rows * p, nc)  # n = m*p + r
    return y[:n_out]


def _to_planar(x2: torch.Tensor) -> torch.Tensor:
    """(N, 2) interleaved -> (2, N) planar. The reference permutes lanes
    with an exact matmul on the TPU; a transpose gives the same values."""
    return x2.T.contiguous()


def _to_interleaved(yc: torch.Tensor) -> torch.Tensor:
    """(2, N) planar -> (N, 2) interleaved."""
    return yc.T.contiguous()


def _resample2(x2: torch.Tensor, p: int, q: int, taps_per_phase: int):
    """(N, C) resample: group matmuls when the matrices are small enough
    (every practical SDR ratio), else the phase-decomposed slice form."""
    if p * q <= _GROUP_PQ_CAP:
        return _to_interleaved(_resample_groups(_to_planar(x2), p, q,
                                                taps_per_phase))
    return _resample_cols(x2, p, q, taps_per_phase)


def resample_planar(xc, p: int, q: int, taps_per_phase: int = 12,
                    device="cuda") -> torch.Tensor:
    """(C, N) planar f32 -> (C, floor(N*p/q)) on `device`, a compiled
    step (`_resample_planar_step`); p == q == 1 returns the input there."""
    dev = resolve_device(device)
    if p == q == 1:
        return _as_tensor(xc, dev)
    return _resample_planar_step(xc, p, q, taps_per_phase, device=dev)


@graphed(static_argnames=("p", "q", "taps_per_phase"))
def _resample_planar_step(xc, p: int, q: int, taps_per_phase: int,
                          device="cuda") -> torch.Tensor:
    """`resample_planar`'s compiled step."""
    xc = _as_tensor(xc, resolve_device(device))
    if p * q <= _GROUP_PQ_CAP:
        return _resample_groups(xc, p, q, taps_per_phase)
    return _resample_cols(xc.T, p, q, taps_per_phase).T


def resample(x, p: int, q: int, taps_per_phase: int = 12,
             device="cuda") -> torch.Tensor:
    """Resample by rational p/q on `device`. Accepts float (N,), complex
    (N,) or float32 (N, 2) I/Q (each component filtered); returns a tensor
    of the same layout (complex64 for complex input), from a compiled step
    (`_resample_step`)."""
    dev = resolve_device(device)
    if p == q == 1:
        return _as_tensor(x, dev)
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    is_complex = x.is_complex() if isinstance(x, torch.Tensor) \
        else np.iscomplexobj(x)
    if not is_complex:
        if x.ndim == 2 and x.shape[-1] != 2:
            raise ValueError(
                f"resample() takes 1-D complex, (N, 2) I/Q, or 1-D real "
                f"input; got shape {tuple(x.shape)} — for planar (2, N) "
                f"streams use the planar/streaming entry points")
        if x.ndim not in (1, 2):
            raise ValueError(f"resample() input must be 1-D or (N, 2), got "
                             f"shape {tuple(x.shape)}")
    return _resample_step(x, p, q, taps_per_phase, is_complex, device=dev)


@graphed(static_argnames=("p", "q", "taps_per_phase", "complex_in"))
def _resample_step(x, p: int, q: int, taps_per_phase: int, complex_in: bool,
                   device="cuda") -> torch.Tensor:
    """`resample`'s compiled step. A complex64 input reaches a graph as its
    (N, 2) f32 view (`utils.graphs`), so complex_in, part of the key,
    says to read it as complex again: complex in, complex64 out."""
    x = _as_tensor(x, resolve_device(device))
    if complex_in and not x.is_complex():
        x = torch.view_as_complex(x)
    if x.is_complex():
        xc = torch.stack([x.real, x.imag])                  # (2, N) planar
        if p * q <= _GROUP_PQ_CAP:
            yc = _resample_groups(xc, p, q, taps_per_phase)
        else:
            yc = _resample_cols(xc.T, p, q, taps_per_phase).T
        return torch.complex(yc[0], yc[1])
    if x.ndim == 2:
        return _resample2(x, p, q, taps_per_phase)
    return _resample2(x[:, None], p, q, taps_per_phase)[:, 0]


def rational_rate(in_rate: float, out_rate: float,
                  max_denominator: int = 64) -> Tuple[int, int]:
    """(p, q) with out_rate ~= in_rate * p / q (ref: arb resampler ratio)."""
    frac = Fraction(out_rate / in_rate).limit_denominator(max_denominator)
    if frac.numerator == 0:
        raise ValueError(f"cannot resample {in_rate} -> {out_rate}")
    err = abs(in_rate * frac.numerator / frac.denominator - out_rate) / out_rate
    if err > 1e-6:
        raise ValueError(
            f"{in_rate} -> {out_rate} not representable as a small rational "
            f"(best {frac}, err {err:.2e}); pick a friendlier SDR rate")
    return frac.numerator, frac.denominator


def resample_to_rate(x, in_rate: float, out_rate: float,
                     taps_per_phase: int = 12, device="cuda"):
    """Resample a capture from in_rate to out_rate (e.g. 2.4 Msps -> 2 Msps)."""
    p, q = rational_rate(in_rate, out_rate)
    return resample(x, p, q, taps_per_phase, device=device)


@graphed(static_argnames=("p", "q", "t", "S"))
def _streaming_kernel(block2, p: int, q: int, t: int, S: int,
                      device="cuda") -> torch.Tensor:
    """One streaming stride as a compiled step: block2 (hist + stride, 2)
    f32 I/Q -> (2, S * 128p) planar. Local input groups 0..S+1 are global
    groups sS-2..sS+S-1; output group sS-1+j takes locals j, j+1, j+2:
    the offline path's matmuls against the same globally aligned groups.
    Module-level, so resamplers with equal (p, q, t, S) share one graph,
    as they share the reference's one compiled program."""
    x = _as_tensor(block2, resolve_device(device))
    if x.shape != ((S + 2) * 128 * q, 2):
        raise ValueError(f"_streaming_kernel: block of shape "
                         f"{tuple(x.shape)}, not ({(S + 2) * 128 * q}, 2)")
    return resample_groups_halo(_to_planar(x), p, q, t)


class streaming_resampler:
    """Stateful chunked resampler for live sources: push(chunk) consumes
    arbitrary-length complex64 numpy chunks and returns (as numpy
    complex64) the resampled samples whose inputs are fully available;
    history carries across calls, and the tail appears after flush().

    Strides are whole 128q-sample input groups aligned with the offline
    `resample`'s groups, and each stride is one `_streaming_kernel` call
    on `device` (one copy over, three matmuls, one copy back) against the
    same group values, so the concatenated output equals the offline
    resample of the concatenated input from sample 0, to the matmuls'
    summation order.

    `delay_out` = 128p: the final output group of a stride needs the next
    stride's first input group, so outputs lag by one group."""

    def __init__(self, p: int, q: int, taps_per_phase: int = 12,
                 stride_blocks: int = 2048, device="cuda"):
        if p * q > _GROUP_PQ_CAP:
            raise ValueError(
                f"p/q={p}/{q}: group matrices would be "
                f"{3 * 128 * 128 * p * q * 4 / 1e6:.0f} MB — pick a "
                "friendlier rate ratio (rational_rate with a smaller "
                "max_denominator) or resample offline")
        self.dev = resolve_device(device)
        self.p, self.q, self.t = int(p), int(q), int(taps_per_phase)
        gi, go = 128 * self.q, 128 * self.p
        self.s_groups = max(2, (stride_blocks * self.q) // gi)
        self.stride = self.s_groups * gi          # input samples per step
        self.n_out = self.s_groups * go
        self.delay_out = go
        self.hist = 2 * gi
        self._reset()

    def _reset(self):
        # list-of-parts pending buffer: concatenating per push() would copy
        # the whole backlog for every UDP-sized chunk
        self._pending_parts: list = []
        self._pending_n = 0
        self._left = np.zeros(self.hist, np.complex64)
        self._stride_idx = 0
        self._n_in = 0                            # real samples pushed
        self._n_emitted = 0                       # samples returned so far

    def _kernel(self, block: np.ndarray) -> np.ndarray:
        """One stride: (hist + stride,) complex64 -> (s_groups * 128p,),
        through the compiled `_streaming_kernel`; the read-back stays
        here, on the host."""
        x = torch.from_numpy(block.view(np.float32).reshape(-1, 2))
        y2 = _streaming_kernel(x, self.p, self.q, self.t, self.s_groups,
                               device=self.dev).cpu().numpy()
        y = np.empty(y2.shape[1], np.complex64)
        y.real, y.imag = y2[0], y2[1]
        return y

    def push(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.complex64)
        self._n_in += len(x)
        if len(x):
            self._pending_parts.append(x)
            self._pending_n += len(x)
        if self._pending_n < self.stride:
            return np.zeros(0, np.complex64)
        buf = (self._pending_parts[0] if len(self._pending_parts) == 1
               else np.concatenate(self._pending_parts))
        outs = []
        off = 0
        while len(buf) - off >= self.stride:
            chunk = buf[off: off + self.stride]
            off += self.stride
            block = np.ascontiguousarray(
                np.concatenate([self._left, chunk]))
            y = self._kernel(block)
            if self._stride_idx == 0:
                y = y[self.delay_out:]  # output group -1 is pre-stream
            outs.append(y)
            self._left = chunk[-self.hist:]
            self._stride_idx += 1
        rem = buf[off:]
        self._pending_parts = [rem] if len(rem) else []
        self._pending_n = len(rem)
        y = np.concatenate(outs)
        self._n_emitted += len(y)
        return y

    def flush(self) -> np.ndarray:
        """End the stream: emit exactly the remaining output samples.

        Zero-pads a full extra stride beyond the boundary (the last group
        holding real data needs its next input group as matmul lookahead)
        and trims the result so total emitted == floor(n_pushed * p / q).
        Resets to a fresh stream afterwards, so a second flush() returns
        nothing."""
        target = (self._n_in * self.p) // self.q - self._n_emitted
        if target <= 0:
            self._reset()
            return np.zeros(0, np.complex64)
        pad = 2 * self.stride - self._pending_n
        n_real = self._n_in
        y = self.push(np.zeros(pad, np.complex64))[:target]
        assert len(y) == target, (len(y), target, n_real)
        self._reset()
        return y
