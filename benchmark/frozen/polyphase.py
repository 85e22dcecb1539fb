# Frozen copy of the filter design of airmodes_torch/resample/polyphase.py
# at commit 8b1fb463eba6 (`design_lowpass` as copied; `fir_taps` is
# `_polyphase_bank` for p = 1, where the bank is the prototype itself).
"""The resampler's prototype low-pass, for the benchmark's reference."""

from __future__ import annotations

import numpy as np


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


def fir_taps(q: int, taps_per_phase: int = 12) -> np.ndarray:
    """The f32 prototype of the p = 1, decimate-by-q polyphase resampler:
    taps_per_phase * q taps, cutoff 1/q of Nyquist, group delay of half its
    length, unit DC gain. Output n of the resampler is
    sum_k h[k] * x[q*n + len(h)//2 - k]."""
    n = taps_per_phase * q
    return design_lowpass(n, cutoff=1.0 / q, delay=n / 2)
