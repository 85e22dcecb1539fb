"""The port's profiler trace (`airmodes_torch/utils/profiling.py`, what
`modes_rx --profile` writes) names every hand-kernel call, and chip_smoke's
trace-counting helper reads such traces right (fault C2, ROADMAP C).

Each kernel wrapper opens a range "<ID> <kernel>" (the IDs of PERF.md's
kernel table) around its launch on the card, or around its plain version
on the CPU, so the counts can be held here without a card: each range
appears once per wrapper call, on whichever thread the call ran (the int8
runner launches from its dispatch thread). On the card chip_smoke's phase
17 holds the device events to the launch counters as well.
"""

from __future__ import annotations

import glob
import io
import json
import os
import re
import sys
from collections import Counter
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

import airmodes_torch.apps.modes_rx as rx
from airmodes_torch.config import DspConfig
from airmodes_torch.kernels import _ext
from airmodes_torch.kernels import preamble as K
from airmodes_torch.probes import bw_probe as BW
from airmodes_torch.probes import kernel_ablate as KA
from airmodes_torch.probes import unordered_stage_probe as US
from airmodes_torch.testing import encoder
from airmodes_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """The capture of test_torch_cli's `--profile` test: 12 DF17 frames
    over 2^17 samples at 22 dB, complex64 and uc8."""
    d = tmp_path_factory.mktemp("prof")
    frames = encoder.random_df17_frames(12, seed=90)
    iq, _ = encoder.make_capture(frames, snr_db=22.0, spacing=8037,
                                 seed=90, total_samples=1 << 17)
    c64 = str(d / "cap.c64")
    iq.astype(np.complex64).tofile(c64)
    x = iq / float(np.max(np.abs(iq))) * 0.9
    u = np.empty(2 * len(x), np.uint8)
    u[0::2] = np.round(x.real * 127.5 + 127.5).astype(np.uint8)
    u[1::2] = np.round(x.imag * 127.5 + 127.5).astype(np.uint8)
    uc8 = str(d / "cap.uc8")
    u.tofile(uc8)
    return c64, uc8


def _count_calls(monkeypatch, names):
    """Wrap each named kernel wrapper of `preamble` to count its calls."""
    calls = Counter()
    for name in names:
        real = getattr(K, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(K, name, counted)
    return calls


# (CLI arguments, wrapper -> the ranges its calls open)
CLI_PATHS = {
    "int8": (lambda c64, uc8: ["-s", uc8, "--file-format", "uc8", "--int8"],
             {"preamble_detect_cands_planar": ("B1 detect_cands",),
              "_slice_windows": ("B2 slice_windows",)}),
    "f32": (lambda c64, uc8: ["-s", c64],
            {"_detect_mask": ("B3 detect_mask", "B4 detect_mask")}),
    "f32 channels": (lambda c64, uc8: ["-s", c64, "-s", c64],
                     {"_detect_mask": ("B3 detect_mask",
                                       "B4 detect_mask")}),
}


@pytest.mark.parametrize("path", list(CLI_PATHS))
def test_cli_profile_names_every_wrapper_call(path, capture, tmp_path,
                                              monkeypatch):
    """`modes_rx --profile` on the CPU (the int8 native runner, which calls
    B1 and B2 on its dispatch thread; the f32 runner, B3; two channels, B4):
    its Chrome trace holds one range per wrapper call."""
    argv, wrappers = CLI_PATHS[path]
    calls = _count_calls(monkeypatch, wrappers)
    logdir = tmp_path / "prof"
    with redirect_stdout(io.StringIO()), redirect_stderr(io.StringIO()):
        rc = rx.main(argv(*capture) + [
            "-n", "--block-size", "65536", "--stats-interval", "0",
            "--profile", str(logdir), "--device", "cpu"])
    assert rc == 0
    (trace,) = glob.glob(str(logdir / "trace_*.json"))
    ranges = _smoke().trace_counts(trace)["ranges"]
    for name, labels in wrappers.items():
        assert calls[name] > 0, name
        assert sum(ranges.get(lb, 0) for lb in labels) == calls[name], \
            (name, ranges)
    if path == "f32 channels":
        assert ranges.get("B4 detect_mask", 0) > 0


def _planar(cfg, seed=3):
    rng = np.random.default_rng(seed)
    p = K.planar_length(cfg)
    xi, xq = (torch.from_numpy((rng.standard_normal((2, p)) * 20)
                               .astype(np.int8)) for _ in range(2))
    return xi, xq


def _wrapper_calls():
    """(range, call) of every kernel wrapper, at small sizes on the CPU."""
    cfg = DspConfig(block_size=1 << 17)
    xi, xq = _planar(cfg)
    iq = torch.zeros((2, cfg.left_halo + cfg.block_size + cfg.right_halo,
                      2))
    base = torch.tensor([0, 300, -1], dtype=torch.int32)
    cfg4 = KA.probe_config(1 << 15)
    iq4 = torch.from_numpy(KA.make_input(cfg4, 2))
    cfg5 = US.probe_config(1 << 17)
    xi5, xq5 = US.make_input(cfg5, 2, US.TILE, "cpu")
    x = BW.make_input(300, "cpu")
    return {
        "B1 detect_cands": lambda: K.preamble_detect_cands_planar(
            xi, xq, cfg, ordered=False),
        "B5o detect_cands": lambda: K.preamble_detect_cands_planar(
            xi, xq, cfg),
        "B5p detect_cands": lambda: K.preamble_detect_cands_planar(
            xi, xq, cfg, ordered=False, prescreen=True),
        "B2 slice_windows": lambda: K.slice_windows_planar(
            xi.reshape(-1, 128), xq.reshape(-1, 128), base, cfg),
        "B3 detect_mask": lambda: K.preamble_detect_2d(iq[0], cfg),
        "B4 detect_mask": lambda: K.preamble_detect_2d_batch(iq, cfg),
        "B6 detect_mask": lambda: K.preamble_detect_1d_batch(iq, cfg),
        "P1 bw_copy": lambda: BW.copy(x),
        "P2 bw_read": lambda: BW.dma_read(x),
        "P3 bw_ring_read": lambda: BW.dma2_read(x),
        "P4 detect_ablate": lambda: KA.ablate(iq4, cfg4, 5, KA.TILE),
        "P5 planar_floor": lambda: US.step_floor(xi5, xq5, cfg5, US.TILE),
    }


WRAPPER_RANGES = ["B1 detect_cands", "B5o detect_cands", "B5p detect_cands",
                  "B2 slice_windows", "B3 detect_mask", "B4 detect_mask",
                  "B6 detect_mask", "P1 bw_copy", "P2 bw_read",
                  "P3 bw_ring_read", "P4 detect_ablate", "P5 planar_floor"]


def test_every_wrapper_has_its_range_case():
    assert list(_wrapper_calls()) == WRAPPER_RANGES


@pytest.mark.parametrize("label", WRAPPER_RANGES)
def test_each_wrapper_opens_its_named_range(label):
    """Every kernel wrapper, plain version on the CPU, opens exactly one
    range, named with the kernel table's ID, per call."""
    call = _wrapper_calls()[label]
    with profiling.profiler() as prof:
        call()
        call()
    names = Counter(e.name for e in prof.events()
                    if re.match(r"[BP]\d\w* ", e.name))
    assert names == {label: 2}


def test_ranges_only_while_a_profiler_records():
    """Off the profiler a wrapper opens no range (a range costs host time
    on every launch); inside one it does."""
    assert not isinstance(profiling.kernel_range("B1 detect_cands"),
                          torch.profiler.record_function)
    with profiling.profiler():
        assert isinstance(profiling.kernel_range("B1 detect_cands"),
                          torch.profiler.record_function)


def test_sessions_record_before_the_work_starts(monkeypatch):
    """A session records SETTLE_S before the enclosed code runs: the
    profiler drops device events that map before the session's start, and
    on an H100 the card's clock mapped up to ~9 ms early (phase 17). On
    the card it first launches a primer of several times more kernels
    than a session was seen to lose (1-7)."""
    slept = []
    monkeypatch.setattr(profiling.time, "sleep", slept.append)
    with profiling.profiler() as prof:
        assert slept == [profiling.SETTLE_S]
        assert prof.profiler is not None
    assert profiling.SETTLE_S >= 10 * 0.009
    assert profiling.PRIMER_LAUNCHES >= 4 * 7


def _ev(cat, name, ts, dur, corr=None):
    args = {} if corr is None else {"correlation": corr}
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def test_trace_counts_on_a_hand_written_trace():
    """chip_smoke's helper counts the hand kernels' device events by
    symbol (not torch's kernels that share a word of the name), their sums,
    the events without a CPU launch, the ranges, the host ops and the
    card's busy time (the union of the device intervals), with the
    session's primer left out, and the launches that have no device
    event, the primer's apart."""
    chunk = ("void (anonymous namespace)::detect_chunk_kernel<false, true>"
             "((anonymous namespace)::Params)")
    merge = ("void (anonymous namespace)::merge_unordered_kernel("
             "(anonymous namespace)::Params)")
    trace = {"traceEvents": [
        _ev("user_annotation", "B1 detect_cands", 0, 5),
        _ev("user_annotation", "B1 detect_cands", 20, 5),
        _ev("user_annotation", "B2 slice_windows", 40, 5),
        _ev("cuda_runtime", "cudaLaunchKernel", 1, 1, corr=11),
        _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, corr=12),
        _ev("cuda_driver", "cuLaunchKernel", 21, 1, corr=13),
        # corr 14 and 15 have no launch on the host
        _ev("kernel", chunk, 100, 10, corr=11),
        _ev("kernel", merge, 112, 3, corr=12),
        _ev("kernel", chunk, 120, 12, corr=13),
        _ev("kernel", merge, 135, 2, corr=14),
        _ev("kernel", "void at::native::direct_copy_kernel_cuda(int)",
            130, 10, corr=15),
        _ev("kernel", "void (anonymous namespace)::copy_kernel(float4 "
                      "const*, float4*, long long)", 150, 4),
        _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 90, 5),
        dict(_ev("cpu_op", "aten::add", 3, 1), tid=7),
        dict(_ev("cpu_op", "aten::sort", 4, 1), tid=7),
        dict(_ev("cpu_op", "aten::empty", 22, 1), tid=9),
        _ev("user_annotation", "profiler primer", -50, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", -45, 1, corr=9),
        _ev("cuda_runtime", "cudaLaunchKernel", -48, 1, corr=8),
        _ev("kernel", "void at::native::vectorized_elementwise_kernel<4>()",
            60, 2, corr=8),
        _ev("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=16),
        _ev("cuda_runtime", "cudaMemcpyAsync", 31, 1, corr=17),
        {"ph": "i", "cat": "kernel", "name": chunk, "ts": 0},
    ]}
    c = _smoke().trace_counts(trace)
    assert c["kernels"]["detect_chunk_kernel"] == 2
    assert c["kernels"]["merge_unordered_kernel"] == 2
    assert c["kernels"]["copy_kernel"] == 1
    assert c["kernels"]["merge_ordered_kernel"] == 0
    assert c["kernel_us"]["detect_chunk_kernel"] == 22.0
    assert c["kernel_us"]["merge_unordered_kernel"] == 5.0
    assert c["orphans"] == dict(c["orphans"], merge_unordered_kernel=1,
                                copy_kernel=1)
    assert sum(c["orphans"].values()) == 2
    assert c["ranges"] == {"B1 detect_cands": 2, "B2 slice_windows": 1,
                           "profiler primer": 1}
    # the primer's kernel (launch 8) is left out of the step's figures
    assert c["device_events"] == 7
    assert c["by_name"][chunk] == [2, 22.0]
    assert c["by_name"]["Memcpy HtoD (Pageable -> Device)"] == [1, 5.0]
    assert not any("vectorized" in k for k in c["by_name"])
    assert (c["host_ops"], c["host_threads"]) == (3, 2)
    # launches 9 (the primer's) and 16 have no device event; a copy is no
    # launch
    assert (c["lost"], c["primer_lost"]) == (1, 1)
    # kernel 11 at 100 was launched at 1, chunk 13 at 120 at 21
    assert c["lead_us"] == 0.0
    # [90, 95] [100, 110] [112, 115] [120, 140] [150, 154]
    assert c["busy_us"] == 5 + 10 + 3 + 20 + 4


def test_trace_counts_reads_a_file(tmp_path):
    """From a file; a device event that starts before its launch on the
    trace's clock gives the offset."""
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        _ev("kernel", "slice_windows_kernel(int)", 0, 2, corr=1),
        _ev("kernel", "slice_windows_kernel(int)", 5, 2, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 8.5, 1, corr=2)]}))
    c = _smoke().trace_counts(str(path))
    assert c["kernels"]["slice_windows_kernel"] == 2
    assert c["orphans"]["slice_windows_kernel"] == 1
    assert c["busy_us"] == 4.0
    assert c["lead_us"] == 3.5
    assert (c["lost"], c["primer_lost"]) == (0, 0)


def test_kernel_libraries_name_their_cuda_runtime(monkeypatch):
    """The libraries link nvcc's static runtime, named in the flags so that
    a toolkit's default cannot change it: launches through it reach the
    profiler's trace (on the card: trace_check.py, chip_smoke phase 17),
    and its error state holds the library's own launches alone. The choice
    is part of each library's build hash."""
    flags = _ext.NVCC_FLAGS
    i = flags.index("--cudart")
    assert flags[i + 1] == "static"
    assert "--fmad=false" in flags and "-shared" in flags
    built = _ext._target("detect_cands")
    monkeypatch.setattr(_ext, "NVCC_FLAGS", flags[:i] + flags[i + 2:])
    assert _ext._target("detect_cands") != built
