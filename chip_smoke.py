#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (nvcc, one
process per source, all at once), then:

  1. prints the card (nvidia-smi name and power limit) and the build time;
  2. holds kernel B1 (preamble detect + candidate extraction) against its
     plain PyTorch version on the card, at DspConfig() with 8 channels, on
     mixed traffic (~100 msg/s, 15 dB), dense traffic (more hits than K per
     block) and silence, and on mixed traffic at 4 Msps: exactly equal;
  3. holds kernel B2 (per-detection power windows) against its plain version
     on the window starts of phase 2 (sps 1 and 2), with empty rows, a
     window at the last owned sample and one at each residue mod 16, at the
     demod paths' width and the reference's, with and without the prescreen
     widening: exactly equal; then times a one-element add, the launch
     floor;
  4. holds kernel B3/B4 (detect mask and reference level on f32 I/Q)
     against its plain version, mask and ref bit for bit: on the mixed,
     dense and silence batches at C = 8 (B4) and on their first blocks at
     C = 1 (B3), on int8 and int16 input, and at 4 Msps;
  5. launches B1, B2 (both widths) and B3/B4 100 times on each input of
     phases 2-4 into buffers flanked by guard zones, with the allocator
     churned between runs: equal to a fresh plain result every run, no
     write outside a buffer, no element of one left unwritten;
  6. drives the int8 path, `run_native_pipelined` on a uc8 capture of 32
     blocks of 2^20 samples: at least 99% of each DF's injected frames must
     decode, B1 and B2 must have launched, the first batch's packed table
     must equal the CPU's (noise within rtol 1e-5), and the messages of
     every batch must equal those of the same runner on the CPU;
  7. drives the f32 path, `IQStream.blocks()` into `run_pipelined` (batch 8,
     kernel B4) on a complex64 capture of 32 blocks, with the same checks;
     then `run_pipelined` at batch 1 over 4 blocks (kernel B3) and
     `run_channels` over two channels of 4 blocks, each equal to the CPU;
  8. holds B1's variants B5o (ordered=True) and B5p (prescreen=True)
     against their plain versions, as phase 2 does B1 (C = 8 at
     DspConfig(): tile 131072, per_lane 8, per_tile 128; and at 4 Msps),
     and kernel B6 (the 1-D detect) as phase 4 does B3/B4, at C = 8 and
     C = 1, f32 and int8, 2, 4 and 20 Msps (sps 1, 2, 10), and on a block
     with a NaN and an Inf sample; then 100 guarded repeats of each, as
     phase 5;
  9. drives the planar path's options over phase 6's uc8 capture, batches
     of 8 through `demod_batch_packed_planar` with ordered=True (B5o),
     prescreen=True (B5p, stage B) and xla_gather=True; and the 1-D path
     over phase 7's complex64 capture through `demod_batch_packed_1d`
     (B6, C = 8), 4 of its blocks through `demod_block_packed_1d` (B6,
     C = 1), and an 8-block 20 Msps capture through
     `demod_batch_packed_1d`: each at least 99% of each DF, its kernels
     launched, every batch's packed table equal to the CPU's (noise within
     rtol 1e-5, 1e-4 on the 1-D path's full-block noise floor);
 10. runs phase 6's messages through the port's decode and output layers:
     `parse`, `output_print` (into a list) and `output_sql` (a temporary
     SQLite file); every injected address must appear in the reports and
     every DF17 identification's callsign must re-encode to the injected
     frame;
 11. drives `run_native_pipelined` with `DspConfig(channel_rate=20e6)`,
     which the planar kernels refuse, over an 8-block uc8 capture: the
     full-block path on the card (no hand kernel launches), at least 99%
     of each DF, every message equal to the CPU's;
 12. drives `run_native_channels` over four uc8 captures of 8, 8, 6 and 3
     blocks at `DspConfig()`: B1 and B2 must launch, each channel must
     decode at least 99% of each DF, an ended channel must yield None, and
     every step must equal the CPU's; prints its end-to-end Msps;
 13. drives the resampled front end: `run_resampled_fused` over a 32-block
     complex64 capture recorded at 10 Msps (p/q = 1/5) to `DspConfig()`,
     batches of 8 (group-matmul resample with TF32 off, device AGC, int8
     quantize, kernels B1 and B2), then `run_resampled_fused_channels` at
     C = 4 over 6 Msps captures of 4, 4, 3 and 2 blocks to 4 Msps (p/q =
     2/3); each batch's AGC gains must equal the CPU's within rtol 1e-6 and
     its int8 >= 99.99% (never more than 1 apart), every block's messages
     the CPU's field by field (ref_dbfs within 0.1 dB), B1 and B2 must
     launch and every DF decode at >= 99%; prints the device step, the
     group matmuls' share of it, the host-to-card copy and the end-to-end
     rate; then the host path (the streaming resampler on the card ->
     `run_pipelined`) over 8 blocks, and its rate; the streaming
     resampler with its stride eager and graphed (the same samples bit
     for bit), its rate and one stride's time each way, as the host sees
     it and on the card alone;
 14. runs the CLI in-process, `airmodes_torch.apps.modes_rx.main`, with
     --int8 on phase 6's uc8 capture (the native runner), -r 10e6 --int8
     on phase 13's capture (the fused path) and with two of phase 12's
     captures (the channel runner): each must exit 0, write the SQLite
     aircraft rows of the library runner's messages through `parse` and
     `output_sql`, and a stats record with the runner's counters;
 15. drives the sharded path (`airmodes_torch.dist`):
     `PodPipeline(DspConfig(), n_channel=2, n_time=4)` chooses the planar
     path on the card and streams two channels of mixed traffic (4 steps
     plus a 4,321-sample tail, frames planted across shard and step
     boundaries) through `run_stream`: every step's messages must equal
     the same pipeline's on the CPU, and the unsharded planar step's over
     the same blocks, every DF decode at >= 99%, every boundary frame
     decode, and B1 and B2 launch once per step; prints the step against
     the unsharded 8-block step and the end-to-end rate; then the f32
     pipeline over the first two steps (== the CPU's), the fused
     resample -> int8 -> planar step on a (1, 4) mesh at a fixed gain
     from 10 Msps (== the CPU's and the unsharded fused step's, under
     phase 13's contract), and the (1, 4) planar step through a one-rank
     NCCL process group (== the local mesh's tables); `step3_fn` eager
     against graphed (equal bit for bit), each as the host sees it and on
     the card alone, and both profiled;
 16. runs the probes (`airmodes_torch.probes`) at their TPU scripts' sizes:
     P1-P3 (copy and bulk-copy reads over 1 GiB of f32; first also at
     2^21 - 3, 1000 and 100 rows: a ragged tail, fewer windows than SMs,
     no window), P4 (kernel B4 cut after each stage of its rule, C = 16
     blocks of 2^22) and P5 (the planar path's load floor, C = 64 blocks
     of 2^22), each launched once with its count at 0 and held exactly
     against its plain version, P4's stage 5 also against B4; then each
     probe's readings (the planar stage split among them; P1-P3 beside
     `x + 1.0`, `torch.sum` and the windows' sums in one call, each in
     GB/s of its own bytes), failing any rate above 105% of 3.35 TB/s;
     P2's and P3's output in one PyTorch call (`torch.matmul` of
     ones(8, 144) with each window, their `library_ms`), held against
     P2's at every size;
 17. checks that the port's profiler trace shows every hand-kernel launch
     (fault C2): `modes_rx --int8 --profile` over phase 6's capture (its
     runner replays the compiled step), each kernel's device events equal
     to its wrapper's launch count (B1 two kernels a call), each with its
     CPU launch (a replay's graph launch), and a "graph <step>" range per
     replay; a "B1 detect_cands" / "B2 slice_windows" range per wrapper
     call for B1 and B2 launched bare, with no torch kernel beside them
     and with one between, and for the eager int8 step; the compiled
     step's replays, B1 and B2 once each, none lost; 40 sessions of one int8 step, none losing a
     device event of its work; at C = 64 blocks of 2^22, B1's summed
     trace time within 5% of its card time behind a spin, and the step's
     trace busy time beside its card time (the step profiles of phases 6,
     7, 13 and 15 hold their kernels on every rep too);
 18. runs the entry points no other phase calls, each against the port's
     CPU run: `golden.snr_sweep` at DspConfig() from 4 to 14 dB (200 DF17
     messages a point; the same decoded set at each), printing the
     waterfall; `multihost.scaling_report` over the (1, 1) ... (2, 4)
     meshes after one (2, 4) step equal to the CPU's, printing each row;
     `python -m airmodes_torch.dist.multihost --device cuda` (exit 0, the
     card's name); `modes_gui --device cuda` headless on the synthetic
     source and on a 4 Msps capture with -r 4e6, blocks of 2^20 (the CPU
     run's aircraft rows), and its Qt backend where Qt imports;
 19. runs the bench's functions (`airmodes_torch.bench`) at reduced sizes:
     the planar step over BENCH_C blocks of 2^22 (the decode accounting
     equal to the CPU's), the device, streaming and h2d loops, sps 5, the
     fused resample step, PodPipeline, the native framer, modes_rx end to
     end and its multi-channel aggregate; each figure must pass its own
     check, launch B1 and B2 where it runs the planar step, and decode
     what the same call decodes on the CPU;
 20. holds every compiled step (the `*_jit` entry points: captured CUDA
     graphs, `airmodes_torch.utils.graphs`) against its eager function on
     the card, bit for bit, and against the CPU: the planar step on phase
     6's capture at its defaults and with ordered, prescreen and
     xla_gather; B3 and B4 on phase 7's; the 1-D steps at sps 2 and 10;
     the fused resample step on phase 13's; the full-block steps; each on
     two inputs (a replay on new inputs, two outputs in flight), its
     launches per replay, its graph's kernel nodes by symbol, and its step
     time eager against graphed; the graphed int8 and f32 steps'
     profiles; and that the noise floor's scan of one row gives one
     result every run (fault C3), beside torch.cumsum's. Then the same
     for `dist/` and the resampler: the six sharded factories' local
     steps on phase 15's (2, 4) mesh (the resample ones at 10 -> 2 Msps),
     each factory's step == its graph's eager step; the (1, 4) planar
     step through a one-rank NCCL group; `PodPipeline.step3_fn`, planar
     and f32; the streaming resampler's stride and `resample` on complex
     input; the (1, 1) f32 sharded step on one block, 20 replays equal.
     Phases 6, 7, 11-15 and 19 run the runners, the pipeline and the
     bench, whose steps are these graphs;
 21. runs the graft entry points (`airmodes_torch.graft_entry`, the
     counterpart of `__graft_entry__.py`): entry()'s compiled step twice
     (equal bit for bit, and equal to the CPU's) and its time, graphed, as
     the host sees it and on the card alone; `dryrun_multichip(1)` and
     `_dryrun_steps(8)` (the (1, 8) mesh on this one card), every sharded
     step and PodPipeline stream against the port's CPU run, B1 and B2
     launched by every planar step, every B1 and B2 call held against its
     plain version on its own inputs; the planar steps again on DF17
     frames at each mesh (tables == the CPU's, every frame decoded);
     `python -m airmodes_torch.graft_entry` (exit 0, the card's name in
     its output);
 22. times the native framer alone (`native/iqstream.cc`, no card): 32
     blocks of an in-memory sc16 file at the 20 Msps geometry and of a
     uc8 file at 2 Msps, each pumped into a ring that holds all of it and
     then framed with the AGC; prints ms a block of the pump and of the
     framing, and holds every row, start and gain bit for bit against
     `quantize_planar_i8_np` over the same frames;
 23. times a block's table turned into wire lines, on the host: the Python
     rule (`dsp/host.table_to_messages` on `unpack_table`) against the
     native pass (`native.WireLines`, `native/wire.cc`) on 16 packed
     tables at replay 16ch's shape (52 frames and 20 CRC failures in 128
     slots), lines and BlockStats equal; the pass called holding the
     GIL (as bound) against letting go of it (a plain ctypes call) beside
     0, 1 and 3 threads that run Python; then a short
     `run_native_channels` run on the card, every row of which the pass
     must have formatted (`io/stream.WIRE_ROWS`);
 24. prints one JSON line of per-kernel numbers, the card line, and last
     {"ok": true, "device": {...}}.

Any failure raises and exits nonzero. Without a CUDA card, or without the
rest of the repository beside it, it exits nonzero and prints no result.
The port imports no JAX; neither does this script.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import tempfile
import time

N_MAIN_BLOCKS = 32
BATCH = 8
REPEAT = 100                 # guarded kernel-vs-plain runs per input
CANARY = -0x21524111         # 0xDEADBEEF: no count, index or power has it
GUARD = 4096                 # int32 guard elements on each side of a buffer


# --- captures ----------------------------------------------------------------

def frame_planar(iq, cfg, n_blocks, gain):
    """Overlapped blocks of a capture (zero-padded at its edges), quantized
    to int8 with a fixed gain, as (n_blocks, P) planar I and Q rows."""
    import numpy as np
    from airmodes_torch.dsp.host import quantize_i8_np
    from airmodes_torch.kernels.preamble import planar_length
    left, n, right = cfg.left_halo, cfg.block_size, cfg.right_halo
    p = planar_length(cfg)
    xi = np.zeros((n_blocks, p), np.int8)
    xq = np.zeros((n_blocks, p), np.int8)
    for k in range(n_blocks):
        pos = k * n
        lo, hi = max(pos - left, 0), min(pos + n + right, len(iq))
        seg = iq[lo:hi]
        at = left - (pos - lo)
        xi[k, at: at + len(seg)] = quantize_i8_np(seg.real, gain)
        xq[k, at: at + len(seg)] = quantize_i8_np(seg.imag, gain)
    return xi, xq


def mixed_capture(cfg, n_blocks, msg_rate_hz=100.0, snr_db=15.0, seed=0,
                  spacing=None, planar=True):
    """Mixed traffic (every supported DF) over n_blocks blocks, AGC to a
    peak of 120, as ((planar I, Q) or None, f32 blocks), truth; spacing
    defaults to the message rate's."""
    import numpy as np
    from airmodes_torch.testing import encoder
    total = n_blocks * cfg.block_size
    if spacing is None:
        n_msgs = max(int(total / cfg.channel_rate * msg_rate_hz), 8)
        spacing = total // n_msgs
    else:
        n_msgs = total // spacing
    frames = encoder.random_mixed_frames(n_msgs, seed=seed)
    iq, truth = encoder.make_capture(
        frames, rate=cfg.channel_rate, snr_db=snr_db, spacing=spacing,
        seed=seed, total_samples=total)
    gain = 120.0 / (float(np.max(np.abs(iq))) or 1.0)
    return (frame_planar(iq, cfg, n_blocks, gain) if planar else None,
            frame_f32(iq, cfg, n_blocks, gain / 127.0)), truth


def frame_f32(iq, cfg, n_blocks, scale):
    """Overlapped blocks of a capture (zero-padded at its edges) as
    (n_blocks, L+N+R, 2) interleaved f32 I/Q, scaled by `scale`."""
    import numpy as np
    left, n, right = cfg.left_halo, cfg.block_size, cfg.right_halo
    out = np.zeros((n_blocks, left + n + right, 2), np.float32)
    for k in range(n_blocks):
        pos = k * n
        lo, hi = max(pos - left, 0), min(pos + n + right, len(iq))
        seg = iq[lo:hi]
        at = left - (pos - lo)
        out[k, at: at + len(seg), 0] = seg.real * scale
        out[k, at: at + len(seg), 1] = seg.imag * scale
    return out


def wire(x, dtype):
    """Unit-scale f32 I/Q quantized to an SDR wire format (int8: the
    repository's quantize rule at full scale 127; int16: 32767)."""
    import numpy as np
    from airmodes_torch.dsp.host import quantize_i8_np
    if dtype == np.int8:
        return quantize_i8_np(x, 127.0)
    return np.clip(np.round(x * 32767.0), -32767, 32767).astype(np.int16)


def write_capture(cfg, path, n_blocks, seed=1, fmt="uc8"):
    """uc8 (rtl-sdr byte format) or complex64 capture of mixed traffic, 13
    frames per block at 18 dB, cut from one frame list so that every DF
    appears; returns the ground truth with global sample indices."""
    import numpy as np
    from airmodes_torch.testing import encoder
    truth = []
    every = encoder.random_mixed_frames(13 * n_blocks, seed=seed)
    with open(path, "wb") as f:
        for b in range(n_blocks):
            frames = every[13 * b: 13 * b + 13]
            iq, tr = encoder.make_capture(
                frames, rate=cfg.channel_rate, snr_db=18.0,
                spacing=cfg.block_size // 14, seed=seed * 1000 + b,
                total_samples=cfg.block_size)
            for t in tr:
                t.sample_index += b * cfg.block_size
            truth += tr
            x = iq / (float(np.max(np.abs(iq))) or 1.0) * 0.9
            if fmt == "complex64":
                x.astype(np.complex64).tofile(f)
                continue
            u = np.empty(2 * cfg.block_size, np.uint8)
            u[0::2] = np.round(x.real * 127.5 + 127.5).astype(np.uint8)
            u[1::2] = np.round(x.imag * 127.5 + 127.5).astype(np.uint8)
            u.tofile(f)
    return truth


# --- timing ------------------------------------------------------------------

def time_ms(fn, iters=20, flush=None, device_only=True):
    """airmodes_torch.probes.time_ms, the one timing harness of the port
    (kernel_times.py reaches it through this module)."""
    from airmodes_torch.probes import time_ms as timed
    return timed(fn, iters=iters, flush=flush, device_only=device_only)


def smi_line() -> str:
    """airmodes_torch.probes.smi_line: the card's name and power limit
    (kernel_times.py reaches it through this module)."""
    from airmodes_torch.probes import smi_line as line
    return line()


VARIANTS = {"B1": {"ordered": False}, "B5o": {"ordered": True},
            "B5p": {"ordered": False, "prescreen": True},
            "B5o per_lane 12": {"ordered": True, "per_lane": 12}}


# --- phases ------------------------------------------------------------------

def phase_b1(cfg, inputs, dev, flush, variant="B1"):
    """B1 (or its variant B5o, B5p: VARIANTS) kernel vs plain on the card
    for each named (xi, xq) input; returns (results per input, max abs
    error, timing of the first)."""
    import torch
    from airmodes_torch.kernels import preamble as K
    tile = K.default_tile(cfg)
    kw = VARIANTS[variant]
    out, worst, timing = {}, 0, None
    for name, (xi, xq) in inputs.items():
        ti = torch.as_tensor(xi).to(dev)
        tq = torch.as_tensor(xq).to(dev)
        got = K.preamble_detect_cands_planar(ti, tq, cfg, **kw)
        want = K.detect_cands_plain(ti, tq, cfg, tile, **kw)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        hits = int(want[:, :, 4].sum())
        if kw.get("ordered"):
            det, valid, n_det, ovf = K.compact_candidates(want, cfg, tile)
        else:
            det, valid, n_det, ovf = K.compact_candidates_unordered(
                want, cfg, tile)
        print(f"{variant} sps={cfg.sps} {name}: hits {hits}, overflow "
              f"{int(ovf.sum())}, max |kernel - plain| {err}", flush=True)
        if not torch.equal(got, want):
            # which side is off: a second run of each, and whether each
            # holds only encodings and counts a tile can produce
            again = K.detect_cands_plain(ti, tq, cfg, tile, **kw)
            got2 = K.preamble_detect_cands_planar(ti, tq, cfg, **kw)
            sane = [bool(((x[:, :, :5] >= 0) & (x[:, :, :5] <= tile)).all())
                    for x in (got, want)]
            raise AssertionError(
                f"{variant} kernel != plain on {name} (sps={cfg.sps}); "
                f"plain repeats: {torch.equal(again, want)}, kernel "
                f"repeats: {torch.equal(got2, got)}, kernel == plain "
                f"rerun: {torch.equal(got, again)}, in range (kernel, "
                f"plain): {sane}")
        worst = max(worst, err)
        out[name] = (ti, tq, det, valid, int(ovf.sum()))
        if timing is None:
            timing = (
                time_ms(lambda: K.preamble_detect_cands_planar(ti, tq, cfg,
                                                               **kw),
                        flush=flush),
                time_ms(lambda: K.detect_cands_plain(ti, tq, cfg, tile, **kw),
                        iters=5, flush=flush),
                ti.numel() + tq.numel(),
                cfg.block_size * ti.shape[0],
            )
    return out, worst, timing


def b2_bases(cfg, ti, det, valid):
    """B2's window starts on a (C, P) batch and B1's detections on it: the
    detections' windows (-1 for an empty table row), then a window at the
    last owned sample, an empty row, a window at sample 0, and one window
    at each residue mod 16 (int32, on the batch's device)."""
    import torch
    C, p = ti.shape
    chan0 = torch.arange(C, dtype=torch.int32, device=ti.device)[:, None]
    base = torch.where(valid, chan0 * p + cfg.left_halo + det
                       - cfg.noise_window, -1).reshape(-1)
    last = (C - 1) * p + cfg.left_halo + cfg.block_size - 1 \
        - cfg.noise_window
    more = [last, -1, 0] + [p + 2048 + 17 * r for r in range(16)]
    return torch.cat([base, torch.tensor(more, dtype=torch.int32,
                                         device=ti.device)]).to(torch.int32)


def b2_widths(cfg):
    """(name, extra, columns) of every B2 form the phases check: the demod
    paths' width (out_rows*128) and the reference's (pad_rows*128), each
    plain and widened by the prescreen path's NMS half-window."""
    from airmodes_torch.kernels import preamble as K
    half = cfg.nms_chips * cfg.sps
    return [(f"{w} width, extra {e}", e, K._slice_cols(cfg, e, w == "main"))
            for e in (0, half) for w in ("main", "reference")]


def phase_b2(cfg, b1_out, flush):
    """B2 kernel vs plain, bit for bit, on the window starts of B1's
    detections plus a window at the last owned sample, empty rows and a
    window at each residue mod 16, at both widths, with and without the
    prescreen path's widening. Returns (max abs error, timing of the first
    input's detections and the first 3 extra windows at extra 0: {width:
    (ms, plain ms, samples read, columns written)} and the yardstick's ms)."""
    import torch
    from airmodes_torch.kernels import preamble as K
    worst, timing = 0.0, None
    for name, (ti, tq, det, valid, _) in b1_out.items():
        base = b2_bases(cfg, ti, det, valid)
        ri, rq = ti.reshape(-1, 128), tq.reshape(-1, 128)
        n_valid = int((base >= 0).sum())
        for what, extra, cols in b2_widths(cfg):
            got = K._slice_windows(ri, rq, base, cfg, extra, cols)
            want = K.slice_windows_plain(ri, rq, base, cfg, extra, cols)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            print(f"B2 sps={cfg.sps} {name}, {what} ({cols} columns): "
                  f"{base.numel()} windows ({n_valid} non-empty, 16 "
                  f"residues mod 16), max |kernel - plain| {err}",
                  flush=True)
            if not torch.equal(got, want):
                raise AssertionError(f"B2 kernel != plain on {name}, {what}")
            worst = max(worst, err)
        if timing is None:
            bt = base[: det.numel() + 3]
            n_in = int((bt >= 0).sum()) * K._slice_cols(cfg)
            timing = {}
            for width in ("main", "reference"):
                cols = K._slice_cols(cfg, 0, width == "main")
                timing[width] = (
                    time_ms(lambda: K._slice_windows(ri, rq, bt, cfg, 0,
                                                     cols), flush=flush),
                    time_ms(lambda: K.slice_windows_plain(ri, rq, bt, cfg,
                                                          0, cols),
                            flush=flush),
                    n_in, bt.numel() * cols)
            # yardstick: one advanced-indexing gather of the windows' int8
            # pairs (no power, no zero columns)
            j = torch.arange(K._slice_cols(cfg), device=ti.device)
            idx = (bt.clamp(min=0).to(torch.int64)[:, None] + j).clamp(
                max=ri.numel() - 1)
            both = torch.stack([ri.reshape(-1), rq.reshape(-1)])
            timing["library"] = time_ms(lambda: both[:, idx], flush=flush)
    return worst, timing


def _guarded(n_elems, dev):
    """One int32 buffer of `n_elems` between two guard zones, all filled
    with CANARY; returns (whole buffer, the n_elems view)."""
    import torch
    buf = torch.full((n_elems + 2 * GUARD,), CANARY, dtype=torch.int32,
                     device=dev)
    return buf, buf[GUARD: GUARD + n_elems]


def _check_guarded(buf, inner, what):
    """Raise unless both guard zones still hold CANARY (no write outside
    the buffer) and no element of it does (every element written)."""
    for zone in (buf[:GUARD], buf[-GUARD:]):
        if not bool((zone == CANARY).all()):
            raise AssertionError(f"{what}: a write landed outside the "
                                 f"output buffer")
    if bool((inner == CANARY).any()):
        raise AssertionError(f"{what}: {int((inner == CANARY).sum())} "
                             f"output elements left unwritten")


def phase_repeat(cfg, b1_out, dev, iters, variant="B1"):
    """B1 (or its variant, VARIANTS) launched `iters` times on each input
    of phase 2, into guarded buffers, each time against a fresh plain
    result, and with B1 also B2 on the windows of phase 3 at both widths
    (the prescreen widening on odd runs); between runs the caching
    allocator is churned with blocks of CANARY so that each run lands on
    other addresses and stale data would show."""
    import numpy as np
    import torch
    from airmodes_torch.kernels import preamble as K
    tile = K.default_tile(cfg)
    kw = VARIANTS[variant]
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    for name, (ti, tq, det, valid, _) in b1_out.items():
        C, p = ti.shape
        base = b2_bases(cfg, ti, det, valid)
        ri, rq = ti.reshape(-1, 128), tq.reshape(-1, 128)
        s_shape, o_shape = K.detect_cands_buffers(C, cfg, tile)
        for it in range(iters):
            churn = torch.full((int(rng.integers(1, 1 << 22)),), CANARY,
                               dtype=torch.int32, device=dev)
            sbuf, scratch = _guarded(int(np.prod(s_shape)), dev)
            obuf, out = _guarded(int(np.prod(o_shape)), dev)
            K.launch_detect_cands(ti, tq, cfg, tile, scratch.view(s_shape),
                                  out.view(o_shape), **kw)
            want = K.detect_cands_plain(ti, tq, cfg, tile, **kw)
            checks = [(sbuf, scratch, f"{variant} scratch"),
                      (obuf, out, f"{variant} output")]
            windows = []
            if variant == "B1":
                for what, extra, cols in b2_widths(cfg)[2 * (it % 2):][:2]:
                    w_shape = (base.numel(), cols)
                    wbuf, w = _guarded(int(np.prod(w_shape)), dev)
                    K.launch_slice_windows(
                        ri, rq, base, cfg,
                        w.view(torch.float32).view(w_shape), extra=extra)
                    windows.append((w.view(torch.float32).view(w_shape),
                                    K.slice_windows_plain(ri, rq, base, cfg,
                                                          extra, cols),
                                    what))
                    checks.append((wbuf, w, f"B2 output, {what}"))
            del churn
            for b, inner, what in checks:
                _check_guarded(b, inner, f"{what} on {name}, run {it}")
            if not torch.equal(out.view(o_shape), want):
                raise AssertionError(f"{variant} kernel != plain on {name}, "
                                     f"run {it}")
            for got_w, want_w, what in windows:
                if not torch.equal(got_w, want_w):
                    raise AssertionError(f"B2 kernel != plain on {name}, "
                                         f"{what}, run {it}")
    what = "B1 and B2 (both widths)" if variant == "B1" else variant
    print(f"repeat: {what} x{iters} on each of {list(b1_out)} "
          f"(sps={cfg.sps}): equal to plain every run, guards intact, every "
          f"output element written ({time.perf_counter() - t0:.2f} s)",
          flush=True)


def _ref_equal(got, want) -> bool:
    """Reference levels equal bit for bit, NaN where the other has NaN
    (the card's arithmetic gives one NaN pattern, the CPU's another)."""
    import torch
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        torch.where(nan, 0.0, got).view(torch.int32),
        torch.where(nan, 0.0, want).view(torch.int32))


def phase_b34(cfg, inputs, dev, flush, one_d=False, tile=None):
    """B3/B4 kernel (B6 with one_d) vs plain on the card for each named
    (C, L, 2) input (C = 1 takes the one-block wrapper, C > 1 the batch
    wrapper), at `tile` (default: the runners' choice): mask and ref bit
    for bit. Returns ({name: operands}, max abs error, {C: timing of the
    first f32 input with that C})."""
    import torch
    from airmodes_torch.kernels import preamble as K
    if one_d:
        kid, tile = "B6", tile or 16384
        one_ops, one, batch_ops, batch = (
            K.b6_operands, K.preamble_detect_1d, K.b6_operands,
            K.preamble_detect_1d_batch)
    else:
        kid, tile = "B3/B4", tile or K.supported_2d_tile(cfg)
        one_ops, one, batch_ops, batch = (
            K.b3_operands, K.preamble_detect_2d, K.b4_operands,
            K.preamble_detect_2d_batch)
    out, worst, timing = {}, 0.0, {}
    for name, x in inputs.items():
        xt = torch.from_numpy(x).to(dev)
        C = xt.shape[0]
        if C == 1:
            ops = one_ops(xt[0], cfg, tile)
            got = [g[None] for g in one(xt[0], cfg, tile)]
        else:
            ops = batch_ops(xt, cfg, tile)
            got = batch(xt, cfg, tile)
        want = K.detect_mask_plain(*ops, cfg, one_d)
        torch.cuda.synchronize()
        fin = torch.isfinite(want[1]) & torch.isfinite(got[1])
        err = max(float((got[0] - want[0]).abs().max()),
                  float(torch.where(fin, got[1] - want[1], 0.0).abs().max()))
        print(f"{kid} sps={cfg.sps} {name} (C={C}, {x.dtype}): hits "
              f"{int(want[0].sum())}, max |kernel - plain| {err}",
              flush=True)
        mask_eq = torch.equal(got[0], want[0])
        ref_eq = _ref_equal(got[1], want[1])
        if not (mask_eq and ref_eq):
            again = K.detect_mask_plain(*ops, cfg, one_d)
            raise AssertionError(
                f"{kid} kernel != plain on {name} (sps={cfg.sps}); mask "
                f"equal: {mask_eq}, ref bits equal: {ref_eq}, plain "
                f"repeats: {torch.equal(again[0], want[0])}")
        worst = max(worst, err)
        out[name] = ops
        if C not in timing and x.dtype.name == "float32":
            fn = ((lambda: one(xt[0], cfg, tile)) if C == 1
                  else (lambda: batch(xt, cfg, tile)))
            timing[C] = (time_ms(fn, flush=flush),
                         time_ms(lambda: K.detect_mask_plain(*ops, cfg,
                                                             one_d),
                                 iters=5, flush=flush),
                         C * ops[1] * 8 + 2 * C * cfg.block_size * 4,
                         C * cfg.block_size)
    return out, worst, timing


def phase_repeat_b34(cfg, b34_out, dev, iters, one_d=False):
    """B3/B4 (B6 with one_d) launched `iters` times on each input of
    phase_b34 into guarded buffers, each time against a fresh plain
    result, with the allocator churned between runs (as phase_repeat)."""
    import numpy as np
    import torch
    from airmodes_torch.kernels import preamble as K
    kid = "B6" if one_d else "B3/B4"
    rng = np.random.default_rng(8)
    n = cfg.block_size
    t0 = time.perf_counter()
    for name, (x, valid, length) in b34_out.items():
        C = x.shape[0]
        for it in range(iters):
            churn = torch.full((int(rng.integers(1, 1 << 22)),), CANARY,
                               dtype=torch.int32, device=dev)
            mbuf, m = _guarded(C * n, dev)
            rbuf, r = _guarded(C * n, dev)
            K.launch_detect_mask(x, valid, cfg, m.view(C, n),
                                 r.view(torch.float32).view(C, n), one_d)
            want_m, want_r = K.detect_mask_plain(x, valid, length, cfg,
                                                 one_d)
            del churn
            for b, inner, what in ((mbuf, m, f"{kid} mask"),
                                   (rbuf, r, f"{kid} ref")):
                _check_guarded(b, inner, f"{what} on {name}, run {it}")
            if not (torch.equal(m.view(C, n), want_m) and _ref_equal(
                    r.view(torch.float32).view(C, n), want_r)):
                raise AssertionError(f"{kid} kernel != plain on {name}, "
                                     f"run {it}")
    print(f"repeat: {kid} x{iters} on each of {list(b34_out)} "
          f"(sps={cfg.sps}): equal to plain every run, guards intact, every "
          f"output element written ({time.perf_counter() - t0:.2f} s)",
          flush=True)


# the device symbols of the hand kernels, as a profiler trace names them
# ("void (anonymous namespace)::detect_chunk_kernel<false, true>(...)"): a
# B1/B5 call launches a chunk and a merge kernel, every other wrapper one
KERNEL_SYMBOLS = ("detect_chunk_kernel", "merge_unordered_kernel",
                  "merge_ordered_kernel", "slice_windows_kernel",
                  "detect_mask_kernel", "copy_kernel", "dma_read_kernel",
                  "ring_read_kernel", "detect_ablate_kernel",
                  "planar_floor_kernel")
# what one unordered B1 call and one B2 call put on the card
B1_B2_SYMBOLS = ("detect_chunk_kernel", "merge_unordered_kernel",
                 "slice_windows_kernel")


def trace_counts(trace):
    """What a torch.profiler Chrome trace (a path, or its parsed JSON)
    holds, the session's primer (`utils.profiling.PRIMER`: the kernels
    launched inside that range) left out but for "primer_lost":

      kernels, kernel_us, orphans: per symbol of KERNEL_SYMBOLS, its device
          events, their summed us, and those whose correlation id no CPU
          launch event (cuda_runtime, cuda_driver) carries;
      by_name: {name: [count, summed us]} of every kernel, copy and memset;
      device_events, busy_us: their number, the union of their intervals;
      ranges: {name: host ranges (record_function, "B1 detect_cands";
          "graph <step>" around a graph's replay, "graph capture <step>"
          around its capture)};
      host_ops, host_threads: torch ops on the host, the threads they ran on;
      lost, primer_lost: kernel launches on the host (any kernel's) with no
          device event, outside and inside the primer;
      captured: launches with no device event inside a graph's capture
          (on the capturing thread): recorded into the graph, not run (a
          replay's kernels carry the correlation id of its one graph
          launch);
      lead_us: the most by which a device event starts before its CPU
          launch on the trace's clock (the profiler's offset between the
          card's clock and the host's; 0 where it maps none early)."""
    import re
    if not isinstance(trace, dict):
        with open(trace) as f:
            trace = json.load(f)
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    primers = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
               for e in events if e.get("cat") == "user_annotation"
               and e["name"] == "profiler primer"]
    captures = [(e.get("tid"), float(e["ts"]),
                 float(e["ts"]) + float(e.get("dur", 0.0)))
                for e in events if e.get("cat") == "user_annotation"
                and e["name"].startswith("graph capture ")]
    launched, primed = {}, set()
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") \
                and "correlation" in e.get("args", {}):
            corr = e["args"]["correlation"]
            launched[corr] = float(e["ts"])
            if any(lo <= float(e["ts"]) <= hi for lo, hi in primers):
                primed.add(corr)
    every = [e for e in events
             if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    recorded = {e.get("args", {}).get("correlation") for e in every}
    device = [e for e in every
              if e.get("args", {}).get("correlation") not in primed]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    out = {"kernels": dict.fromkeys(KERNEL_SYMBOLS, 0),
           "kernel_us": dict.fromkeys(KERNEL_SYMBOLS, 0.0),
           "orphans": dict.fromkeys(KERNEL_SYMBOLS, 0), "by_name": {},
           "device_events": len(device), "ranges": {},
           "host_ops": len(ops),
           "host_threads": len({e.get("tid") for e in ops}),
           "lost": 0, "primer_lost": 0, "captured": 0}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") \
                and "aunch" in e["name"] \
                and e.get("args", {}).get("correlation") not in recorded:
            if e["args"].get("correlation") in primed:
                out["primer_lost"] += 1
            elif any(tid == e.get("tid") and lo <= float(e["ts"]) <= hi
                     for tid, lo, hi in captures):
                out["captured"] += 1
            else:
                out["lost"] += 1
        elif e.get("cat") == "user_annotation":
            out["ranges"][e["name"]] = out["ranges"].get(e["name"], 0) + 1
    out["lead_us"] = max([0.0] + [
        launched[e["args"]["correlation"]] - float(e["ts"]) for e in every
        if e.get("args", {}).get("correlation") in launched])
    for e in device:
        row = out["by_name"].setdefault(e["name"], [0, 0.0])
        row[0] += 1
        row[1] += float(e.get("dur", 0.0))
        for sym in KERNEL_SYMBOLS:
            if e["cat"] == "kernel" and re.search(rf"(?:^|[\s:]){sym}\b",
                                                  e["name"]):
                out["kernels"][sym] += 1
                out["kernel_us"][sym] += float(e.get("dur", 0.0))
                if e.get("args", {}).get("correlation") not in launched:
                    out["orphans"][sym] += 1
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted((float(e["ts"]), float(e["ts"]) + float(
            e.get("dur", 0.0))) for e in device):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    out["busy_us"] = busy
    return out


def profile_window(fn, reps):
    """The port's profiler (`utils.profiling.profiler`: host, every thread,
    and the card) over `reps` calls of fn after one untimed call, ending in
    a synchronise: (trace_counts of its Chrome trace, host wall us)."""
    import torch
    from airmodes_torch.utils.profiling import profiler
    fn()
    torch.cuda.synchronize()
    with profiler() as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        return trace_counts(path), wall_us


def profile_step(fn, smi, reps=5, expect=()):
    """torch.profiler over `reps` device steps: the card's busy share of
    the window, device ops per step, and the ones that take the most
    device time; returns the device-side rows (us over the reps, count,
    name), from the trace with the session's primer left out. Each symbol
    of `expect` (KERNEL_SYMBOLS) must appear once per step, each with its
    CPU launch, or it raises."""
    counts, wall_us = profile_window(fn, reps)
    rows = [(us, n, name) for name, (n, us) in counts["by_name"].items()]
    print(f"profile: {counts['lost']} launches without a device event "
          f"(the primer's: {counts['primer_lost']}); the card's clock mapped "
          f"{counts['lead_us']:.1f} us early", flush=True)
    for sym in expect:
        print(f"profile: {sym} x{counts['kernels'][sym]} in the trace "
              f"({counts['orphans'][sym]} without their CPU launch) over "
              f"{reps} steps", flush=True)
        if counts["kernels"][sym] != reps or counts["orphans"][sym]:
            raise AssertionError(f"profile: {sym} not once per step with "
                                 f"its launch (fault C2)")
    if not rows:
        print("profile: the profiler saw no device time (not measured)",
              flush=True)
        return rows
    busy = sum(r[0] for r in rows)
    print(f"profile: {reps} device steps, wall {wall_us / reps:.1f} us per "
          f"step, device busy {busy / reps:.1f} us per step "
          f"({100 * busy / wall_us:.1f}% of the window; the union of the "
          f"device intervals {counts['busy_us'] / reps:.1f} us), "
          f"{counts['device_events'] / reps:.0f} device kernels and copies "
          f"per step [{smi}]", flush=True)
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"profile:   {dev_us / reps:9.1f} us/step  x{count // reps:<4d} "
              f"{key[:90]}", flush=True)
    return rows


def decoded_per_df(msgs, truth):
    """{df: (decoded, injected)}: a frame counts when its hex is emitted
    with status OK or corrected (DF11/17/18) or, for the DFs whose parity
    carries the address, with its address as the syndrome."""
    from airmodes_torch.testing import encoder
    seen = {}
    for m in msgs:
        f = m.split()
        seen.setdefault(f[1], set()).add((int(f[3]), int(f[2], 16)))
    out = {}
    for t in truth:
        ok = any(st in (0, 1, 2) or (st == 3 and syn ==
                                     encoder.frame_icao(t.frame, t.nbits))
                 for st, syn in seen.get(t.hex, ()))
        d, n = out.get(t.df, (0, 0))
        out[t.df] = (d + ok, n + 1)
    return dict(sorted(out.items()))


def first_batch(cfg, path):
    """The first BATCH blocks of a uc8 capture as the int8 runner frames
    them: (BATCH, P) planar int8 I and Q (numpy)."""
    import numpy as np
    from airmodes_torch.io.native_stream import _PlanarSource
    from airmodes_torch.kernels import preamble as K
    p = K.planar_length(cfg)
    src = _PlanarSource(cfg, p, path=path, fmt="uc8")
    xi = np.zeros((BATCH, p), np.int8)
    xq = np.zeros((BATCH, p), np.int8)
    try:
        for j in range(BATCH):
            if src.next_row(xi[j], xq[j]) is None:
                raise AssertionError("capture shorter than one batch")
    finally:
        src.close()
    return xi, xq


def phase_main(cfg, dev, tmp, smi):
    """The main path end to end; returns launch counts and rates."""
    import numpy as np
    import torch
    from airmodes_torch.dsp.host import BlockStats
    from airmodes_torch.io.native_stream import run_native_pipelined
    from airmodes_torch.kernels import preamble as K
    path = os.path.join(tmp, "main.uc8")
    truth = write_capture(cfg, path, N_MAIN_BLOCKS)

    # the first batch as the runner frames it, on the card and on the CPU
    xi, xq = first_batch(cfg, path)
    ti, tq = torch.from_numpy(xi).to(dev), torch.from_numpy(xq).to(dev)
    on_card = K.demod_batch_packed_planar(ti, tq, cfg, device=dev)
    on_card = on_card.cpu().numpy()
    on_cpu = K.demod_batch_packed_planar(xi, xq, cfg, device="cpu").numpy()
    cols = [0, 1, 2, 3, 5, 6, 7, 8]
    if not np.array_equal(on_card[..., cols], on_cpu[..., cols]):
        raise AssertionError("first batch: card table != CPU table")
    np.testing.assert_allclose(on_card[..., :-1, 4].view(np.float32),
                               on_cpu[..., :-1, 4].view(np.float32),
                               rtol=1e-5)
    print(f"main: first batch table on the card == CPU "
          f"({int((on_cpu[:, :-1, 0] >= 0).sum())} detections)", flush=True)
    # the compiled step on the host batch, as the runner calls it (this
    # captures the graph the runner replays)
    graphed = K.demod_batch_packed_planar_jit(xi, xq, cfg, device=dev)
    if not np.array_equal(graphed.cpu().numpy(), on_card):
        raise AssertionError("first batch: the graphed step != the eager "
                             "step on the card")
    print("main: first batch, the graphed step == the eager step on the "
          "card, bit for bit", flush=True)

    step_ms = time_ms(lambda: K.demod_batch_packed_planar(ti, tq, cfg,
                                                          device=dev),
                      device_only=False)
    profile_step(lambda: K.demod_batch_packed_planar(ti, tq, cfg,
                                                     device=dev), smi,
                 expect=B1_B2_SYMBOLS)

    stats = BlockStats()
    K.reset_launches()
    t0 = time.perf_counter()
    msgs = [m for b in run_native_pipelined(cfg, path=path, fmt="uc8",
                                            batch=BATCH, stats=stats,
                                            device=dev) for m in b]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    print(f"main: launches {launches}", flush=True)
    launches["B1"] = K.DETECT_CANDS_ROUTES["B1"]
    for k in ("B1", "slice_windows"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the int8 "
                                 f"path")

    # every batch, not only the first: the same runner on the CPU (the
    # kernels' plain versions) must emit the same messages, byte for byte
    t0 = time.perf_counter()
    on_cpu = [m for b in run_native_pipelined(cfg, path=path, fmt="uc8",
                                              batch=BATCH, device="cpu")
              for m in b]
    if msgs != on_cpu:
        diff = sorted(set(msgs) ^ set(on_cpu))[:5]
        raise AssertionError(f"main path on the card != on the CPU "
                             f"({len(msgs)} vs {len(on_cpu)} messages; "
                             f"e.g. {diff})")
    print(f"main: all {len(msgs)} messages of the {N_MAIN_BLOCKS} blocks on "
          f"the card == on the CPU ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    per_df = decoded_per_df(msgs, truth)
    print(f"main: {stats}", flush=True)
    for df, (d, n) in per_df.items():
        print(f"main: df{df} decoded {d}/{n}", flush=True)
    short = {df: dn for df, dn in per_df.items() if dn[0] < 0.99 * dn[1]}
    if short:
        raise AssertionError(f"decode below 99% for DFs {short}")
    samples = N_MAIN_BLOCKS * cfg.block_size
    print(f"main: demod step {step_ms:.4f} ms per batch of {BATCH} blocks "
          f"= {BATCH * cfg.block_size / step_ms / 1e3:.1f} Msps; end to end "
          f"{samples / wall / 1e6:.1f} Msps over {N_MAIN_BLOCKS} blocks "
          f"({wall:.3f} s) [{smi}]", flush=True)
    return launches, truth, msgs


def _stream_blocks(cfg, path, start=0, stop=None):
    """Framed f32 blocks of a complex64 capture from the native framer,
    blocks [start, stop)."""
    from airmodes_torch.native import IQStream
    st = IQStream(cfg)
    try:
        st.start_file(path, fmt="complex64")
        yield from itertools.islice(st.blocks(), start, stop)
    finally:
        st.close()


def _messages(steps):
    return [m for b in steps for m in b]


def phase_main_f32(cfg, dev, tmp, smi):
    """The f32 path end to end: IQStream.blocks() -> run_pipelined (batch 8,
    B4) over 32 blocks; run_pipelined at batch 1 (B3) and run_channels over
    two channels, 4 blocks each. Returns the launch counts per route."""
    import numpy as np
    import torch
    from airmodes_torch.dsp.host import BlockStats
    from airmodes_torch.io.stream import (_batch_step, _default_step,
                                          _stack_host, run_channels,
                                          run_pipelined)
    from airmodes_torch.kernels import preamble as K
    path = os.path.join(tmp, "main.c64")
    truth = write_capture(cfg, path, N_MAIN_BLOCKS, fmt="complex64")
    tile = K.supported_2d_tile(cfg)

    # the first batch as the runner frames it, on the card and on the CPU
    xb = np.stack([b for b, _ in _stream_blocks(cfg, path, 0, BATCH)])
    xt = torch.from_numpy(xb).to(dev)
    on_card = K.demod_batch_packed_fast(xt, cfg, tile=tile, device=dev)
    on_card = on_card.cpu().numpy()
    on_cpu = K.demod_batch_packed_fast(xb, cfg, tile=tile,
                                       device="cpu").numpy()
    cols = [0, 1, 2, 3, 5, 6, 7, 8]
    if not np.array_equal(on_card[..., cols], on_cpu[..., cols]):
        raise AssertionError("f32 first batch: card table != CPU table")
    np.testing.assert_allclose(on_card[..., :-1, 4].view(np.float32),
                               on_cpu[..., :-1, 4].view(np.float32),
                               rtol=1e-5)
    print(f"f32: first batch table on the card == CPU "
          f"({int((on_cpu[:, :-1, 0] >= 0).sum())} detections)", flush=True)
    graphed = K.demod_batch_packed_fast_jit(xb, cfg, tile=tile, device=dev)
    if not np.array_equal(graphed.cpu().numpy(), on_card):
        raise AssertionError("f32 first batch: the graphed step != the "
                             "eager step on the card")
    print("f32: first batch, the graphed step == the eager step on the "
          "card, bit for bit", flush=True)
    # the steps the runner dispatches must not wait on the card: any
    # synchronising call inside them raises in this mode
    step_b = _batch_step(cfg, dev)
    step_1 = _default_step(cfg, dev)
    # the runner stacks a batch straight into page-locked memory, which
    # the step then copies over with no staging copy
    hb, owner = _stack_host(list(xb), pinned=True)
    if not torch.from_numpy(hb).is_pinned():
        raise AssertionError("the runner's host batch is not page-locked")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step_b(hb, cfg)
        step_b(xb, cfg)
        step_b(wire(xb, np.int8), cfg)
        step_1(xb[0], cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print("f32: the runner's batch steps (B4; int8: B1, B2) and one-block "
          "step (B3), captured graphs, ran with no host synchronisation",
          flush=True)
    step_ms = time_ms(lambda: K.demod_batch_packed_fast(xt, cfg, tile=tile,
                                                        device=dev),
                      device_only=False)
    profile_step(lambda: K.demod_batch_packed_fast(xt, cfg, tile=tile,
                                                   device=dev), smi,
                 expect=("detect_mask_kernel",))
    del xt

    stats = BlockStats()
    K.reset_launches()
    t0 = time.perf_counter()
    msgs = _messages(run_pipelined(_stream_blocks(cfg, path), cfg,
                                   batch=BATCH, stats=stats, device=dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"B4": K.DETECT_MASK_ROUTES["B4"]}
    print(f"f32: launches {dict(K.LAUNCHES)}, routes "
          f"{dict(K.DETECT_MASK_ROUTES)}", flush=True)
    if K.LAUNCHES["detect_mask"] <= 0 or launches["B4"] <= 0:
        raise AssertionError("B4 never launched on the f32 path")

    t0 = time.perf_counter()
    on_cpu = _messages(run_pipelined(_stream_blocks(cfg, path), cfg,
                                     batch=BATCH, device="cpu"))
    if msgs != on_cpu:
        diff = sorted(set(msgs) ^ set(on_cpu))[:5]
        raise AssertionError(f"f32 path on the card != on the CPU "
                             f"({len(msgs)} vs {len(on_cpu)} messages; "
                             f"e.g. {diff})")
    print(f"f32: all {len(msgs)} messages of the {N_MAIN_BLOCKS} blocks on "
          f"the card == on the CPU ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    per_df = decoded_per_df(msgs, truth)
    print(f"f32: {stats}", flush=True)
    for df, (d, n) in per_df.items():
        print(f"f32: df{df} decoded {d}/{n}", flush=True)
    short = {df: dn for df, dn in per_df.items() if dn[0] < 0.99 * dn[1]}
    if short:
        raise AssertionError(f"f32: decode below 99% for DFs {short}")
    samples = N_MAIN_BLOCKS * cfg.block_size
    print(f"f32: demod step {step_ms:.4f} ms per batch of {BATCH} blocks "
          f"= {BATCH * cfg.block_size / step_ms / 1e3:.1f} Msps; end to end "
          f"{samples / wall / 1e6:.1f} Msps over {N_MAIN_BLOCKS} blocks "
          f"({wall:.3f} s) [{smi}]", flush=True)

    # batch 1: kernel B3, one block per step
    K.reset_launches()
    one = list(run_pipelined(_stream_blocks(cfg, path, 0, 4), cfg, batch=1,
                             device=dev))
    launches["B3"] = K.DETECT_MASK_ROUTES["B3"]
    if launches["B3"] <= 0:
        raise AssertionError("B3 never launched at batch 1")
    if one != list(run_pipelined(_stream_blocks(cfg, path, 0, 4), cfg,
                                 batch=1, device="cpu")):
        raise AssertionError("batch-1 run on the card != on the CPU")
    print(f"f32: batch 1 over 4 blocks: {len(_messages(one))} messages == "
          f"CPU, B3 launches {launches['B3']}", flush=True)

    # two channels of 4 blocks each, one B4 call of C = 2 per step
    K.reset_launches()

    def chans():
        return [_stream_blocks(cfg, path, 0, 4),
                _stream_blocks(cfg, path, 4, 8)]
    steps = list(run_channels(chans(), cfg, device=dev))
    if K.DETECT_MASK_ROUTES["B4"] <= 0 or len(steps) != 4:
        raise AssertionError("run_channels did not run B4 over 4 steps")
    if steps != list(run_channels(chans(), cfg, device="cpu")):
        raise AssertionError("run_channels on the card != on the CPU")
    print(f"f32: run_channels, 2 channels x 4 blocks: "
          f"{[len(c) for st in steps for c in st]} messages == CPU, B4 "
          f"launches {K.DETECT_MASK_ROUTES['B4']}", flush=True)
    return launches, truth


def _check_batch(on_card, on_cpu, what, rtol):
    """A batch's packed tables on the card == on the CPU: every int32
    column exactly, noise within rtol."""
    import numpy as np
    cols = [0, 1, 2, 3, 5, 6, 7, 8]
    if not np.array_equal(on_card[..., cols], on_cpu[..., cols]):
        raise AssertionError(f"{what}: card table != CPU table")
    np.testing.assert_allclose(on_card[..., :-1, 4].view(np.float32),
                               on_cpu[..., :-1, 4].view(np.float32),
                               rtol=rtol, err_msg=what)


def _decode_check(msgs, truth, what):
    """Print the decode per DF and fail below 99% of any DF's frames."""
    per_df = decoded_per_df(msgs, truth)
    for df, (d, n) in per_df.items():
        print(f"{what}: df{df} decoded {d}/{n}", flush=True)
    short = {df: dn for df, dn in per_df.items() if dn[0] < 0.99 * dn[1]}
    if short:
        raise AssertionError(f"{what}: decode below 99% for DFs {short}")


def _run_batches(batches, step, cfg, what, rtol):
    """Each (host batch, starts, full scales) through step(x, device) on
    the card and on the CPU: the tables must agree (_check_batch); returns
    the card's messages, in stream order."""
    import torch
    from airmodes_torch.dsp.host import table_to_messages
    from airmodes_torch.dsp.pipeline import unpack_table
    msgs = []
    for k, (xb, starts, scales) in enumerate(batches):
        on_card = step(xb, "cuda").cpu().numpy()
        on_cpu = step(xb, "cpu").numpy()
        _check_batch(on_card, on_cpu, f"{what}, batch {k}", rtol)
        for j, (st, fs) in enumerate(zip(starts, scales)):
            msgs += table_to_messages(unpack_table(on_card[j]), st,
                                      cfg.channel_rate, full_scale=fs)
    torch.cuda.synchronize()
    return msgs


def planar_batches(cfg, path, p=None):
    """A uc8 capture framed by the int8 runner's AGC framer into batches of
    BATCH rows of p samples (the planar layout's length by default):
    [((planar I, Q) numpy, starts, full scales)]."""
    import numpy as np
    from airmodes_torch.io.native_stream import _PlanarSource
    from airmodes_torch.kernels import preamble as K
    p = p or K.planar_length(cfg)
    src = _PlanarSource(cfg, p, path=path, fmt="uc8")
    batches = []
    try:
        while True:
            xi = np.zeros((BATCH, p), np.int8)
            xq = np.zeros((BATCH, p), np.int8)
            starts, scales = [], []
            for j in range(BATCH):
                got = src.next_row(xi[j], xq[j])
                if got is None:
                    break
                starts.append(got[0])
                scales.append(got[1])
            if not starts:
                break
            batches.append(((xi, xq), starts, scales))
    finally:
        src.close()
    return batches


def phase_planar_options(cfg, dev, path, truth, smi):
    """The planar path's reference options over the uc8 capture of phase
    6, framed by the runner's AGC framer into batches of 8: ordered=True
    (B5o, compact_candidates), prescreen=True (B5p, stage B) and
    xla_gather=True (B1, a torch gather in place of B2). Returns the
    launch counts of B5o and B5p."""
    import torch
    from airmodes_torch.kernels import preamble as K
    batches = planar_batches(cfg, path)
    if sum(len(b[1]) for b in batches) != N_MAIN_BLOCKS:
        raise AssertionError("the uc8 capture did not frame into "
                             f"{N_MAIN_BLOCKS} blocks")
    launches = {}
    for opt, kid, want in (("ordered", "B5o", ("B5o", "slice_windows")),
                           ("prescreen", "B5p", ("B5p", "slice_windows")),
                           ("xla_gather", None, ("B1",))):
        kw = {opt: True}

        def step(xb, device, kw=kw):
            return K.demod_batch_packed_planar(xb[0], xb[1], cfg,
                                               device=device, **kw)
        K.reset_launches()
        t0 = time.perf_counter()
        msgs = _run_batches(batches, step, cfg, f"planar {opt}", 1e-5)
        counts = {**K.LAUNCHES, **K.DETECT_CANDS_ROUTES}
        print(f"planar {opt}=True: {len(msgs)} messages of "
              f"{N_MAIN_BLOCKS} blocks, every batch == CPU, launches "
              f"{counts} ({time.perf_counter() - t0:.1f} s)", flush=True)
        for k in want:
            if counts[k] <= 0:
                raise AssertionError(f"{k} never launched with {opt}=True")
        if opt == "xla_gather" and counts["slice_windows"]:
            raise AssertionError("xla_gather=True launched B2")
        if kid:
            launches[kid] = counts[kid]
        _decode_check(msgs, truth, f"planar {opt}")
        ti = torch.from_numpy(batches[0][0][0]).to(dev)
        tq = torch.from_numpy(batches[0][0][1]).to(dev)
        ms = time_ms(lambda: step((ti, tq), dev), device_only=False)
        print(f"planar {opt}=True: demod step {ms:.4f} ms per batch of "
              f"{BATCH} blocks = {BATCH * cfg.block_size / ms / 1e3:.1f} "
              f"Msps [{smi}]", flush=True)
    return launches


def phase_1d(cfg, dev, path, truth, tmp, smi):
    """The 1-D path: the 32-block complex64 capture of phase 7 (`path`,
    `truth`) through demod_batch_packed_1d (B6, C = 8), 4 of its blocks
    through demod_block_packed_1d (B6, C = 1), and an 8-block 20 Msps
    capture through demod_batch_packed_1d. Returns B6's launch counts per
    C."""
    import numpy as np
    import torch
    from airmodes_torch.config import DspConfig
    from airmodes_torch.kernels import preamble as K

    def batches(c, pth, start=0, stop=None, size=BATCH):
        blocks = list(_stream_blocks(c, pth, start, stop))
        return [(np.stack([b for b, _ in blocks[i: i + size]]),
                 [st for _, st in blocks[i: i + size]],
                 [1.0] * len(blocks[i: i + size]))
                for i in range(0, len(blocks), size)]

    def batch_step(c):
        return lambda xb, device: K.demod_batch_packed_1d(xb, c,
                                                          device=device)

    launches = {}
    K.reset_launches()
    t0 = time.perf_counter()
    msgs = _run_batches(batches(cfg, path), batch_step(cfg), cfg, "1-D",
                        1e-4)
    launches[BATCH] = K.DETECT_MASK_ROUTES["B6 batch"]
    print(f"1-D: {len(msgs)} messages of {N_MAIN_BLOCKS} blocks, every "
          f"batch == CPU, routes {dict(K.DETECT_MASK_ROUTES)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if launches[BATCH] <= 0:
        raise AssertionError("B6 never launched on the 1-D batch path")
    _decode_check(msgs, truth, "1-D")
    xt = torch.from_numpy(batches(cfg, path, 0, BATCH)[0][0]).to(dev)
    ms = time_ms(lambda: K.demod_batch_packed_1d(xt, cfg, device=dev),
                 device_only=False)
    print(f"1-D: demod step {ms:.4f} ms per batch of {BATCH} blocks = "
          f"{BATCH * cfg.block_size / ms / 1e3:.1f} Msps [{smi}]",
          flush=True)
    del xt

    # one block per call: B6 at C = 1
    K.reset_launches()
    one = _run_batches(batches(cfg, path, 0, 4, size=1),
                       lambda xb, device: K.demod_block_packed_1d(
                           xb[0], cfg, device=device)[None],
                       cfg, "1-D one block", 1e-4)
    launches[1] = K.DETECT_MASK_ROUTES["B6"]
    if launches[1] <= 0:
        raise AssertionError("B6 never launched on one block")
    print(f"1-D one block, 4 blocks: {len(one)} messages, each table == "
          f"CPU, B6 launches {launches[1]}", flush=True)

    # 20 Msps (sps 10), where the 2-D kernels refuse the config
    cfg20 = DspConfig(channel_rate=20e6)
    path20 = os.path.join(tmp, "fast.c64")
    truth20 = write_capture(cfg20, path20, BATCH, seed=3, fmt="complex64")
    K.reset_launches()
    msgs = _run_batches(batches(cfg20, path20), batch_step(cfg20), cfg20,
                        "1-D 20 Msps", 1e-4)
    if K.DETECT_MASK_ROUTES["B6 batch"] <= 0:
        raise AssertionError("B6 never launched at 20 Msps")
    print(f"1-D 20 Msps: {len(msgs)} messages of {BATCH} blocks, every "
          f"batch == CPU, B6 launches {K.DETECT_MASK_ROUTES['B6 batch']}",
          flush=True)
    _decode_check(msgs, truth20, "1-D 20 Msps")
    return launches


def phase_reports(msgs, truth, tmp):
    """Phase 6's messages through the decode and output layers: `parse`,
    `output_print` into a list and `output_sql` into a SQLite file. Every
    injected address must appear in the reports, and every DF17
    identification's callsign must re-encode to the injected ME field."""
    import sqlite3
    from airmodes_torch.decode.parse import parse
    from airmodes_torch.exceptions import ADSBError
    from airmodes_torch.outputs import output_print, output_sql
    from airmodes_torch.testing import encoder
    t0 = time.perf_counter()
    p = parse()
    reports, bad = [], 0
    for m in msgs:
        try:
            reports.append(p.parse(m))
        except ADSBError:
            bad += 1
    lines = []
    console = output_print(callback=lines.append)
    db = os.path.join(tmp, "reports.db")
    sql = output_sql(db)
    for m in msgs:
        console.output(m)
        sql.output(m)
    sql.close()
    con = sqlite3.connect(db)
    try:
        rows = {t: con.execute(f"SELECT COUNT(*) FROM {t}").fetchone()[0]
                for t in ("aircraft", "positions", "vectors", "squawks",
                          "track")}
    finally:
        con.close()
    wall = time.perf_counter() - t0

    injected = {encoder.frame_icao(t.frame, t.nbits) for t in truth}
    missing = injected - {r.icao for r in reports}
    if missing:
        raise AssertionError(f"reports: {len(missing)} injected addresses "
                             f"missing, e.g. {sorted(missing)[:5]}")
    by_frame = {r.raw_hex: r for r in reports}
    n_ident = 0
    for t in truth:
        me = (t.frame >> 24) & ((1 << 56) - 1)
        if t.df != 17 or not 1 <= me >> 51 <= 4:
            continue
        rep = by_frame.get(t.hex)
        if rep is None or rep.callsign is None or encoder.me_identification(
                rep.callsign, tc=me >> 51, cat=(me >> 48) & 7) != me:
            raise AssertionError(f"reports: identification {t.hex} decoded "
                                 f"as {rep and rep.callsign!r}")
        n_ident += 1
    # output_print writes a line per report and one per ELM that the
    # parser completed at idle
    n_flushed = sum(len(r.elm_flushed or ()) for r in reports)
    want_lines = sum(bool(output_print.format_report(r))
                     for r in reports) + n_flushed
    if not n_ident or len(lines) != want_lines or not rows["aircraft"]:
        raise AssertionError(f"reports: {n_ident} identifications, "
                             f"{len(lines)} console lines (want "
                             f"{want_lines}), {rows}")
    print(f"reports: {len(msgs)} messages -> {len(reports)} reports "
          f"({bad} undecodable), all {len(injected)} injected addresses "
          f"present, {n_ident} callsigns == the "
          f"encoder's; output_print {len(lines)} lines ({n_flushed} idle "
          f"ELMs); output_sql rows {rows} ({wall:.2f} s on the host)",
          flush=True)


def phase_c1(dev, tmp, smi):
    """A config outside the planar gate through the int8 runner: at 20 Msps
    (sps 10) `run_native_pipelined` takes the full-block path on the
    stacked int8 rows, on the card, with no hand kernel, one replay of
    `_full_block_rows`'s graph a step. Then one batch through the step
    graphed and eagerly (bit for bit), and a short profile of the step:
    the replay's range inside the span `airmodes.full_block`."""
    import torch
    from airmodes_torch.config import DspConfig
    from airmodes_torch.io.native_stream import (_full_block_rows,
                                                 _planar_step,
                                                 run_native_pipelined)
    from airmodes_torch.kernels import preamble as K
    from airmodes_torch.utils import graphs
    cfg20 = DspConfig(channel_rate=20e6)
    if K.supported_planar_tile(cfg20) is not None:
        raise AssertionError("C1: 20 Msps is inside the planar gate")
    path = os.path.join(tmp, "c1.uc8")
    truth = write_capture(cfg20, path, BATCH, seed=5)
    K.reset_launches()
    replays = _full_block_rows.replays
    t0 = time.perf_counter()
    blocks = list(run_native_pipelined(cfg20, path=path, fmt="uc8",
                                       batch=BATCH, device=dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    msgs = _messages(blocks)
    hand = {**K.LAUNCHES, **K.DETECT_CANDS_ROUTES, **K.DETECT_MASK_ROUTES}
    if any(hand.values()):
        raise AssertionError(f"C1: the full-block route launched {hand}")
    steps = -(-len(blocks) // BATCH)
    replayed = _full_block_rows.replays - replays
    if replayed != steps:
        raise AssertionError(f"C1: {len(blocks)} blocks in {steps} steps "
                             f"of {BATCH} rows, but {replayed} graph "
                             f"replays")
    t1 = time.perf_counter()
    on_cpu = _messages(run_native_pipelined(cfg20, path=path, fmt="uc8",
                                            batch=BATCH, device="cpu"))
    if msgs != on_cpu:
        diff = sorted(set(msgs) ^ set(on_cpu))[:5]
        raise AssertionError(f"C1: card != CPU ({len(msgs)} vs "
                             f"{len(on_cpu)} messages; e.g. {diff})")
    print(f"C1: run_native_pipelined at 20 Msps, {BATCH} blocks: "
          f"{len(msgs)} messages == CPU ({time.perf_counter() - t1:.1f} s "
          f"on the CPU), no hand kernel launched; {replayed} replays of "
          f"the graph; end to end "
          f"{BATCH * cfg20.block_size / wall / 1e6:.1f} Msps ({wall:.3f} s) "
          f"[{smi}]", flush=True)
    _decode_check(msgs, truth, "C1")

    step, width = _planar_step(cfg20, dev)
    (xi, xq), _, _ = planar_batches(cfg20, path, width)[0]
    xi = torch.from_numpy(xi).pin_memory()
    xq = torch.from_numpy(xq).pin_memory()
    graphed = step(xi, xq).cpu()
    with graphs.disable():
        eager = step(xi, xq).cpu()
    if not torch.equal(graphed, eager):
        bad = int((graphed != eager).sum())
        raise AssertionError(f"C1: the graph's tables != the eager step's "
                             f"({bad} words differ)")
    counts, wall_us = profile_window(lambda: step(xi, xq), 3)
    ranges = counts["ranges"]
    if ranges.get("airmodes.full_block") != 3 or \
            ranges.get("graph _full_block_rows") != 3:
        raise AssertionError(f"C1: profile of 3 steps: ranges {ranges}")
    print(f"C1: the graph's tables == the eager step's, bit for bit; a "
          f"profile of 3 steps: 3 spans airmodes.full_block, each around "
          f"its replay (graph _full_block_rows), "
          f"{counts['device_events']} device events, card busy "
          f"{counts['busy_us'] / 3:.1f} us, host wall {wall_us / 3:.1f} us "
          f"a step [{smi}]", flush=True)


CHANNEL_BLOCKS = (8, 8, 6, 3)


def phase_channels(cfg, dev, tmp, smi):
    """run_native_channels at C = 4 over uc8 captures of unequal length;
    returns the launch counts of that run."""
    import numpy as np
    import torch
    from airmodes_torch.dsp.host import BlockStats
    from airmodes_torch.io.native_stream import run_native_channels
    from airmodes_torch.kernels import preamble as K
    paths, truths = [], []
    for c, n in enumerate(CHANNEL_BLOCKS):
        paths.append(os.path.join(tmp, f"ch{c}.uc8"))
        truths.append(write_capture(cfg, paths[-1], n, seed=11 + c))
    # the runner's compiled step captured first, as phase 6's is: the
    # timed run replays it
    p = K.planar_length(cfg)
    zi = np.zeros((len(paths), p), np.int8)
    K.demod_batch_packed_planar_jit(zi, zi, cfg, device=dev)
    stats = BlockStats()
    K.reset_launches()
    t0 = time.perf_counter()
    steps = list(run_native_channels(paths, cfg, fmt="uc8", stats=stats,
                                     device=dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    launches["B1"] = K.DETECT_CANDS_ROUTES["B1"]
    for k in ("B1", "slice_windows"):
        if launches[k] <= 0:
            raise AssertionError(f"channels: kernel {k} never launched")
    if len(steps) != max(CHANNEL_BLOCKS):
        raise AssertionError(f"channels: {len(steps)} steps")
    for k, step in enumerate(steps):
        ended = [m is None for m in step]
        if ended != [k >= n for n in CHANNEL_BLOCKS]:
            raise AssertionError(f"channels: step {k} ended {ended}")
    t1 = time.perf_counter()
    on_cpu = list(run_native_channels(paths, cfg, fmt="uc8", device="cpu"))
    if steps != on_cpu:
        bad = [k for k, (a, b) in enumerate(zip(steps, on_cpu)) if a != b]
        raise AssertionError(f"channels: card != CPU at steps {bad} "
                             f"({len(steps)} vs {len(on_cpu)} steps)")
    n_msgs = [sum(len(st[c] or []) for st in steps)
              for c in range(len(paths))]
    print(f"channels: run_native_channels, C = {len(paths)}, blocks "
          f"{CHANNEL_BLOCKS}: {n_msgs} messages, every step == CPU "
          f"({time.perf_counter() - t1:.1f} s on the CPU), ended channels "
          f"None; launches {launches}; {stats}", flush=True)
    for c, truth in enumerate(truths):
        _decode_check([m for st in steps for m in (st[c] or [])], truth,
                      f"channels ch{c}")
    samples = sum(CHANNEL_BLOCKS) * cfg.block_size
    print(f"channels: end to end {samples / wall / 1e6:.1f} Msps "
          f"({sum(CHANNEL_BLOCKS)} blocks of {cfg.block_size} samples in "
          f"{len(steps)} steps, {wall:.3f} s) [{smi}]", flush=True)
    return launches


RESAMPLED_RATE = 10e6        # BASELINE config 3: a 10 Msps front end
RS_CHANNEL_BLOCKS = (4, 4, 3, 2)


def write_raw_capture(cfg, path, n_blocks, rate_in, seed):
    """complex64 capture at rate_in (an SDR rate the fused path resamples
    to cfg.channel_rate) of n_blocks channel-rate blocks: mixed traffic,
    13 frames per block at 15 dB. Frames start at raw sample 1003 + k *
    spacing, spacing a multiple of the decimation q: at one sample per
    chip after the resample, the sub-chip phase decides whether a frame
    can decode, and 3 of 5 raw samples at 10 Msps is a decodable one (0
    and 1 are not; 2, 3 and 4 decode every frame at 15 dB). Returns the
    ground truth with raw sample indices."""
    import numpy as np
    from airmodes_torch.resample.polyphase import rational_rate
    from airmodes_torch.testing import encoder
    p, q = rational_rate(rate_in, cfg.channel_rate)
    raw_block = cfg.block_size * q // p
    spacing = raw_block // 14 // q * q
    truth = []
    every = encoder.random_mixed_frames(13 * n_blocks, seed=seed)
    with open(path, "wb") as f:
        for b in range(n_blocks):
            iq, tr = encoder.make_capture(
                every[13 * b: 13 * b + 13], rate=rate_in, snr_db=15.0,
                spacing=spacing, start=1003, seed=seed * 1000 + b,
                total_samples=raw_block)
            for t in tr:
                t.sample_index += b * raw_block
            truth += tr
            (iq / (float(np.max(np.abs(iq))) or 1.0) * 0.9).astype(
                np.complex64).tofile(f)
    return truth


def _same_messages(card, cpu, what):
    """The parity contract of the resampled path: the same messages in the
    same order, field by field (df, hex, syndrome, status, timestamp, ns),
    ref_dbfs within 0.1 dB. The resampler's f32 matmuls sum in another
    order on the card than on the CPU, so an int8 sample inside a pulse
    may differ by 1, which moves the reference level a little."""
    if len(card) != len(cpu):
        raise AssertionError(f"{what}: {len(card)} messages on the card, "
                             f"{len(cpu)} on the CPU")
    worst = 0.0
    for a, b in zip(card, cpu):
        fa, fb = a.split(), b.split()
        worst = max(worst, abs(float(fa[4]) - float(fb[4])))
        if fa[:4] + fa[5:] != fb[:4] + fb[5:] or worst > 0.1:
            raise AssertionError(f"{what}: card {a!r} != CPU {b!r}")
    return worst


def _same_front(x, cfg, p, q, dev, what):
    """The fused front half (resample, device AGC, int8 quantize) of one
    batch on the card and on the CPU: gains within rtol 1e-6, int8 equal
    in >= 99.99% of samples and never more than 1 apart. Returns the
    count of differing samples and the total."""
    import numpy as np
    import torch
    from airmodes_torch.resample.fused import resample_quantize_planar
    y_card, g_card = resample_quantize_planar(x.to(dev), None, cfg, p, q)
    y_cpu, g_cpu = resample_quantize_planar(x, None, cfg, p, q)
    np.testing.assert_allclose(g_card.cpu().numpy(), g_cpu.numpy(),
                               rtol=1e-6, err_msg=f"{what}: AGC gains")
    d = (y_card.cpu().to(torch.int16) - y_cpu.to(torch.int16)).abs()
    n_diff, n = int((d > 0).sum()), d.numel()
    if int(d.max()) > 1 or n_diff > 1e-4 * n:
        raise AssertionError(f"{what}: int8 card vs CPU: {n_diff} of {n} "
                             f"differ, by up to {int(d.max())}")
    return n_diff, n


def _raw_batches(path, geometry, batch, max_blocks=None, pinned=False):
    """A complex64 capture as the fused runner reads it, per batch: (raw
    words, valid ranges, planar f32 windows from R1's plain version),
    rows past the last window zeros; pinned when asked."""
    import torch
    from airmodes_torch.io import stream as S
    from airmodes_torch.resample import fused as RF
    width, block = sum(geometry), geometry[1]

    def one(acc):
        valid = torch.zeros((batch, 2), dtype=torch.int32)
        valid[:len(acc)] = torch.tensor([r for _, _, r in acc])
        raw = acc[0][0]
        x = RF.raw_planar_plain(raw, valid, width, block)
        if pinned:
            raw, valid, x = raw.pin_memory(), valid.pin_memory(), \
                x.pin_memory()
        return raw, valid, x

    acc = []
    for item in S._raw_windows(S._RawReader(path, "complex64", 0, geometry),
                                batch, max_blocks, False):
        acc.append(item)
        if len(acc) == batch:
            yield one(acc)
            acc = []
    if acc:
        yield one(acc)


def phase_resampled(cfg, dev, tmp, smi):
    """The resampled front end on the card, at DspConfig() from a 10 Msps
    capture of 32 blocks (p/q = 1/5), then at C = 4 from 6 Msps captures
    to 4 Msps (p/q = 2/3); then the host path (streaming resampler ->
    run_pipelined) over 8 blocks. Returns the fused runs' launch counts,
    R1's (ms, plain ms, bound ms, bound by) per wire format and the 10
    Msps capture's path."""
    import numpy as np
    import torch
    from airmodes_torch.config import DspConfig
    from airmodes_torch.dsp.host import BlockStats
    from airmodes_torch.io import sources, stream as S
    from airmodes_torch.kernels import preamble as K
    from airmodes_torch.kernels.opcount import bound
    from airmodes_torch.resample import fused as RF
    from airmodes_torch.resample import polyphase as PP
    from airmodes_torch.resample.polyphase import (rational_rate,
                                                   streaming_resampler)
    from airmodes_torch.utils import graphs
    print(f"resampled: TF32 {torch.backends.cuda.matmul.allow_tf32} "
          f"(matmul), {torch.backends.cudnn.allow_tf32} (cuDNN); f32 "
          f"matmul precision {torch.get_float32_matmul_precision()!r}",
          flush=True)
    path = os.path.join(tmp, "resampled.c64")
    t0 = time.perf_counter()
    truth = write_raw_capture(cfg, path, N_MAIN_BLOCKS, RESAMPLED_RATE, 21)
    p, q = rational_rate(RESAMPLED_RATE, cfg.channel_rate)
    geometry = RF.raw_geometry(cfg, p, q)[:3]
    print(f"resampled: {N_MAIN_BLOCKS} blocks of {cfg.block_size * q // p} "
          f"raw samples at {RESAMPLED_RATE / 1e6:g} Msps written in "
          f"{time.perf_counter() - t0:.1f} s; p/q = {p}/{q}, raw window "
          f"{geometry}", flush=True)

    # every batch's front half on the card against the CPU
    n_diff = n_all = 0
    first = None
    pinned = torch.device(dev).type == "cuda"
    for k, (raw, valid, x) in enumerate(_raw_batches(path, geometry, BATCH,
                                                     pinned=pinned)):
        first = (raw, valid, x) if first is None else first
        d, n = _same_front(x, cfg, p, q, dev, f"resampled batch {k}")
        n_diff, n_all = n_diff + d, n_all + n
    print(f"resampled: front half, every batch: AGC gains card == CPU "
          f"(rtol 1e-6); int8 {n_diff} of {n_all} samples differ by 1 "
          f"({n_diff / n_all:.2e}), none by more", flush=True)

    # R1 alone at the fused cell's shapes: the first batch's words in each
    # wire format (complex64 as read; sc16 and uc8 written from them) on
    # the card against the plain version bit for bit; its time, the plain
    # version's on the card and its bytes bound
    raw0, valid0, first = first
    width, stride = sum(geometry), geometry[1]
    r1 = {}
    for fmt, words in (("sc16", torch.clamp(torch.round(raw0 * 32768.0),
                                            -32768, 32767).to(torch.int16)),
                       ("uc8", torch.clamp(torch.round(raw0 * 127.5 + 127.5),
                                           0, 255).to(torch.uint8)),
                       ("complex64", raw0)):
        rawd, validd = words.to(dev), valid0.to(dev)
        want = RF.raw_planar_plain(words, valid0, width, stride)
        K.reset_launches()
        got = RF.raw_to_planar(rawd, validd, width, stride)
        if K.LAUNCHES["raw_planar"] != 1 or not torch.equal(
                got.cpu().view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"resampled: R1 on {fmt} words on the "
                                 f"card != its plain version, or not one "
                                 f"launch")
        ms = time_ms(lambda: RF.raw_to_planar(rawd, validd, width, stride))
        plain_ms = time_ms(lambda: RF.raw_planar_plain(rawd, validd, width,
                                                       stride))
        n_bytes = want.shape[0] * width * (words.element_size() * 2 + 8)
        bms, by = bound(n_bytes, 0)
        r1[fmt] = (ms, plain_ms, bms, by)
        print(f"resampled: R1 raw_planar ({fmt} words, {want.shape[0]} "
              f"windows of {width}) == plain bit for bit; {ms:.5f} ms on "
              f"the card, plain version {plain_ms:.5f} ms on the card, "
              f"{n_bytes / 1e6:.1f} MB, bound {bms:.5f} ms ({by}), share "
              f"{bms / ms:.3f} [{smi}]", flush=True)
        del rawd, validd, got, want

    xd = torch.empty(first.shape, dtype=torch.float32, device=dev)
    copy_ms = time_ms(lambda: xd.copy_(first, non_blocking=True),
                      device_only=False)
    n_bytes = first.numel() * 4
    step_ms = time_ms(lambda: RF.resample_demod_packed_planar(
        xd, None, cfg, p, q, device=dev), device_only=False)
    rows = profile_step(lambda: RF.resample_demod_packed_planar(
        xd, None, cfg, p, q, device=dev), smi, expect=B1_B2_SYMBOLS)
    busy = sum(r[0] for r in rows)
    gemm = sum(r[0] for r in rows if "gemm" in r[2].lower())
    share = f"{100 * gemm / busy:.1f}%" if busy else "not measured"
    out_samples = BATCH * cfg.block_size
    print(f"resampled: device step {step_ms:.4f} ms per batch of {BATCH} "
          f"= {out_samples / step_ms / 1e3:.1f} Msps at 2 Msps out, "
          f"{out_samples * q / p / step_ms / 1e3:.1f} Msps raw; the group "
          f"matmuls take {share} of its device time; host to card "
          f"{n_bytes / 1e6:.1f} MB per batch in {copy_ms:.4f} ms "
          f"({n_bytes / copy_ms / 1e6:.1f} GB/s) [{smi}]", flush=True)

    # the runner's compiled step captured first: the timed run replays it
    RF.resample_demod_packed_planar_jit(first, None, cfg, p, q, device=dev)
    stats = BlockStats()
    K.reset_launches()
    t0 = time.perf_counter()
    blocks = list(S.run_resampled_fused(
        path, cfg, dtype="complex64", rate_in=RESAMPLED_RATE, batch=BATCH,
        stats=stats, device=dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    launches["B1"] = K.DETECT_CANDS_ROUTES["B1"]
    print(f"resampled: run_resampled_fused launches {launches}; {stats}",
          flush=True)
    for kname in ("B1", "slice_windows"):
        if launches[kname] <= 0:
            raise AssertionError(f"resampled: kernel {kname} never "
                                 f"launched")
    if launches["raw_planar"] != -(-len(blocks) // BATCH):
        raise AssertionError(f"resampled: R1 launched "
                             f"{launches['raw_planar']} times over "
                             f"{len(blocks)} blocks")
    t1 = time.perf_counter()
    on_cpu = list(S.run_resampled_fused(
        path, cfg, dtype="complex64", rate_in=RESAMPLED_RATE, batch=BATCH,
        device="cpu"))
    if len(blocks) != len(on_cpu):
        raise AssertionError(f"resampled: {len(blocks)} blocks on the "
                             f"card, {len(on_cpu)} on the CPU")
    worst = max([_same_messages(a, b, f"resampled block {k}")
                 for k, (a, b) in enumerate(zip(blocks, on_cpu))] + [0.0])
    msgs = _messages(blocks)
    print(f"resampled: all {len(msgs)} messages of the {len(blocks)} blocks "
          f"on the card == on the CPU field by field, ref_dbfs within "
          f"{worst:.2f} dB ({time.perf_counter() - t1:.1f} s on the CPU)",
          flush=True)
    _decode_check(msgs, truth, "resampled")
    samples = N_MAIN_BLOCKS * cfg.block_size
    print(f"resampled: end to end {samples / wall / 1e6:.1f} Msps at 2 Msps "
          f"out ({samples * q / p / wall / 1e6:.1f} Msps raw) over "
          f"{N_MAIN_BLOCKS} blocks ({wall:.3f} s) [{smi}]", flush=True)

    # the host path: the streaming resampler on the card, then the f32
    # runner, over the capture's first 8 blocks
    n_host = BATCH
    raw = np.fromfile(path, np.complex64, n_host * cfg.block_size * q // p)

    def streamed():
        """The capture through a fresh streaming resampler in 2^20-sample
        pushes: (output, wall s)."""
        rs = streaming_resampler(p, q, device=dev)
        t0 = time.perf_counter()
        out = [rs.push(raw[i: i + (1 << 20)])
               for i in range(0, len(raw), 1 << 20)] + [rs.flush()]
        return np.concatenate(out), time.perf_counter() - t0, rs

    streamed()                 # captures the stride's graph
    with graphs.disable():
        y_eager, eager_wall, _ = streamed()
    y, rs_wall, rs = streamed()
    if len(y) != len(raw) * p // q:
        raise AssertionError(f"streaming_resampler gave {len(y)} samples")
    if not np.array_equal(y, y_eager):
        raise AssertionError("streaming_resampler: the graphed stride != "
                             "the eager stride")
    blk = np.concatenate([np.zeros(rs.hist, np.complex64), raw[:rs.stride]])
    xb = torch.from_numpy(blk.view(np.float32).reshape(-1, 2)).to(dev)

    def stride():
        return PP._streaming_kernel(xb, p, q, rs.t, rs.s_groups, device=dev)

    def stride_eager():
        with graphs.disable():
            return stride()
    st = {"eager": time_ms(stride_eager, device_only=False),
          "graphed": time_ms(stride, device_only=False),
          "eager card": time_ms(stride_eager),
          "graphed card": time_ms(stride)}
    print(f"resampled: streaming_resampler, eager stride "
          f"{len(raw) / eager_wall / 1e6:.2f} Msps raw ({eager_wall:.3f} "
          f"s), graphed stride "
          f"{len(raw) / rs_wall / 1e6:.2f} Msps raw, the same samples bit "
          f"for bit; one stride of {rs.stride} raw samples as the host sees "
          f"it: eager {st['eager']:.4f} ms, graphed {st['graphed']:.4f} ms; "
          f"card alone: eager {st['eager card']:.4f} ms, graphed "
          f"{st['graphed card']:.4f} ms [{smi}]", flush=True)
    t0 = time.perf_counter()
    host_msgs = _messages(S.run_pipelined(
        itertools.islice(sources.resampled_file_source(
            path, cfg, dtype="complex64", rate_in=RESAMPLED_RATE,
            device=dev), n_host), cfg, batch=BATCH, device=dev))
    torch.cuda.synchronize()
    host_wall = time.perf_counter() - t0
    inside = [t for t in truth
              if t.sample_index * p // q + 300 * cfg.sps
              < n_host * cfg.block_size]
    _decode_check(host_msgs, inside, "resampled host path")
    print(f"resampled: host path (streaming_resampler on the card, "
          f"{rs.stride} raw samples per stride, -> run_pipelined f32, B4) "
          f"over {n_host} blocks: {len(host_msgs)} messages, end to end "
          f"{n_host * cfg.block_size / host_wall / 1e6:.2f} Msps at 2 Msps "
          f"out ({host_wall:.3f} s); the streaming resampler alone "
          f"{len(raw) / rs_wall / 1e6:.2f} Msps raw ({rs_wall:.3f} s) "
          f"[{smi}]", flush=True)

    # C = 4 channels of 6 Msps captures to 4 Msps, ending at different
    # blocks
    cfg4 = DspConfig(channel_rate=4e6)
    paths, truths = [], []
    for c, n in enumerate(RS_CHANNEL_BLOCKS):
        paths.append(os.path.join(tmp, f"rs{c}.c64"))
        truths.append(write_raw_capture(cfg4, paths[-1], n, 6e6, 31 + c))
    p4, q4 = rational_rate(6e6, cfg4.channel_rate)
    geom4 = RF.raw_geometry(cfg4, p4, q4)[:3]
    x = torch.cat([next(_raw_batches(pth, geom4, 1, 1))[2] for pth in paths])
    _same_front(x, cfg4, p4, q4, dev, "resampled channels, step 0")
    RF.resample_demod_packed_planar_jit(x, None, cfg4, p4, q4, device=dev)
    stats = BlockStats()
    K.reset_launches()
    t0 = time.perf_counter()
    steps = list(S.run_resampled_fused_channels(
        paths, cfg4, dtype="complex64", rate_in=6e6, stats=stats,
        device=dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    chan = dict(K.LAUNCHES)
    chan["B1"] = K.DETECT_CANDS_ROUTES["B1"]
    for kname in ("B1", "slice_windows"):
        if chan[kname] <= 0:
            raise AssertionError(f"resampled channels: kernel {kname} "
                                 f"never launched")
    if chan["raw_planar"] != max(RS_CHANNEL_BLOCKS):
        raise AssertionError(f"resampled channels: R1 launched "
                             f"{chan['raw_planar']} times")
    if [[m is None for m in st] for st in steps] != [
            [k >= n for n in RS_CHANNEL_BLOCKS]
            for k in range(max(RS_CHANNEL_BLOCKS))]:
        raise AssertionError("resampled channels: ended channels wrong")
    on_cpu = list(S.run_resampled_fused_channels(
        paths, cfg4, dtype="complex64", rate_in=6e6, device="cpu"))
    if len(on_cpu) != len(steps):
        raise AssertionError("resampled channels: step counts differ")
    for k, (a, b) in enumerate(zip(steps, on_cpu)):
        for c in range(len(paths)):
            if (a[c] is None) != (b[c] is None):
                raise AssertionError(f"resampled channels: step {k} ch{c}")
            _same_messages(a[c] or [], b[c] or [],
                           f"resampled channels step {k} ch{c}")
    for c, tr in enumerate(truths):
        _decode_check([m for st in steps for m in (st[c] or [])], tr,
                      f"resampled channels ch{c}")
    samples = sum(RS_CHANNEL_BLOCKS) * cfg4.block_size
    print(f"resampled channels: run_resampled_fused_channels, C = "
          f"{len(paths)}, 6 -> 4 Msps (p/q = {p4}/{q4}, tile "
          f"{K.default_tile(cfg4)}), blocks {RS_CHANNEL_BLOCKS}: every step "
          f"== CPU, ended channels None; launches {chan}; {stats}; end to "
          f"end {samples / wall / 1e6:.1f} Msps at 4 Msps out ({wall:.3f} s)"
          f" [{smi}]", flush=True)
    return launches, chan, r1, path


class _FixedClock:
    """The CLI's clock in phase 14: its epoch is 0.0, as the library
    runners' default, so their messages, SQLite rows and stats compare
    exactly. Sleeps are real."""
    sleep = staticmethod(time.sleep)

    @staticmethod
    def time():
        return 0.0


def _sql_rows(db):
    import sqlite3
    con = sqlite3.connect(db)
    try:
        return con.execute("SELECT * FROM aircraft ORDER BY icao").fetchall()
    finally:
        con.close()


def phase_cli(cfg, dev, tmp, smi, uc8, c64, chans):
    """`modes_rx.main` in-process on the card: --int8 on a 2 Msps uc8
    capture (the native runner), -r 10e6 --int8 (the fused path) and two
    -s captures (the channel runner). Each must exit 0, write the SQLite
    aircraft rows of the library runner's messages through parse and
    output_sql, and write a final stats record with the runner's
    BlockStats counters."""
    from unittest import mock
    import torch
    from airmodes_torch.apps import modes_rx
    from airmodes_torch.decode.parse import parse
    from airmodes_torch.dsp.host import BlockStats
    from airmodes_torch.io import native_stream as N, stream as S
    from airmodes_torch.outputs import output_sql
    runs = [
        ("native int8", ["-s", uc8, "--file-format", "uc8", "--int8"],
         lambda st: _messages(N.run_native_pipelined(
             cfg, path=uc8, fmt="uc8", batch=BATCH, stats=st, device=dev)),
         N_MAIN_BLOCKS),
        ("fused resample", ["-s", c64, "-r", f"{RESAMPLED_RATE:g}",
                            "--int8"],
         lambda st: _messages(S.run_resampled_fused(
             c64, cfg, dtype="complex64", rate_in=RESAMPLED_RATE,
             batch=BATCH, stats=st, device=dev)),
         N_MAIN_BLOCKS),
        ("channels", ["-s", chans[0], "-s", chans[1], "--file-format",
                      "uc8", "--int8"],
         lambda st: [m for step in N.run_native_channels(
             chans, cfg, fmt="uc8", stats=st, device=dev)
             for ch in step for m in (ch or [])],
         2 * CHANNEL_BLOCKS[0]),
    ]
    for k, (name, argv, library, n_blocks) in enumerate(runs):
        db = os.path.join(tmp, f"cli{k}.db")
        sj = os.path.join(tmp, f"cli{k}.stats")
        with mock.patch.object(modes_rx, "time", _FixedClock):
            t0 = time.perf_counter()
            rc = modes_rx.main(argv + ["-n", "-d", db, "--stats-json", sj,
                                       "--stats-interval", "0",
                                       "--block-size", str(cfg.block_size),
                                       "--device", str(dev)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"cli {name}: exit code {rc}")
        stats = BlockStats()
        msgs = library(stats)
        ref_db = os.path.join(tmp, f"lib{k}.db")
        sql = output_sql(ref_db, parse(None))
        for m in msgs:
            sql.output(m)
        sql.close()
        got, want = _sql_rows(db), _sql_rows(ref_db)
        if got != want or not got:
            raise AssertionError(f"cli {name}: {len(got)} aircraft rows, "
                                 f"the library's {len(want)}")
        with open(sj) as f:
            rec = json.loads(f.read().splitlines()[-1])
        for key in ("preambles", "crc_ok", "corrected", "crc_fail",
                    "emitted", "overflow", "ring_dropped"):
            if rec[key] != getattr(stats, key):
                raise AssertionError(f"cli {name}: stats {key} "
                                     f"{rec[key]} != {getattr(stats, key)}")
        print(f"cli: {name}: exit 0, {len(got)} aircraft rows == the "
              f"library runner's, stats record == its BlockStats "
              f"({rec['emitted']} emitted); {wall:.3f} s wall, "
              f"{n_blocks * cfg.block_size / wall / 1e6:.1f} Msps [{smi}]",
              flush=True)


SHARDED_MESH = (2, 4)        # (channels, time shards) of phase 15
SHARDED_STEPS = 4
SHARDED_TAIL = 4321          # samples past the last full step
SHARDED_CHUNK = 3_000_000    # samples per run_stream chunk


def sharded_capture(cfg, n_steps, n_time, tail, seed):
    """Two channels of mixed traffic (~100 msg/s at 15 dB) over n_steps
    steps of n_time blocks plus `tail` samples, complex64, each with a
    DF17 frame planted 130 samples before every inner time-shard
    boundary and 100 before every step boundary (its body crosses the
    boundary) where no traffic frame is within 600 samples. Returns
    ((2, N) complex64, truth of both channels)."""
    import numpy as np
    from airmodes_torch.testing import encoder
    blk = cfg.block_size
    step = n_time * blk
    total = n_steps * step + tail
    n_msgs = max(int(total / cfg.channel_rate * 100.0), 8)
    out = np.empty((2, total), np.complex64)
    truth = []
    for c in range(2):
        iq, tr = encoder.make_capture(
            encoder.random_mixed_frames(n_msgs, seed=seed + c),
            rate=cfg.channel_rate, snr_db=15.0, spacing=total // n_msgs,
            start=1024 + 4999 * c, seed=seed + c, total_samples=total)
        rng = np.random.default_rng(seed + 10 + c)
        amp = tr[0].amplitude
        busy = np.array([t.sample_index for t in tr])
        bounds = range(blk, total, blk)
        plants = encoder.random_df17_frames(len(bounds), seed=seed + 20 + c)
        for b, (frame, nbits) in zip(bounds, plants):
            pos = b - (100 if b % step == 0 else 130)
            if np.abs(busy - pos).min() < 600:
                continue
            pulse = np.repeat(encoder.frame_to_chips(frame, nbits), cfg.sps)
            phase = np.exp(2j * np.pi * rng.random())
            iq[pos: pos + pulse.size] += (amp * phase * pulse).astype(
                np.complex64)
            tr.append(encoder.GroundTruth(frame, nbits, pos, amp, 15.0,
                                          cfg.sps))
        out[c] = iq
        truth += tr
    return out, truth


def _stream_messages(pipe, x, chunk):
    """run_stream over x in chunks of `chunk` samples: the steps' message
    lists."""
    return list(pipe.run_stream(x[:, i: i + chunk]
                                for i in range(0, x.shape[1], chunk)))


def phase_sharded(cfg, dev, tmp, smi):
    """The sharded path on the card (phase 15). Returns the B1 and B2
    launches of its PodPipeline run."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from airmodes_torch.dist import sharded
    from airmodes_torch.dist.multihost import PodPipeline
    from airmodes_torch.dsp import host
    from airmodes_torch.dsp.pipeline import unpack_table
    from airmodes_torch.kernels import preamble as K
    from airmodes_torch.resample import fused as RF
    from airmodes_torch.resample.polyphase import rational_rate
    from airmodes_torch.utils import graphs

    n_ch, n_t = SHARDED_MESH
    t0 = time.perf_counter()
    x, truth = sharded_capture(cfg, SHARDED_STEPS, n_t, SHARDED_TAIL, 31)
    n_plant = sum(1 for t in truth if t.sample_index % cfg.block_size
                  in (cfg.block_size - 100, cfg.block_size - 130))
    print(f"sharded: 2 channels of {x.shape[1]} samples ({SHARDED_STEPS} "
          f"steps of {n_t} x {cfg.block_size} + {SHARDED_TAIL}), "
          f"{len(truth)} frames ({n_plant} planted across shard and step "
          f"boundaries), built in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 1. PodPipeline on a (2, 4) mesh, planar chosen on the card
    pipe = PodPipeline(cfg, n_channel=n_ch, n_time=n_t, device=dev)
    if pipe.planar is not True:
        raise AssertionError("PodPipeline(planar=None) did not choose the "
                             "planar path on the card")
    _stream_messages(pipe, x[:, : pipe.samples_per_step], SHARDED_CHUNK)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    steps = _stream_messages(pipe, x, SHARDED_CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"B1": K.DETECT_CANDS_ROUTES["B1"],
                "slice_windows": K.LAUNCHES["slice_windows"]}
    others = {k: v for k, v in K.DETECT_CANDS_ROUTES.items() if k != "B1"}
    print(f"sharded: launches {dict(K.LAUNCHES)}, routes "
          f"{dict(K.DETECT_CANDS_ROUTES)} over {len(steps)} steps",
          flush=True)
    if launches != {"B1": len(steps), "slice_windows": len(steps)} \
            or any(others.values()) or K.LAUNCHES["detect_mask"]:
        raise AssertionError(f"sharded: B1 and B2 must launch once per "
                             f"step ({len(steps)}), got {launches}")
    msgs = [m for st in steps for m in st]
    cpu = PodPipeline(cfg, n_channel=n_ch, n_time=n_t, planar=True,
                      device="cpu")
    t1 = time.perf_counter()
    on_cpu = _stream_messages(cpu, x, SHARDED_CHUNK)
    if steps != on_cpu:
        raise AssertionError(f"sharded: the card's messages != the CPU's "
                             f"({len(msgs)} vs "
                             f"{sum(len(s) for s in on_cpu)})")
    print(f"sharded: all {len(msgs)} messages of {len(steps)} steps on the "
          f"card == on the CPU ({time.perf_counter() - t1:.1f} s)",
          flush=True)

    # the same samples as unsharded blocks: frame_planar at the pipeline's
    # gain, batches of 8 through the planar step
    n_blocks = len(steps) * n_t
    rows = [frame_planar(x[c], cfg, n_blocks, pipe.gain) for c in range(2)]
    xi = np.concatenate([r[0] for r in rows])
    xq = np.concatenate([r[1] for r in rows])
    flat = []
    for lo in range(0, len(xi), BATCH):
        packed = K.demod_batch_packed_planar(
            xi[lo: lo + BATCH], xq[lo: lo + BATCH], cfg,
            device=dev).cpu().numpy()
        for j, row in enumerate(packed):
            k = (lo + j) % n_blocks
            flat += host.table_to_messages(
                unpack_table(row), k * cfg.block_size, cfg.channel_rate,
                full_scale=pipe.gain / 127.0)
    key = lambda m: (float(m.split()[5]), m)  # noqa: E731
    if sorted(msgs, key=key) != sorted(flat, key=key):
        raise AssertionError(f"sharded: {len(msgs)} messages != the "
                             f"unsharded planar step's {len(flat)}")
    print(f"sharded: == the unsharded planar step over the same "
          f"{2 * n_blocks} blocks", flush=True)
    _decode_check(msgs, truth, "sharded")
    got = {m.split()[1] for m in msgs}
    lost = [t.hex for t in truth if t.hex not in got
            and t.sample_index % cfg.block_size >= cfg.block_size - 130]
    if lost:
        raise AssertionError(f"sharded: boundary frames lost: {lost}")

    # the step alone, and the unsharded 8-block step, on step 2's input
    S = pipe.samples_per_step
    qs = [host.quantize_i8_np(x[:, a: a + S].real, pipe.gain) for a in
          (0, S, 2 * S)]
    qq = [host.quantize_i8_np(x[:, a: a + S].imag, pipe.gain) for a in
          (0, S, 2 * S)]
    dv = [sharded.shard_input_planar(i, q, pipe.mesh) for i, q in
          zip(qs, qq)]
    args = (dv[0][0], dv[0][1], dv[1][0], dv[1][1], dv[2][0], dv[2][1])

    def eager3():
        with graphs.disable():
            return pipe.step3_fn(*args)
    if not torch.equal(eager3(), pipe.step3_fn(*args)):
        raise AssertionError("sharded: the graphed step3_fn != its eager "
                             "step")
    step_ms = time_ms(lambda: pipe.step3_fn(*args), device_only=False)
    st = {"eager": time_ms(eager3, device_only=False),
          "eager card": time_ms(eager3),
          "graphed card": time_ms(lambda: pipe.step3_fn(*args))}
    print(f"sharded: step3_fn as the host sees it: eager {st['eager']:.4f} "
          f"ms, graphed {step_ms:.4f} ms; card alone: eager "
          f"{st['eager card']:.4f} ms, graphed {st['graphed card']:.4f} ms "
          f"(the graphed step == the eager one bit for bit) [{smi}]",
          flush=True)
    bi = torch.from_numpy(np.concatenate(
        [xi[c * n_blocks + n_t: c * n_blocks + 2 * n_t] for c in range(2)]
    )).to(dev)
    bq = torch.from_numpy(np.concatenate(
        [xq[c * n_blocks + n_t: c * n_blocks + 2 * n_t] for c in range(2)]
    )).to(dev)
    flat_ms = time_ms(lambda: K.demod_batch_packed_planar(bi, bq, cfg,
                                                          device=dev),
                      device_only=False)
    print("sharded: the profile of the eager sharded step", flush=True)
    profile_step(eager3, smi, expect=B1_B2_SYMBOLS)
    print("sharded: the profile of the graphed sharded step", flush=True)
    rows = [profile_step(lambda: pipe.step3_fn(*args), smi,
                         expect=B1_B2_SYMBOLS)]
    print("sharded: the profile of the unsharded 8-block step", flush=True)
    rows.append(profile_step(
        lambda: K.demod_batch_packed_planar(bi, bq, cfg, device=dev), smi,
        expect=B1_B2_SYMBOLS))
    if all(rows):
        busy = [sum(r[0] for r in rs) / 5 for rs in rows]
        print(f"sharded: device busy {busy[0]:.1f} us per sharded step "
              f"(graphed), {busy[1]:.1f} us per unsharded step [{smi}]",
              flush=True)
    n_s = n_ch * S
    print(f"sharded: step {step_ms:.4f} ms ({n_s / step_ms / 1e3:.1f} Msps) "
          f"against the unsharded 8-block step {flat_ms:.4f} ms, both as "
          f"the host sees them; end to end "
          f"{2 * x.shape[1] / wall / 1e6:.1f} Msps over {len(steps)} steps "
          f"({wall:.3f} s) [{smi}]", flush=True)

    # 2. the f32 path over the first two steps: the CPU's messages
    two = x[:, : 2 * S]
    f32 = PodPipeline(cfg, n_channel=n_ch, n_time=n_t, planar=False,
                      device=dev)
    t0 = time.perf_counter()
    f32_msgs = _stream_messages(f32, two, SHARDED_CHUNK)
    torch.cuda.synchronize()
    f32_wall = time.perf_counter() - t0
    f32_cpu = _stream_messages(PodPipeline(cfg, n_channel=n_ch, n_time=n_t,
                                           planar=False, device="cpu"),
                               two, SHARDED_CHUNK)
    if f32_msgs != f32_cpu:
        raise AssertionError("sharded f32: the card's messages != the CPU's")
    flat32 = [m for st in f32_msgs for m in st]
    early = [t for t in truth if t.sample_index < 2 * S - 400]
    _decode_check(flat32, early, "sharded f32")
    print(f"sharded f32: {len(flat32)} messages of 2 steps on the card == "
          f"on the CPU; end to end {2 * two.shape[1] / f32_wall / 1e6:.1f} "
          f"Msps [{smi}]", flush=True)

    # 3. the fused resample -> int8 -> planar step on a (1, 4) mesh
    p, q = rational_rate(RESAMPLED_RATE, cfg.channel_rate)
    path = os.path.join(tmp, "sharded_raw.c64")
    rs_truth = write_raw_capture(cfg, path, 4, RESAMPLED_RATE, 33)
    raw = np.fromfile(path, np.complex64)
    iqp = np.stack([raw.real, raw.imag]).astype(np.float32)[None]
    gain = np.float32(120.0)
    mesh14 = sharded.make_mesh(1, 4, device=dev)
    fn = sharded.make_sharded_resample_demod(mesh14, cfg, p, q, planar=True)
    shards = sharded.shard_input_resample_planar(iqp, mesh14)
    fn(shards, gain)           # captures the step's graph
    K.reset_launches()
    table = fn(shards, gain)
    rs_msgs = _table_messages(table, cfg, float(gain) / 127.0)
    if K.DETECT_CANDS_ROUTES["B1"] != 1 or K.LAUNCHES["slice_windows"] != 1:
        raise AssertionError("sharded resample: B1 and B2 must launch once "
                             "per replay")
    cpu14 = sharded.make_mesh(1, 4, device="cpu")
    rs_cpu = _table_messages(sharded.make_sharded_resample_demod(
        cpu14, cfg, p, q, planar=True)(
        sharded.shard_input_resample_planar(iqp, cpu14), gain), cfg,
        float(gain) / 127.0)
    worst = _same_messages(rs_msgs, rs_cpu, "sharded resample")
    rl, rb, rr, _ = RF.raw_geometry(cfg, p, q)
    padded = np.concatenate([np.zeros((1, 2, rl), np.float32), iqp,
                             np.zeros((1, 2, rr), np.float32)], axis=2)
    wins = np.concatenate([padded[:, :, t * rb: t * rb + rl + rb + rr]
                           for t in range(4)])
    packed, _ = RF.resample_demod_packed_planar(wins, gain, cfg, p, q,
                                                device=dev)
    flat_rs = []
    for t, row in enumerate(packed.cpu().numpy()):
        flat_rs += host.table_to_messages(
            unpack_table(row), t * cfg.block_size, cfg.channel_rate,
            full_scale=float(gain) / 127.0)
    worst = max(worst, _same_messages(rs_msgs, sorted(flat_rs, key=key),
                                      "sharded resample vs unsharded"))
    _decode_check(rs_msgs, rs_truth, "sharded resample")
    print(f"sharded resample: (1, 4) mesh, p/q = {p}/{q}, {len(rs_msgs)} "
          f"messages == the CPU's and the unsharded fused step's "
          f"(ref_dbfs within {worst:.3f} dB)", flush=True)

    # 4. the (1, 4) planar step through a one-rank NCCL group
    xi4 = host.quantize_i8_np(x[:1, :S].real, pipe.gain)
    xq4 = host.quantize_i8_np(x[:1, :S].imag, pipe.gain)
    local = sharded.make_sharded_demod_planar(mesh14, cfg)(
        *sharded.shard_input_planar(xi4, xq4, mesh14))
    # one process on one card: NCCL's bootstrap may use the loopback
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        nccl = sharded.make_mesh(1, 4, group=dist.group.WORLD, device=dev)
        got = sharded.make_sharded_demod_planar(nccl, cfg)(
            *sharded.shard_input_planar(xi4, xq4, nccl))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    for name, a, b in zip(got._fields, got, local):
        if not torch.equal(a, b):
            raise AssertionError(f"one-rank NCCL mesh != local mesh: {name}")
    print(f"sharded: the (1, 4) step through a one-rank NCCL group == the "
          f"local mesh ({int((local.index >= 0).sum())} detections)",
          flush=True)
    return launches


def _rate_ok(what, nbytes, ms, smi):
    """Fail a reading above 105% of the card's nominal 3.35 TB/s: a timing
    fault."""
    from airmodes_torch.kernels.opcount import PEAK_BYTES_S
    rate = nbytes / (ms * 1e-3)
    if rate > 1.05 * PEAK_BYTES_S:
        raise AssertionError(f"{what}: {rate / 1e9:.1f} GB/s is above 105% "
                             f"of 3.35 TB/s, a timing fault [{smi}]")


def _ablate_check(iq, cfg):
    """Each cut of P4 launched once on (C, L, 2) int8 `iq` with its count
    at 0, held exactly against its plain version at every stage and, at
    stage 5, against kernel B4 on the same operands. Returns (launches per
    stage, the largest |kernel - plain| over the stages)."""
    import torch
    from airmodes_torch.kernels import preamble as K
    from airmodes_torch.probes import kernel_ablate as KA
    shape = f"C={iq.shape[0]}, block {cfg.block_size}"
    KA.reset_launches()
    cuts = {s: KA.ablate(iq, cfg, s) for s in KA.STAGES}
    torch.cuda.synchronize()
    launches = dict(KA.LAUNCHES)
    ops = K.b4_operands(iq, cfg, KA.TILE)
    worst = 0.0
    for s, (mask, ref) in cuts.items():
        want = KA.ablate_plain(*ops, cfg, s)
        err = max(float((mask - want[0]).abs().max()),
                  float((ref - want[1]).abs().max()))
        worst = max(worst, err)
        print(f"probe detect_ablate stages<={s} ({shape}): mask ones "
              f"{int(want[0].sum())}, max |kernel - plain| {err}",
              flush=True)
        if not (torch.equal(mask, want[0]) and _ref_equal(ref, want[1])):
            raise AssertionError(f"detect_ablate stages<={s} != plain "
                                 f"({shape})")
        if launches[s] != 1:
            raise AssertionError(f"detect_ablate stages<={s} launched "
                                 f"{launches[s]} times")
    b4 = K.preamble_detect_2d_batch(iq, cfg, KA.TILE)
    if not (torch.equal(cuts[5][0], b4[0]) and _ref_equal(cuts[5][1],
                                                          b4[1])):
        raise AssertionError(f"detect_ablate stage 5 != kernel B4 ({shape})")
    print(f"probe detect_ablate stage 5 == B4 on the same operands "
          f"({shape}, {int(b4[0].sum())} hits)", flush=True)
    return launches, worst


def phase_probes(dev, smi, flush):
    """The probes (phase 16): P1-P3 (bw_probe), P4 (kernel_ablate) and P5
    with the planar stage split (unordered_stage_probe), each at its
    script's size. Each probe kernel is launched once through its module's
    public function with the counts at 0, held against its plain version
    (exactly; P4 at every stage, and at stage 5 also against B4), then
    timed by the module's own measure(); P4 also at the main path's B4
    shape (C = 8 blocks of 2^20). Returns the five kernel rows."""
    import torch
    from airmodes_torch.kernels import preamble as K
    from airmodes_torch.kernels.opcount import (
        ablate_probe_instr, bound, copy_probe_cost, read_probe_cost)
    from airmodes_torch.probes import bw_probe as BW
    from airmodes_torch.probes import kernel_ablate as KA
    from airmodes_torch.probes import unordered_stage_probe as US
    t0 = time.perf_counter()
    rows = []

    # P1-P3, each launched once per size with its counts at 0 and held
    # exactly against its plain version: 3 rows short of (2^21, 128) f32
    # (a 77-row tail past the last window), 1000 rows (6 windows, fewer
    # than the SMs), 100 rows (no window: an empty output), then the full
    # 1 GiB, whose run's launches the rows report
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"bw_probe dynamic shared memory (their ptxas lines are above): "
          f"copy_kernel 0, dma_read_kernel {BW.WROWS * BW.LANES * 4}, "
          f"ring_read_kernel {BW.ring_geometry(BW.ROWS, sms)[2]} of "
          f"{BW.SMEM_PER_CTA} bytes", flush=True)
    bw_err = {k: 0.0 for k in BW.LAUNCHES}
    # P2's and P3's function in one PyTorch call (their library yardstick):
    # ones(8, 144) @ each window, f32 with TF32 off, each window's column
    # sums on its 8 rows, summed in cuBLAS's order
    ones = torch.ones((BW.OUT_ROWS, BW.WROWS), device=dev)

    def rows_matmul(x):
        steps = BW.windows(x.shape[0])
        return torch.matmul(ones, x[:steps * BW.WROWS].view(
            steps, BW.WROWS, BW.LANES)).view(steps * BW.OUT_ROWS, BW.LANES)

    for n_rows in (BW.ROWS - 3, 1000, 100, BW.ROWS):
        x = BW.make_input(n_rows, dev)
        BW.reset_launches()
        got = {"copy": BW.copy(x), "dma_read": BW.dma_read(x),
               "dma2_read": BW.dma2_read(x)}
        torch.cuda.synchronize()
        bw_launches = dict(BW.LAUNCHES)
        lib = rows_matmul(x)
        if lib.shape != got["dma_read"].shape or not torch.allclose(
                lib, got["dma_read"], rtol=1e-5, atol=1e-4):
            raise AssertionError(f"the 8-row matmul != P2 at {n_rows} rows")
        del lib
        want_read = BW.read_plain(x)
        for name, want in (("copy", BW.copy_plain(x)),
                           ("dma_read", want_read), ("dma2_read", want_read)):
            err = float((got[name] - want).abs().max()) if want.numel() \
                else 0.0
            bw_err[name] = max(bw_err[name], err)
            print(f"probe {name} ({n_rows} rows, output "
                  f"{tuple(want.shape)}): max |kernel - plain| {err}, "
                  f"launches {bw_launches[name]}", flush=True)
            if not torch.equal(got[name], want) or bw_launches[name] != 1:
                raise AssertionError(f"probe {name} at {n_rows} rows: kernel "
                                     f"!= plain or launches "
                                     f"{bw_launches[name]} != 1")
        del got, want, want_read
    lines = {r["name"]: r for r in BW.measure(x)}
    for r in lines.values():
        _rate_ok(r["name"], r["bytes"], r["ms"], smi)
        print(f"bw: {r['name']:30s} {r['ms']:.5f} ms {r['gbps']:.1f} GB/s "
              f"over its {r['bytes']} bytes, host {r['host_ms']:.3f} ms "
              f"[{smi}]", flush=True)
    copy_plain_ms = time_ms(lambda: BW.copy_plain(x), iters=5, flush=flush)
    read_plain_ms = time_ms(lambda: BW.read_plain(x), iters=5, flush=flush)
    read_lib_ms = time_ms(lambda: rows_matmul(x), flush=flush)
    nb, _ = read_probe_cost(BW.ROWS)
    print(f"bw: torch 8-row matmul (R), P2's and P3's function in one call "
          f"(== P2 within rtol 1e-5, atol 1e-4) {read_lib_ms:.5f} ms "
          f"{nb / read_lib_ms / 1e6:.1f} GB/s over P2's {nb} bytes [{smi}]",
          flush=True)
    nb, ni = copy_probe_cost(BW.ROWS)
    bms, by = bound(nb, ni)
    p1 = lines["P1 copy kernel (R+W)"]
    rows.append({"name": "bw_probe copy (P1)", "route": "cuda",
                 "source": "airmodes_torch/kernels/csrc/bw_probe.cu",
                 "replaces": "scripts/tpu_bw_probe.py:63",
                 "launches": bw_launches["copy"],
                 "max_abs_err": bw_err["copy"], "ms": p1["ms"],
                 "plain_ms": copy_plain_ms, "bound_ms": bms, "bound_by": by,
                 "library_ms": lines["torch copy (R+W)"]["ms"],
                 "gbps": p1["gbps"]})
    nb, ni = read_probe_cost(BW.ROWS)
    bms, by = bound(nb, ni)
    for key, line, name, ref in (
            ("dma_read", "P2 bulk-copy read (R)", "bw_probe read (P2)", 84),
            ("dma2_read", "P3 ring bulk-copy read (R)",
             "bw_probe ring read (P3)", 109)):
        rows.append({"name": name, "route": "cuda",
                     "source": "airmodes_torch/kernels/csrc/bw_probe.cu",
                     "replaces": f"scripts/tpu_bw_probe.py:{ref}",
                     "launches": bw_launches[key], "max_abs_err": bw_err[key],
                     "ms": lines[line]["ms"], "plain_ms": read_plain_ms,
                     "bound_ms": bms, "bound_by": by,
                     "library_ms": read_lib_ms,
                     "gbps": lines[line]["gbps"]})
    del x
    torch.cuda.empty_cache()

    # P4: B4 cut after each stage, at the script's C = 16 blocks of 2^22
    # int8 noise, then at the main path's C = 8 blocks of 2^20
    p4 = None
    for channels, block in ((KA.C, KA.BLOCK), (8, 1 << 20)):
        cfg4 = KA.probe_config(block)
        iq = torch.from_numpy(KA.make_input(cfg4, channels)).to(dev)
        ab_launches, ab_err = _ablate_check(iq, cfg4)
        stages = KA.measure(iq, cfg4)
        nbytes = KA.stage_bytes(cfg4, channels)
        for r in stages:
            _rate_ok(KA.label(r["stages"]), nbytes, r["ms_f32"], smi)
            inc = "" if r["inc_ms"] is None else f", +{r['inc_ms']:.5f}"
            print(f"ablate C={channels} block {block}: "
                  f"{KA.label(r['stages']):10s} {r['ms']:.5f} ms "
                  f"{r['msps']:.0f} Msps with the int8 -> f32 pass; "
                  f"{r['ms_f32']:.5f} ms {r['msps_f32']:.0f} Msps without"
                  f"{inc}; host {r['host_ms']:.3f} ms [{smi}]", flush=True)
        if p4 is None:
            ops = K.b4_operands(iq, cfg4, KA.TILE)
            half = cfg4.nms_chips * cfg4.sps
            samples = channels * cfg4.block_size
            bms, by = bound(nbytes, ablate_probe_instr(samples, 5, cfg4.sps,
                                                       half))
            p4 = {"name": "detect_ablate (P4, stage 5 = B4)",
                  "route": "cuda",
                  "source": "airmodes_torch/kernels/csrc/detect_ablate.cu",
                  "replaces": "scripts/tpu_kernel_ablate.py:42",
                  "launches": sum(ab_launches.values()),
                  "max_abs_err": ab_err, "ms": stages[5]["ms_f32"],
                  "plain_ms": time_ms(lambda: KA.ablate_plain(
                      *ops, cfg4, 5), iters=3, flush=flush),
                  "bound_ms": bms, "bound_by": by, "library_ms": None,
                  "stage_ms": {r["stages"]: r["ms_f32"] for r in stages},
                  "launches_by_stage": ab_launches}
            del ops
        del iq
        torch.cuda.empty_cache()
    rows.append(p4)

    # P5 and the planar stage split, C = 64 blocks of 2^22 in planar int8
    cfg5 = US.probe_config()
    xi, xq = US.make_input(cfg5, US.C, US.TILE, dev)
    US.reset_launches()
    got = US.step_floor(xi, xq, cfg5, US.TILE)
    torch.cuda.synchronize()
    fl_launches = US.LAUNCHES["planar_floor"]
    want = US.floor_plain(xi, xq, cfg5, US.TILE)
    fl_err = int((got - want).abs().max())
    print(f"probe planar_floor: max |kernel - plain| {fl_err}", flush=True)
    if not torch.equal(got, want) or fl_launches != 1:
        raise AssertionError(f"planar_floor != plain or launches "
                             f"{fl_launches} != 1")
    split = {r["name"]: r for r in US.measure(xi, xq, cfg5)}
    nbytes = US.floor_bytes(cfg5, US.C)
    _rate_ok("planar_floor", nbytes, split["floor"]["ms"], smi)
    for r in split.values():
        card = "not measured" if r["card_ms"] is None else \
            f"{r['card_ms']:.5f} ms"
        print(f"stage split: {r['name']:6s} {r['ms']:.5f} ms "
              f"{r['gsps']:.3f} Gsps, card {card}, host best "
              f"{r['host_best_ms']:.3f} ms "
              f"(all {[round(t, 3) for t in r['host_ms']]}) [{smi}]",
              flush=True)
    bms, by = bound(nbytes, 0)
    rows.append({"name": "planar_floor (P5)", "route": "cuda",
                 "source": "airmodes_torch/kernels/csrc/planar_floor.cu",
                 "replaces": "scripts/tpu_unordered_stage_probe.py:50",
                 "launches": fl_launches, "max_abs_err": fl_err,
                 "ms": split["floor"]["card_ms"],
                 "plain_ms": time_ms(lambda: US.floor_plain(
                     xi, xq, cfg5, US.TILE), iters=5, flush=flush),
                 "bound_ms": bms, "bound_by": by, "library_ms": None})
    del xi, xq, got, want
    torch.cuda.empty_cache()
    print(f"probes: phase 16 took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return rows


# --- phase 17: the profiler's view of the hand kernels (fault C2) -----------

C2_REPS = 5                  # profiled calls per window
C2_WINDOWS = 40              # one-step sessions that must each lose nothing


def _bare_b1_b2(cfg, ti, tq, between):
    """A function that launches B1 (unordered) and B2 straight from their
    launch functions into buffers made once, so that no torch kernel runs
    beside them; with `between`, a one-element add after each launch."""
    import torch
    from airmodes_torch.kernels import preamble as K
    tile = K.default_tile(cfg)
    s_shape, o_shape = K.detect_cands_buffers(ti.shape[0], cfg, tile)
    scratch = torch.empty(s_shape, dtype=torch.int32, device=ti.device)
    out = torch.empty(o_shape, dtype=torch.int32, device=ti.device)
    K.launch_detect_cands(ti, tq, cfg, tile, scratch, out, ordered=False)
    det, valid, _, _ = K.compact_candidates_unordered(out, cfg, tile)
    base = b2_bases(cfg, ti, det, valid)
    ri, rq = ti.reshape(-1, 128), tq.reshape(-1, 128)
    w = torch.empty((base.numel(), K._slice_cols(cfg)), dtype=torch.float32,
                    device=ti.device)
    one = torch.zeros(1, device=ti.device)

    def step():
        K.launch_detect_cands(ti, tq, cfg, tile, scratch, out,
                              ordered=False)
        if between:
            one.add_(1.0)
        K.launch_slice_windows(ri, rq, base, cfg, w)
        if between:
            one.add_(1.0)
    return step


def _no_rows(counts):
    """trace_counts without its per-name rows (a report's JSON)."""
    return {k: v for k, v in counts.items() if k != "by_name"}


def _cudart_maps():
    """The libcudart files mapped into this process."""
    with open("/proc/self/maps") as f:
        return sorted({ln.split()[-1] for ln in f if "libcudart" in ln})


def c2_report(cfg, dev, tmp, uc8, flush, windows=C2_WINDOWS):
    """What the port's profiler shows of the hand kernels, as numbers (phase
    17 holds them; trace_check.py prints them for any tree):

      cudart: the libcudart files this process maps, and each kernel
          library's libcudart line from `ldd` (none: a static runtime);
      cli: `modes_rx --int8 --profile` over the uc8 capture, in-process:
          the wrappers' launch counter deltas (B1, B2) and trace_counts of
          the trace it wrote;
      bare, bare+op: C2_REPS calls of _bare_b1_b2 without and with a torch
          kernel between the launches: trace_counts;
      step: C2_REPS int8 steps (`demod_batch_packed_planar`) on the
          capture's first BATCH blocks: trace_counts;
      graphed: C2_REPS replays of the compiled step
          (`demod_batch_packed_planar_jit`, captured before the session)
          on the same blocks: trace_counts;
      windows: `windows` sessions of one such step each: their lost
          launches, the card clock's lead and B1's device events;
      big: at C = 64 blocks of 2^22 (the stage probe's input), for B1
          ("k") and the whole step ("full"): the card time per call
          (`time_ms`, behind a spin) and trace_counts of C2_REPS calls."""
    import glob
    import subprocess
    import torch
    from airmodes_torch.apps import modes_rx
    from airmodes_torch.kernels import _ext
    from airmodes_torch.kernels import preamble as K
    from airmodes_torch.probes import unordered_stage_probe as US
    rep = {"cudart": {"maps": _cudart_maps(), "ldd": {}}}
    for name in _ext.SIGNATURES:
        ldd = subprocess.run(["ldd", _ext._target(name)], capture_output=True,
                             text=True, timeout=60).stdout
        rep["cudart"]["ldd"][name] = [ln.strip() for ln in ldd.splitlines()
                                      if "cudart" in ln]

    logdir = os.path.join(tmp, "profile")
    K.reset_launches()
    step = K.demod_batch_packed_planar_jit
    graph0 = (step.captures, step.replays)
    rc = modes_rx.main(["-s", uc8, "--file-format", "uc8", "--int8", "-n",
                        "--stats-interval", "0", "--block-size",
                        str(cfg.block_size), "--device", str(dev),
                        "--profile", logdir])
    torch.cuda.synchronize()
    traces = glob.glob(os.path.join(logdir, "trace_*.json"))
    rep["cli"] = {"rc": rc, "launches": {
        "B1": K.DETECT_CANDS_ROUTES["B1"],
        "B2": K.LAUNCHES["slice_windows"]},
        "captures": step.captures - graph0[0],
        "replays": step.replays - graph0[1],
        "traces": len(traces),
        "trace": _no_rows(trace_counts(traces[0])) if traces else None}

    xi, xq = first_batch(cfg, uc8)
    ti, tq = torch.from_numpy(xi).to(dev), torch.from_numpy(xq).to(dev)
    for key, between in (("bare", False), ("bare+op", True)):
        rep[key] = _no_rows(profile_window(
            _bare_b1_b2(cfg, ti, tq, between), C2_REPS)[0])
    rep["step"] = _no_rows(profile_window(
        lambda: K.demod_batch_packed_planar(ti, tq, cfg, device=dev),
        C2_REPS)[0])
    rep["graphed"] = _no_rows(profile_window(
        lambda: step(ti, tq, cfg, device=dev), C2_REPS)[0])
    rep["windows"] = []
    for _ in range(windows):
        c = profile_window(lambda: K.demod_batch_packed_planar(
            ti, tq, cfg, device=dev), 1)[0]
        rep["windows"].append({k: c[k] for k in ("lost", "primer_lost",
                                                 "lead_us")}
                              | {"B1": c["kernels"]["detect_chunk_kernel"]})
    del ti, tq

    cfg5 = US.probe_config()
    xi5, xq5 = US.make_input(cfg5, US.C, US.TILE, dev)
    variants = US.variants(cfg5)
    rep["big"] = {}
    for name in ("k", "full"):
        def fn(f=variants[name]):
            return f(xi5, xq5)
        rep["big"][name] = {"card_ms": time_ms(fn, flush=flush),
                            "trace": _no_rows(profile_window(fn,
                                                             C2_REPS)[0])}
    del xi5, xq5
    torch.cuda.empty_cache()
    return rep


def _per_call_ok(what, counts, want, ranges):
    """Each symbol of `want` in `counts` (trace_counts) exactly as often as
    `want` says, none without its CPU launch, and each range of `ranges`
    as often as it says; prints the counts, raises on a miss."""
    print(f"profile: {what}: device events "
          f"{ {k: counts['kernels'][k] for k in want} }, without their CPU "
          f"launch { {k: counts['orphans'][k] for k in want} }, ranges "
          f"{ {k: counts['ranges'].get(k, 0) for k in ranges} } (wanted "
          f"{want}, {ranges}); {counts['lost']} launches of any kernel "
          f"without a device event (the primer's: {counts['primer_lost']}), "
          f"the card's clock {counts['lead_us']:.1f} us early", flush=True)
    for sym, n in want.items():
        if counts["kernels"][sym] != n or counts["orphans"][sym]:
            raise AssertionError(f"profile: {what}: {sym} x"
                                 f"{counts['kernels'][sym]} in the trace "
                                 f"({counts['orphans'][sym]} without their "
                                 f"launch), launched {n} (fault C2)")
    for name, n in ranges.items():
        if counts["ranges"].get(name, 0) != n:
            raise AssertionError(f"profile: {what}: range {name!r} x"
                                 f"{counts['ranges'].get(name, 0)}, "
                                 f"{n} wrapper calls")


def phase_profile(cfg, dev, tmp, smi, uc8, flush):
    """Phase 17: the port's profiler trace holds every hand-kernel launch
    (fault C2). `modes_rx --int8 --profile` over phase 6's capture, whose
    runner replays the compiled step: each kernel's device events equal
    its wrapper's launch-counter delta times the kernels per call (B1: a
    chunk and a merge kernel; B2: one), each with its CPU launch (the
    replay's graph launch), and the "graph <step>" ranges equal the
    replays; for B1 and B2 launched bare, with no torch
    kernel beside them and with one between, and for the eager int8
    step, the "B1 detect_cands" and "B2 slice_windows" ranges equal the
    wrapper calls; the compiled step's replays hold B1 and B2 once each,
    under "graph <step>" ranges and none of the wrappers', no launch
    without its device event; C2_WINDOWS
    sessions of one int8 step, none losing a device
    event of its work; at C = 64 blocks of 2^22 B1's summed trace time
    within 5% of its card time behind a spin, and the step's trace busy
    time printed beside its card time. (The int8, f32, resampled and
    sharded steps' profiles of phases 6, 7, 13 and 15 hold B1 and B2, or
    B4, on every rep.)"""
    from airmodes_torch.utils.profiling import SETTLE_S
    t0 = time.perf_counter()
    r = c2_report(cfg, dev, tmp, uc8, flush)
    print(f"profile: libcudart mapped in this process: "
          f"{r['cudart']['maps']}; each kernel library's ldd line: "
          f"{r['cudart']['ldd']}", flush=True)
    cli = r["cli"]
    n1, n2 = cli["launches"]["B1"], cli["launches"]["B2"]
    if cli["rc"] != 0 or cli["traces"] != 1 or n1 <= 0 or n2 <= 0:
        raise AssertionError(f"profile: modes_rx --int8 --profile: exit "
                             f"{cli['rc']}, {cli['traces']} traces, "
                             f"launches {cli['launches']}")
    # the CLI's int8 runner replays the compiled step (captured in phase
    # 6, or here in its own range): its kernels are read by symbol, each
    # replay's under the replay's one graph launch, against the launch
    # counters; the wrappers' ranges open at a capture only
    name = "demod_batch_packed_planar_jit"
    _per_call_ok("modes_rx --int8 --profile", cli["trace"],
                 {"detect_chunk_kernel": n1, "merge_unordered_kernel": n1,
                  "slice_windows_kernel": n2},
                 {f"graph {name}": cli["replays"],
                  f"graph capture {name}": cli["captures"]})
    if cli["replays"] <= 0:
        raise AssertionError("profile: modes_rx --int8 --profile replayed "
                             "no graph")
    every = {sym: C2_REPS for sym in B1_B2_SYMBOLS}
    for key in ("bare", "bare+op", "step"):
        _per_call_ok(f"{key}, {C2_REPS} calls", r[key], every,
                     {"B1 detect_cands": C2_REPS,
                      "B2 slice_windows": C2_REPS})
    _per_call_ok(f"graphed step, {C2_REPS} replays", r["graphed"], every,
                 {f"graph {name}": C2_REPS, "B1 detect_cands": 0,
                  "B2 slice_windows": 0})
    if r["graphed"]["lost"] or r["graphed"]["captured"]:
        raise AssertionError("profile: graphed step: launches without a "
                             "device event")
    lost = [w for w in r["windows"] if w["lost"] or w["B1"] != 1]
    print(f"profile: {len(r['windows'])} one-step sessions: {len(lost)} "
          f"lost a kernel's device event, "
          f"{sum(1 for w in r['windows'] if w['primer_lost'])} their "
          f"primer's; the card's clock mapped up to "
          f"{max(w['lead_us'] for w in r['windows']):.1f} us early "
          f"(each session opens {SETTLE_S * 1e3:.0f} ms before its work)",
          flush=True)
    if lost:
        raise AssertionError(f"profile: sessions lost device events "
                             f"(fault C2): {lost[:3]}")
    k, full = r["big"]["k"], r["big"]["full"]
    _per_call_ok("C = 64 x 2^22, B1", k["trace"],
                 {"detect_chunk_kernel": C2_REPS,
                  "merge_unordered_kernel": C2_REPS},
                 {"B1 detect_cands": C2_REPS})
    _per_call_ok("C = 64 x 2^22, the step", full["trace"], every,
                 {"B1 detect_cands": C2_REPS, "B2 slice_windows": C2_REPS})
    b1_ms = (k["trace"]["kernel_us"]["detect_chunk_kernel"]
             + k["trace"]["kernel_us"]["merge_unordered_kernel"]) \
        / C2_REPS / 1e3
    print(f"profile: C = 64 x 2^22: B1 in the trace {b1_ms:.5f} ms per "
          f"call, card time behind a spin {k['card_ms']:.5f} ms "
          f"({100 * (b1_ms / k['card_ms'] - 1):+.2f}%); the step's trace "
          f"busy {full['trace']['busy_us'] / C2_REPS / 1e3:.5f} ms per "
          f"call ({full['trace']['device_events'] / C2_REPS:.0f} device "
          f"events), card time {full['card_ms']:.5f} ms [{smi}]",
          flush=True)
    if abs(b1_ms / k["card_ms"] - 1) > 0.05:
        raise AssertionError("profile: B1's trace time is not within 5% of "
                             "its card time")
    print(f"profile: phase 17 took {time.perf_counter() - t0:.1f} s",
          flush=True)


# --- phase 18: the entry points no other phase calls -------------------------

SNR_DB = range(4, 15)        # golden.snr_sweep points, dB
SNR_MSGS = 200               # DF17 messages per point
SCALING_MESHES = [(1, 1), (1, 2), (1, 4), (1, 8), (2, 4)]
GUI_BLOCK = 1 << 20


def _sweep_point(snr, cfg, device):
    """golden.snr_sweep at one point (the sweep seeds each point by its
    SNR, so a point alone is the same as within a sweep), and the set of
    message hexes its tables decoded."""
    from unittest import mock
    from airmodes_torch.dsp import host
    from airmodes_torch.testing import golden
    got = set()
    real = host.table_to_messages

    def record(*a, **k):
        msgs = real(*a, **k)
        got.update(m.split()[1] for m in msgs)
        return msgs
    with mock.patch.object(host, "table_to_messages", record):
        (point,) = golden.snr_sweep([float(snr)], n_msgs=SNR_MSGS, seed=0,
                                    cfg=cfg, device=device)
    return point, got


def _gui_rows(argv):
    """(exit code, the aircraft rows without their last-seen column) of one
    headless `modes_gui.main` run: curses refuses, as it does where there
    is no terminal, and the app prints its plain summary."""
    import contextlib
    import curses
    import io
    import re
    from unittest import mock
    from airmodes_torch.apps import modes_gui
    out = io.StringIO()
    with mock.patch.object(curses, "wrapper",
                           side_effect=curses.error("no terminal")), \
            contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = modes_gui.main(list(argv) + ["--backend", "curses"])
    rows = [ln.rsplit(" ", 1)[0] for ln in out.getvalue().splitlines()
            if re.match(r"^[0-9a-f]{6} ", ln)]
    return rc, rows


def phase_entry_points(dev, tmp, smi):
    """Phase 18: the entry points that default to the card and that no
    other phase calls, each against the port's own CPU run (which the CPU
    tests hold against the JAX package): `golden.snr_sweep` at
    DspConfig() over SNR_DB (decoded sets equal at every point);
    `multihost.scaling_report` over SCALING_MESHES after one (2, 4) f32
    step equal to the CPU's; `python -m airmodes_torch.dist.multihost
    --device cuda` (exit 0, the card's name); `modes_gui` headless on the
    synthetic source and a 4 Msps capture with -r 4e6 (the CPU run's
    aircraft rows), and its Qt backend where Qt imports."""
    import subprocess
    import numpy as np
    import torch
    from airmodes_torch.apps import modes_gui
    from airmodes_torch.config import DspConfig
    from airmodes_torch.dist.multihost import PodPipeline, scaling_report
    from airmodes_torch.testing import encoder
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))

    cfg = DspConfig()
    for snr in SNR_DB:
        (pt, card), (pt_cpu, cpu) = (_sweep_point(snr, cfg, d)
                                     for d in (dev, "cpu"))
        if card != cpu or pt.decoded != pt_cpu.decoded:
            raise AssertionError(f"snr_sweep at {snr} dB: the card decoded "
                                 f"{pt.decoded}, the CPU {pt_cpu.decoded}; "
                                 f"sets differ by {sorted(card ^ cpu)[:5]}")
        print(f"snr_sweep: {snr:4.1f} dB {pt.decoded:4d}/{pt.injected} "
              f"{'#' * round(40 * pt.rate):40s} (== the CPU's set) [{smi}]",
              flush=True)

    n_ch, n_t = SCALING_MESHES[-1]
    pipes = [PodPipeline(cfg, n_channel=n_ch, n_time=n_t, planar=False,
                         device=d) for d in (dev, "cpu")]
    total = pipes[0].samples_per_step
    iq, _ = encoder.make_capture(encoder.random_df17_frames(16, seed=0),
                                 snr_db=18.0, spacing=total // 20, seed=0,
                                 total_samples=total)
    step = np.stack([np.stack([iq.real, iq.imag], -1)] * n_ch
                    ).astype(np.float32)
    card, cpu = (p.run_step(step, 0) for p in pipes)
    if card != cpu or not card:
        raise AssertionError(f"scaling: the ({n_ch}, {n_t}) step on the "
                             f"card ({len(card)} messages) != the CPU's "
                             f"({len(cpu)})")
    print(f"scaling: the ({n_ch}, {n_t}) f32 step's {len(card)} messages "
          f"== the CPU's", flush=True)
    del pipes, step
    for row in scaling_report(cfg, SCALING_MESHES, device=dev):
        print(f"scaling: {json.dumps(row)} [{smi}]", flush=True)

    out = subprocess.run([sys.executable, "-m",
                          "airmodes_torch.dist.multihost", "--device",
                          "cuda"], cwd=here, capture_output=True, text=True,
                         timeout=600)
    lines = out.stdout.splitlines()
    name = json.loads(lines[0]).get("name") if lines else None
    if out.returncode != 0 or name != torch.cuda.get_device_name(0):
        raise AssertionError(f"python -m airmodes_torch.dist.multihost "
                             f"--device cuda: exit {out.returncode}, "
                             f"{out.stdout[-500:]} {out.stderr[-2000:]}")
    for ln in lines:
        print(f"multihost cli: {ln}", flush=True)

    frames = encoder.random_df17_frames(6, seed=92)
    iq, _ = encoder.make_capture(frames, rate=4e6, snr_db=25.0,
                                 spacing=16000, seed=92)
    path = os.path.join(tmp, "gui4m.c64")
    iq.astype(np.complex64).tofile(path)
    setups = {
        "synthetic": ["--duration", "60", "--block-size", str(GUI_BLOCK),
                      "--max-blocks", "2"],
        "4 Msps capture, -r 4e6": ["-s", path, "-r", "4e6", "--duration",
                                   "60", "--block-size", str(GUI_BLOCK)]}
    for what, argv in setups.items():
        (rc, rows), (rc_cpu, rows_cpu) = (
            _gui_rows(argv + ["--device", str(d)]) for d in (dev, "cpu"))
        if rc != 0 or rc_cpu != 0 or rows != rows_cpu or not rows:
            raise AssertionError(f"modes_gui, {what}: exit {rc} (CPU "
                                 f"{rc_cpu}), {len(rows)} rows != the "
                                 f"CPU's {len(rows_cpu)}")
        print(f"gui: {what}: exit 0, {len(rows)} aircraft rows == the CPU "
              f"run's", flush=True)
        for row in rows[:5]:
            print(f"gui:   {row}", flush=True)
    if modes_gui._qt_modules() is None:
        print("gui: the Qt backend was not run: neither PyQt5 nor PySide6 "
              "imports on this machine", flush=True)
    else:
        proc = subprocess.Popen(
            [sys.executable, "-m", "airmodes_torch.apps.modes_gui",
             *setups["4 Msps capture, -r 4e6"], "--backend", "qt",
             "--device", "cuda"], cwd=here,
            env=dict(os.environ, QT_QPA_PLATFORM="offscreen"),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        try:
            _, err = proc.communicate(timeout=20)
            if proc.returncode != 0:
                raise AssertionError(f"modes_gui --backend qt: exit "
                                     f"{proc.returncode}: {err[-2000:]}")
            print("gui: the Qt backend (offscreen) exited 0", flush=True)
        except subprocess.TimeoutExpired:
            print("gui: the Qt backend (offscreen) ran 20 s without an "
                  "error", flush=True)
        finally:
            proc.kill()
            proc.communicate()
    print(f"entry points: phase 18 took {time.perf_counter() - t0:.1f} s",
          flush=True)


BENCH_C = 4                  # phase 19: blocks of the bench capture
BENCH_REPS = 2               # copies of it per device call
BENCH_E2E_BLOCKS = 8
BENCH_MC = (2, 4)            # multi-channel: channels, blocks each
BENCH_SPS5_CHANNELS = 2
BENCH_FUSED_CHANNELS = 4
BENCH_POD = (1 << 22, 6)     # PodPipeline step samples, steps


def phase_bench(dev, smi):
    """Phase 19: the bench's functions (`airmodes_torch.bench`) on the
    card at reduced sizes, each decoding figure beside the same call on
    the CPU: the step's table and decode accounting over build_capture's
    BENCH_C blocks of 2^22; the device loop (sum and whole table), the
    streaming loop and the h2d control; sps 5; the fused resample step;
    PodPipeline; the native framer, modes_rx end to end and its
    multi-channel aggregate over uc8 captures. Every figure must pass its
    check; the launch counts are set to 0 just before each call and read
    just after: every figure that runs the planar step must launch B1 and
    B2 on the card (its own count agreeing), the others and every CPU call
    none; and each pair must decode the same. On
    the CPU the fused step and PodPipeline take the f32 path (the bench
    runs planar on a card only), whose rare spurious frames differ from
    the planar path's: there the injected frames decoded must be equal."""
    from airmodes_torch import bench as B
    from airmodes_torch.config import DspConfig
    from airmodes_torch.kernels import preamble as K
    t0 = time.perf_counter()

    def counted(run):
        """run() with the launch counts set to 0 just before it; returns
        its figure and the B1, B2 launches read just after."""
        K.reset_launches()
        out = run()
        return out, {"B1": K.LAUNCHES["detect_cands"],
                     "B2": K.LAUNCHES["slice_windows"]}

    def show(name, card_run, cpu_run=None, injected_only=False):
        fig, n = counted(card_run)
        if not fig.ok:
            raise AssertionError(f"bench {name}: its check failed")
        if fig.launches != (n if fig.launches else {}) or \
                (fig.launches and min(n.values()) <= 0) or \
                (not fig.launches and any(n.values())):
            raise AssertionError(f"bench {name}: B1/B2 launches {n} on the "
                                 f"card, the figure's {fig.launches}")
        lo, mid, hi = fig.spread
        line = (f"bench: {name}: {fig.value:.1f} (runs {lo:.1f} .. {mid:.1f}"
                f" .. {hi:.1f})")
        if fig.launches:
            line += f", B1 {n['B1']} launches, B2 {n['B2']}"
        if cpu_run is not None:
            cpu, n_cpu = counted(cpu_run)
            if not cpu.ok or any(n_cpu.values()):
                raise AssertionError(f"bench {name} on the CPU: ok "
                                     f"{cpu.ok}, launches {n_cpu}")
            card_got, cpu_got = fig.decoded, cpu.decoded
            if injected_only:
                card_got, cpu_got = card_got & fig.injected, \
                    cpu_got & cpu.injected
                line += (f", spurious {sorted(fig.decoded - fig.injected)} "
                         f"(the CPU's f32 path "
                         f"{sorted(cpu.decoded - cpu.injected)})")
            if card_got != cpu_got or fig.injected != cpu.injected:
                raise AssertionError(
                    f"bench {name}: the card decoded {_count(card_got)}/"
                    f"{_count(fig.injected)}, the CPU {_count(cpu_got)}/"
                    f"{_count(cpu.injected)}")
            line += (f", decoded {_count(card_got)}/{_count(fig.injected)} "
                     f"== the CPU's")
        print(f"{line} [{smi}]", flush=True)

    cfg = DspConfig(block_size=B.BLOCK, max_detections=B.MAX_DETECTIONS)
    xi, xq, truth = B.build_capture(cfg, BENCH_C)
    (name, step, arr), warm = counted(lambda: B.pick_step(cfg, xi, xq,
                                                          device=dev))
    _, _, arr_cpu = B.pick_step(cfg, xi, xq, device="cpu")
    acc, acc_cpu = (B.account(a, truth, cfg) for a in (arr, arr_cpu))
    keys = ("got", "decoded_by_df", "spurious_by_status", "df17_missed")
    if name != "cuda-planar-i8" or min(warm.values()) <= 0 or \
            any(acc[k] != acc_cpu[k] for k in keys) or not acc["df_ok"] \
            or acc["df17_missed"] > max(1, acc["df17_injected"] // 1000):
        raise AssertionError(
            f"bench step {name}: launches {warm}; card {acc['decoded_by_df']}"
            f" {acc['spurious_by_status']}, CPU {acc_cpu['decoded_by_df']} "
            f"{acc_cpu['spurious_by_status']}")
    print(f"bench: the step ({name}, {BENCH_C} blocks of {cfg.block_size}): "
          f"B1 {warm['B1']} launches, B2 {warm['B2']}; decoded "
          f"{acc['decoded_by_df']}, spurious {acc['spurious_by_status']} == "
          f"the CPU's", flush=True)

    show("device Msps", lambda: B.bench_device(
        step, cfg, xi, xq, arr, BENCH_REPS, n_runs=2, iters=3, device=dev))
    show("device Msps, whole table back", lambda: B.bench_device(
        step, cfg, xi, xq, arr, BENCH_REPS, n_runs=2, iters=3,
        sync_sum=False, device=dev))
    show("streaming Msps (host int8 -> card)", lambda: B.bench_streaming(
        step, cfg, xi, xq, arr, iters=2, n_runs=2, device=dev))
    show("h2d control Msps", lambda: B.h2d_control(
        xi, xq, cfg.block_size, device=dev))
    show("sps5 Msps",
         lambda: B.bench_sps5(n_runs=2, channels=BENCH_SPS5_CHANNELS,
                              reps=2, iters=2, device=dev),
         lambda: B.bench_sps5(n_runs=1, channels=BENCH_SPS5_CHANNELS,
                              reps=1, iters=1, device="cpu"))
    show("fused resample+demod Msps",
         lambda: B.bench_sharded_resample(channels=BENCH_FUSED_CHANNELS,
                                          R=2, iters=2, n_runs=2,
                                          device=dev),
         lambda: B.bench_sharded_resample(channels=1, R=1, iters=1,
                                          n_runs=1, device="cpu"),
         injected_only=True)
    pod_cfg = DspConfig(block_size=BENCH_POD[0], max_detections=1024)
    show("podpipeline Msps",
         lambda: B.bench_podpipeline(pod_cfg, n_steps=BENCH_POD[1],
                                     device=dev),
         lambda: B.bench_podpipeline(pod_cfg, n_steps=BENCH_POD[1],
                                     device="cpu"),
         injected_only=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench.uc8")
        icaos = B.write_uc8_capture(cfg, path, BENCH_E2E_BLOCKS)
        show("host-only framer Msps", lambda: B.bench_host_only(
            cfg, path, BENCH_E2E_BLOCKS, n_runs=2))
        show("e2e modes_rx Msps",
             lambda: B.bench_e2e(cfg, path, icaos,
                                 n_blocks=BENCH_E2E_BLOCKS, n_runs=2,
                                 device=dev),
             lambda: B.bench_e2e(cfg, path, icaos,
                                 n_blocks=BENCH_E2E_BLOCKS, n_runs=1,
                                 device="cpu"))
    n_ch, n_blk = BENCH_MC
    show("e2e multichannel Msps",
         lambda: B.bench_e2e_multichannel(cfg, n_channels=n_ch,
                                          n_blocks=n_blk, n_runs=2,
                                          device=dev),
         lambda: B.bench_e2e_multichannel(cfg, n_channels=n_ch,
                                          n_blocks=n_blk, n_runs=1,
                                          device="cpu"))
    print(f"bench: phase 19 took {time.perf_counter() - t0:.1f} s",
          flush=True)


# --- phase 20: the compiled steps as captured CUDA graphs -------------------

def _leaves(tree):
    """The tensors of a step's output: a tensor or a tuple of them."""
    return list(tree) if isinstance(tree, tuple) else [tree]


def graph_nodes(fn, *args, **kw):
    """The nodes of graphed function fn's graph for these arguments,
    captured afresh with `utils.graphs.DEBUG` set: ({hand-kernel symbol:
    kernel nodes}, {node type: nodes}), read from the graph's debug dump
    (`cudaGraphDebugDotPrint`, one record per node, its type first and a
    kernel's function name, mangled, in it)."""
    import re
    from airmodes_torch.utils import graphs
    fn.cache_clear()
    graphs.DEBUG = True
    try:
        graph = fn.graph_for(*args, **kw)
    finally:
        graphs.DEBUG = False
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            text = f.read()
    fn.cache_clear()
    heads = [m.start() for m in re.finditer(r'^"graph_\d+_node_\d+"\[',
                                            text, re.M)]
    if not heads:
        raise AssertionError(f"graph nodes: no node in the dump: "
                             f"{text[:600]!r}")
    symbols = dict.fromkeys(KERNEL_SYMBOLS, 0)
    types = {}
    for a, b in zip(heads, heads[1:] + [len(text)]):
        node = text[a:b]
        kind = next((k for k in ("KERNEL", "MEMCPY", "MEMSET", "EMPTY",
                                 "HOST", "EVENT", "MEM_ALLOC", "MEM_FREE")
                     if k in node), "OTHER")
        types[kind] = types.get(kind, 0) + 1
        if kind == "KERNEL":
            for sym in KERNEL_SYMBOLS:
                # the mangled name (its length, then the name) or the
                # demangled one; not a torch kernel that holds the name
                symbols[sym] += bool(re.search(
                    rf"(?:{len(sym)}{sym}[IE]|(?:^|[\s:]){sym}(?!\w))",
                    node))
    return symbols, types


def _graph_case(what, fn, eager, args0, args1, kw, dev, smi, cpu_check,
                nodes, counted):
    """Phase 20's checks of one compiled step `fn` (a graphed entry point)
    against its eager function `eager`, on two host inputs (positional
    arguments args0, args1; keywords kw):

    - captured afresh, the two calls (the second a replay on new inputs,
      queued behind the first) equal the eager step on the card, every
      output bit for bit; their outputs differ (the inputs do) and do not
      alias; the first output is unchanged by the second replay;
    - each replay adds the launches of one eager call: the first call
      (a warm-up run and a replay) counts twice what the second adds, and
      every counter in `counted` moves;
    - cpu_check(graphed outputs, the eager step's on the CPU) holds;
    - the graph's kernel nodes: each symbol of `nodes` at least once, no
      other hand kernel;
    - the step as the host sees it and on the card alone (time_ms, events
      with and without the spin), eager against graphed, both with their
      inputs on the card (the graph's in its own buffers).

    Returns {"eager_ms", "graph_ms", "eager_card_ms", "graph_card_ms",
    "per_replay"} and the graph's resident arguments."""
    import numpy as np
    import torch
    from airmodes_torch.kernels import preamble as K

    def counts():
        return {**K.LAUNCHES, **{f"route {k}": v for d in (
            K.DETECT_CANDS_ROUTES, K.DETECT_MASK_ROUTES) for k, v in d.items()}}

    fn.cache_clear()
    K.reset_launches()
    g0 = fn(*args0, **kw, device=dev)
    first = counts()
    g1 = fn(*args1, **kw, device=dev)
    second = counts()
    per_replay = {k: second[k] - first[k] for k in second
                  if second[k] != first[k]}
    if any(first[k] != 2 * second[k] - 2 * first[k] for k in first) \
            or any(per_replay.get(k, 0) <= 0 for k in counted):
        raise AssertionError(f"graphs: {what}: launches after the first "
                             f"call {first}, per replay {per_replay}")
    e0 = eager(*args0, **kw, device=dev)
    e1 = eager(*args1, **kw, device=dev)
    for g, e, k in ((g0, e0, 0), (g1, e1, 1)):
        for a, b in zip(_leaves(g), _leaves(e)):
            if not torch.equal(a, b):
                raise AssertionError(f"graphs: {what}: input {k}, the "
                                     f"graphed step != the eager step")
    if all(torch.equal(a, b) for a, b in zip(_leaves(e0), _leaves(e1))):
        raise AssertionError(f"graphs: {what}: the two inputs give one "
                             f"output")
    if any(a.data_ptr() == b.data_ptr()
           for a, b in zip(_leaves(g0), _leaves(g1))):
        raise AssertionError(f"graphs: {what}: two outputs alias")
    note = cpu_check([t.cpu() for t in _leaves(g0)],
                     _leaves(eager(*args0, **kw, device="cpu")))
    sym, types = graph_nodes(fn, *args0, **kw, device=dev)
    hand = {k: v for k, v in sym.items() if v}
    if set(hand) != set(nodes):
        raise AssertionError(f"graphs: {what}: hand-kernel nodes {hand}, "
                             f"wanted {nodes}")

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev) \
            if isinstance(a, np.ndarray) else \
            a.to(dev) if isinstance(a, torch.Tensor) else a
    dargs = tuple(on_card(a) for a in args0)
    held = iter(fn.static_inputs(*args0, **kw, device=dev))
    gargs = tuple(next(held) if isinstance(a, (np.ndarray, torch.Tensor))
                  else a for a in args0)
    t = {"eager_ms": time_ms(lambda: eager(*dargs, **kw, device=dev),
                             device_only=False),
         "graph_ms": time_ms(lambda: fn(*gargs, **kw, device=dev),
                             device_only=False),
         "eager_card_ms": time_ms(lambda: eager(*dargs, **kw, device=dev)),
         "graph_card_ms": time_ms(lambda: fn(*gargs, **kw, device=dev)),
         "per_replay": per_replay}
    print(f"graphs: {what}: two calls == the eager step bit for bit, "
          f"outputs distinct; {note}; launches per replay {per_replay}; "
          f"kernel nodes {hand} of {types} nodes; step as the host sees "
          f"it: eager {t['eager_ms']:.4f} ms, graphed {t['graph_ms']:.4f} "
          f"ms; card alone: eager {t['eager_card_ms']:.4f} ms, graphed "
          f"{t['graph_card_ms']:.4f} ms [{smi}]", flush=True)
    return t, gargs


def _packed_vs_cpu(rtol):
    """A cpu_check of packed tables: every int32 column equal, noise within
    rtol (_check_batch); notes whether noise is equal bit for bit too."""
    def check(card, cpu):
        import numpy as np
        a, b = card[0].numpy(), cpu[0].numpy()
        _check_batch(a, b, "graphs", rtol)
        n = int((a[..., :-1, 4] != b[..., :-1, 4]).sum())
        return (f"== CPU (int32 columns exact; noise within rtol "
                f"{rtol:g}, {n} values not bit for bit)")
    return check


def _local_eager(fn, meshes):
    """The eager function of a sharded local step (`fn.fn`, fn a graphed
    `dist.sharded._*_local`), called on the mesh of the call's device
    (meshes: {"cuda": card mesh, "cpu": CPU mesh}), its tensors moved
    there."""
    import torch

    def eager(*args, device, **kw):
        mesh = meshes[torch.device(device).type]
        args = [a.to(mesh.device) if isinstance(a, torch.Tensor) else a
                for a in args]
        return fn.fn(*args, **dict(kw, mesh=mesh), device=mesh.device)
    return eager


def _table_vs_cpu(rtol):
    """A cpu_check of sharded (C, T) DetectionTables: packed, then
    _packed_vs_cpu."""
    def check(card, cpu):
        from airmodes_torch.dsp.pipeline import DetectionTable, pack_table
        return _packed_vs_cpu(rtol)([pack_table(DetectionTable(*card))],
                                    [pack_table(DetectionTable(*cpu))])
    return check


def _messages_vs_cpu(cfg, full_scale, what):
    """A cpu_check of sharded resample tables: phase 13's contract, the
    same messages field by field, ref_dbfs within 0.1 dB."""
    def check(card, cpu):
        from airmodes_torch.dsp.pipeline import DetectionTable
        worst = _same_messages(
            _table_messages(DetectionTable(*card), cfg, full_scale),
            _table_messages(DetectionTable(*cpu), cfg, full_scale), what)
        return (f"== CPU (messages field by field, ref_dbfs within "
                f"{worst:.2f} dB)")
    return check


def _close_vs_cpu(what):
    """A cpu_check of resampler output (f32 or complex64): within 1e-5 of
    the CPU's largest magnitude, sample by sample (cuBLAS and the CPU sum
    each output's products in other orders)."""
    def check(card, cpu):
        import numpy as np
        a, b = card[0].numpy(), cpu[0].numpy()
        err = float(np.abs(a - b).max())
        peak = float(np.abs(b).max())
        if a.shape != b.shape or a.dtype != b.dtype or err > 1e-5 * peak:
            raise AssertionError(f"graphs: {what}: card vs CPU "
                                 f"{a.shape} {a.dtype} / {b.shape} "
                                 f"{b.dtype}, max |diff| {err:.3g} of a "
                                 f"peak {peak:.3g}")
        return (f"== CPU within {err / peak:.2e} of the peak ({a.dtype}, "
                f"{a.shape})")
    return check


def phase_graphs_dist(cfg, dev, tmp, smi):
    """Phase 20's compiled steps of `dist/` and the resampler: each
    sharded factory's local step on phase 15's (2, 4) mesh (the
    resample steps at 10 -> 2 Msps from phase 13's capture), the one-rank
    NCCL mesh's planar step, `PodPipeline.step3_fn` planar and f32,
    `_streaming_kernel` and `resample` on complex input, each through
    _graph_case; every factory's step (and step3_fn, and `resample`)
    equal to its graph's eager step; the (1, 1) f32 step on one block 20
    times (fault C3). Returns the per-case timings."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from airmodes_torch.dist import sharded
    from airmodes_torch.dist.multihost import PodPipeline
    from airmodes_torch.dsp import host
    from airmodes_torch.dsp.pipeline import iq_to_device_layout
    from airmodes_torch.kernels import preamble as K
    from airmodes_torch.resample import polyphase as PP
    from airmodes_torch.resample.polyphase import rational_rate
    from airmodes_torch.utils import graphs

    out = {}
    b1_b2 = {"detect_chunk_kernel", "merge_unordered_kernel",
             "slice_windows_kernel"}
    counted = ("detect_cands", "slice_windows")
    n_ch, n_t = SHARDED_MESH
    mesh = sharded.make_mesh(n_ch, n_t, device=dev)
    meshes = {"cuda": mesh, "cpu": sharded.make_mesh(n_ch, n_t,
                                                     device="cpu")}
    tile = K.default_tile(cfg)
    left, right = cfg.left_halo, cfg.right_halo
    S = n_t * cfg.block_size
    x, _ = sharded_capture(cfg, 3, n_t, 0, 51)
    steps = [np.ascontiguousarray(x[:, k * S: (k + 1) * S]) for k in range(3)]
    f32 = [iq_to_device_layout(st) for st in steps]
    q8 = [(host.quantize_i8_np(st.real, 120.0),
           host.quantize_i8_np(st.imag, 120.0)) for st in steps]

    def ctx(k):
        """Step k's stream context: zeros before the stream."""
        lc = x[:, k * S - left: k * S] if k else np.zeros((n_ch, left),
                                                          np.complex64)
        return (np.ascontiguousarray(lc),
                np.ascontiguousarray(x[:, (k + 1) * S: (k + 1) * S + right]))

    def check_factory(what, fn, eager_out, *args):
        """The factory's step on host arrays: one replay, the eager
        step's tables bit for bit."""
        r0 = (sharded._f32_local.replays, sharded._planar_local.replays,
              sharded._resample_local.replays)
        got = fn(*args)
        r1 = (sharded._f32_local.replays, sharded._planar_local.replays,
              sharded._resample_local.replays)
        if sum(r1) - sum(r0) != 1 or not all(
                torch.equal(a, b) for a, b in zip(got, eager_out)):
            raise AssertionError(f"graphs: {what}: the factory's step != "
                                 f"its graph's eager step")

    # the f32 and planar steps, without and with step context
    for name, ctx_on in (("make_sharded_demod", False),
                         ("make_sharded_demod_ctx", True)):
        a = [sharded._f32_front(mesh, cfg, f32[k],
                                *(iq_to_device_layout(c) for c in ctx(k))
                                if ctx_on else ())
             for k in (0, 1)]
        kw = {"mesh": mesh, "cfg": cfg}
        eager = _local_eager(sharded._f32_local, meshes)
        out[name], _ = _graph_case(
            f"{name} (2, 4), f32 (no hand kernel)", sharded._f32_local,
            eager, a[0], a[1], kw, dev, smi, _table_vs_cpu(1e-4), set(), ())
        fn = getattr(sharded, name)(mesh, cfg)
        args = (f32[1],) + (tuple(iq_to_device_layout(c) for c in ctx(1))
                            if ctx_on else ())
        check_factory(name, fn, eager(*a[1], **kw, device=dev), *args)
    for name, ctx_on in (("make_sharded_demod_planar", False),
                         ("make_sharded_demod_planar_ctx", True)):
        def planar_ctx(k):
            (li, ri) = (host.quantize_i8_np(c.real, 120.0) for c in ctx(k))
            (lq, rq) = (host.quantize_i8_np(c.imag, 120.0) for c in ctx(k))
            return (li, lq), (ri, rq)
        a = [sharded._planar_front(mesh, cfg, *q8[k],
                                   *(planar_ctx(k) if ctx_on else ()))
             for k in (0, 1)]
        kw = {"mesh": mesh, "cfg": cfg, "tile": tile}
        eager = _local_eager(sharded._planar_local, meshes)
        out[name], _ = _graph_case(
            f"{name} (2, 4), planar", sharded._planar_local, eager, a[0],
            a[1], kw, dev, smi, _table_vs_cpu(1e-5), b1_b2, counted)
        fn = getattr(sharded, name)(mesh, cfg)
        (li, lq), (ri, rq) = planar_ctx(1)
        args = q8[1] + ((li, lq, ri, rq) if ctx_on else ())
        check_factory(name, fn, eager(*a[1], **kw, device=dev), *args)

    # the fused resample steps at 10 -> 2 Msps: channel c of input k holds
    # phase 13's raw blocks 8k + 4c .. 8k + 4c + 3
    p, q = rational_rate(RESAMPLED_RATE, cfg.channel_rate)
    rb = cfg.block_size * q // p
    raw = np.fromfile(os.path.join(tmp, "resampled.c64"), np.complex64,
                      16 * rb).reshape(2, n_ch, n_t * rb)
    gain = np.asarray(120.0 / float(np.abs(raw).max()), np.float32)
    for planar in (False, True):
        name = f"make_sharded_resample_demod ({'planar' if planar else 'f32'})"
        arrs = ([np.stack([r.real, r.imag], axis=1).astype(np.float32)
                 for r in raw] if planar else
                [iq_to_device_layout(r) for r in raw])
        a = [(sharded._place(arr, mesh, 2 if planar else 1),
              sharded._local_gain(gain, mesh) if planar else None,
              None, None, None, None) for arr in arrs]
        kw = {"mesh": mesh, "cfg": cfg, "p": p, "q": q, "taps_per_phase": 12,
              "planar": planar, "tile": tile if planar else None}
        eager = _local_eager(sharded._resample_local, meshes)
        fs = float(gain) / 127.0 if planar else 1.0
        out[name], _ = _graph_case(
            f"{name} (2, 4), 10 -> 2 Msps", sharded._resample_local, eager,
            a[0], a[1], kw, dev, smi, _messages_vs_cpu(cfg, fs, name),
            b1_b2 if planar else set(), counted if planar else ())
        fn = sharded.make_sharded_resample_demod(mesh, cfg, p, q,
                                                 planar=planar)
        check_factory(name, fn, eager(*a[1], **kw, device=dev),
                      *((arrs[1], gain) if planar else (arrs[1],)))
    del raw, arrs, a

    # the (1, 4) planar step through a one-rank NCCL group
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        nccl = sharded.make_mesh(1, 4, group=dist.group.WORLD, device=dev)
        a = [sharded._planar_front(nccl, cfg, q8[k][0][:1], q8[k][1][:1])
             for k in (0, 1)]
        out["nccl"], _ = _graph_case(
            "make_sharded_demod_planar, one-rank NCCL mesh (1, 4)",
            sharded._planar_local, _local_eager(
                sharded._planar_local,
                {"cuda": nccl, "cpu": sharded.make_mesh(1, 4, device="cpu")}),
            a[0], a[1], {"mesh": nccl, "cfg": cfg, "tile": tile}, dev, smi,
            _table_vs_cpu(1e-5), b1_b2, counted)
    finally:
        dist.destroy_process_group()

    # PodPipeline.step3_fn: the stream context sliced from the steps
    # around, outside the graph; the packed local step inside it
    for planar in (True, False):
        mode = "planar" if planar else "f32"
        pipe = PodPipeline(cfg, n_ch, n_t, planar=planar, device=dev)
        if planar:
            dv = [sharded.shard_input_planar(*qk, pipe.mesh) for qk in q8]
            zero = tuple(torch.zeros_like(t) for t in dv[0])
            triples = [(zero, dv[0], dv[1]), (dv[0], dv[1], dv[2])]
            step3 = [(*pv, *cu, *nx) for pv, cu, nx in triples]
            a = []
            for pv, cu, nx in triples:
                (li, lq), (ri, rq) = sharded._stream_edges(
                    pipe.mesh, pv, nx, left, right)
                a.append(sharded._planar_front(pipe.mesh, cfg, *cu,
                                               (li, lq), (ri, rq)))
            fn, kw = sharded._planar_local, {"tile": tile}
        else:
            dv = [sharded.shard_input(fk, pipe.mesh) for fk in f32]
            triples = [(torch.zeros_like(dv[0]), dv[0], dv[1]),
                       (dv[0], dv[1], dv[2])]
            step3 = triples
            a = []
            for pv, cu, nx in triples:
                (lc,), (rc,) = sharded._stream_edges(pipe.mesh, (pv,), (nx,),
                                                     left, right)
                a.append(sharded._f32_front(pipe.mesh, cfg, cu, lc, rc))
            fn, kw = sharded._f32_local, {}
        kw.update(mesh=pipe.mesh, cfg=cfg, pack=True)
        eager = _local_eager(fn, {"cuda": pipe.mesh, "cpu": meshes["cpu"]})
        out[f"step3_fn {mode}"], _ = _graph_case(
            f"PodPipeline.step3_fn, {mode}", fn, eager, a[0], a[1], kw, dev,
            smi, _packed_vs_cpu(1e-5 if planar else 1e-4),
            b1_b2 if planar else set(), counted if planar else ())
        r0 = fn.replays
        got = pipe.step3_fn(*step3[1])
        if fn.replays != r0 + 1 or not torch.equal(
                got, eager(*a[1], **kw, device=dev)):
            raise AssertionError(f"graphs: PodPipeline.step3_fn ({mode}) "
                                 f"!= its graph's eager step")
    del dv, a, step3, triples

    # fault C3 on the sharded path: the (1, 1) f32 step scans one row
    one = sharded.make_sharded_demod(sharded.make_mesh(1, 1, device=dev),
                                     cfg)
    blk = np.ascontiguousarray(f32[0][:1, :cfg.block_size])
    runs = [one(blk) for _ in range(20)]
    with graphs.disable():
        eager1 = one(blk)
    same = sum(all(torch.equal(a, b) for a, b in zip(runs[0], r))
               for r in runs)
    print(f"graphs: the (1, 1) f32 sharded step on one block, 20 replays: "
          f"{same} of 20 equal to the first; == the eager step: "
          f"{all(torch.equal(a, b) for a, b in zip(runs[0], eager1))} "
          f"[{smi}]", flush=True)
    if same != 20 or not all(torch.equal(a, b)
                             for a, b in zip(runs[0], eager1)):
        raise AssertionError("graphs: the (1, 1) f32 sharded step is not "
                             "deterministic (fault C3)")
    del runs, x, steps, f32, q8

    # the streaming resampler's stride and resample on complex input
    rs = PP.streaming_resampler(p, q, device=dev)
    n = rs.hist + rs.stride
    raw = np.fromfile(os.path.join(tmp, "resampled.c64"), np.complex64,
                      2 << 22)
    blocks = [raw[k * n: (k + 1) * n].view(np.float32).reshape(n, 2)
              for k in (0, 1)]
    out["_streaming_kernel"], _ = _graph_case(
        f"streaming_resampler stride (_streaming_kernel, {rs.stride} raw "
        f"samples)", PP._streaming_kernel, PP._streaming_kernel.fn,
        (blocks[0],), (blocks[1],),
        {"p": p, "q": q, "t": rs.t, "S": rs.s_groups}, dev, smi,
        _close_vs_cpu("_streaming_kernel"), set(), ())
    xs = [np.ascontiguousarray(raw[k << 22: (k + 1) << 22]) for k in (0, 1)]
    kw = {"p": p, "q": q, "taps_per_phase": 12, "complex_in": True}
    out["resample"], _ = _graph_case(
        "resample, complex64 input of 2^22 samples", PP._resample_step,
        PP._resample_step.fn, (xs[0],), (xs[1],), kw, dev, smi,
        _close_vs_cpu("resample"), set(), ())
    got = PP.resample(xs[1], p, q, device=dev)
    if got.dtype != torch.complex64 or not torch.equal(
            got, PP._resample_step.fn(xs[1], **kw, device=dev)):
        raise AssertionError("graphs: resample (complex) != its eager step")
    return out


def phase_graphs(cfg, dev, tmp, smi):
    """Phase 20: every compiled step (the `*_jit` entry points, captured
    CUDA graphs) held on the card against its eager function and the
    CPU (_graph_case): the planar step on phase 6's capture at its
    defaults and with ordered, prescreen and xla_gather; B3 and B4 on
    phase 7's capture; the 1-D steps at sps 2 and 10; the fused resample
    step on phase 13's capture; the full-block steps. Then the int8 and
    f32 steps' profiles, graphed (the card's busy share and device ops
    per replay). Returns the per-case timings."""
    import numpy as np
    import torch
    from airmodes_torch.config import DspConfig
    from airmodes_torch.dsp import pipeline as P
    from airmodes_torch.dsp.host import table_to_messages
    from airmodes_torch.io import stream as S
    from airmodes_torch.kernels import preamble as K
    from airmodes_torch.resample import fused as RF
    from airmodes_torch.resample.polyphase import rational_rate
    t0 = time.perf_counter()
    out = {}
    # fault C3: one row through torch.cumsum (CUB's device-wide scan) and
    # through the noise floor's row scan, 20 runs each on one input
    row = torch.randn(1 << 20, device=dev,
                      generator=torch.Generator(dev).manual_seed(0))
    same = {}
    for name, scan in (("torch.cumsum", lambda: torch.cumsum(row, 0)),
                       ("_row_cumsum", lambda: P._row_cumsum(row))):
        runs = [scan() for _ in range(20)]
        same[name] = sum(torch.equal(runs[0], r) for r in runs)
    print(f"graphs: a row of 2^20 f32 scanned 20 times: torch.cumsum "
          f"{same['torch.cumsum']} of 20 runs equal to the first, the "
          f"noise floor's row scan {same['_row_cumsum']} of 20 [{smi}]",
          flush=True)
    if same["_row_cumsum"] != 20:
        raise AssertionError("graphs: the noise floor's row scan is not "
                             "deterministic (fault C3)")
    (b0, _, _), (b1, _, _) = planar_batches(
        cfg, os.path.join(tmp, "main.uc8"))[:2]
    b1_b2 = {"detect_chunk_kernel", "merge_unordered_kernel",
             "slice_windows_kernel"}
    for opt, nodes, counted in (
            ("", b1_b2, ("detect_cands", "slice_windows")),
            ("ordered", {"detect_chunk_kernel", "merge_ordered_kernel",
                         "slice_windows_kernel"},
             ("detect_cands", "slice_windows", "route B5o")),
            ("prescreen", b1_b2, ("detect_cands", "slice_windows",
                                  "route B5p")),
            ("xla_gather", {"detect_chunk_kernel",
                            "merge_unordered_kernel"}, ("detect_cands",))):
        kw = {opt: True} if opt else {}
        what = f"planar {opt or 'defaults'}"
        out[what], held = _graph_case(
            what, K.demod_batch_packed_planar_jit,
            K.demod_batch_packed_planar, (*b0, cfg), (*b1, cfg), kw, dev,
            smi, _packed_vs_cpu(1e-5), nodes, counted)
        if not opt:
            profile_step(lambda: K.demod_batch_packed_planar_jit(
                *held, device=dev), smi, expect=B1_B2_SYMBOLS)

    c64 = os.path.join(tmp, "main.c64")
    xb0 = np.stack([b for b, _ in _stream_blocks(cfg, c64, 0, BATCH)])
    xb1 = np.stack([b for b, _ in _stream_blocks(cfg, c64, BATCH,
                                                 2 * BATCH)])
    tile = K.supported_2d_tile(cfg)
    mask = {"detect_mask_kernel"}
    out["B3"], _ = _graph_case(
        "B3 (one block)", K.demod_block_packed_fast_jit,
        K.demod_block_packed_fast, (xb0[0], cfg), (xb1[0], cfg),
        {"tile": tile}, dev, smi, _packed_vs_cpu(1e-5), mask,
        ("detect_mask", "route B3"))
    out["B4"], held = _graph_case(
        "B4 (f32 batch)", K.demod_batch_packed_fast_jit,
        K.demod_batch_packed_fast, (xb0, cfg), (xb1, cfg), {"tile": tile},
        dev, smi, _packed_vs_cpu(1e-5), mask, ("detect_mask", "route B4"))
    profile_step(lambda: K.demod_batch_packed_fast_jit(
        *held, tile=tile, device=dev), smi, expect=("detect_mask_kernel",))
    out["full-block batch"], _ = _graph_case(
        "full-block batch (no hand kernel)", P.demod_batch_packed_jit,
        P.demod_batch_packed, (xb0[:2], cfg), (xb1[:2], cfg), {}, dev, smi,
        _packed_vs_cpu(1e-4), set(), ())
    out["full-block block"], _ = _graph_case(
        "full-block block (no hand kernel)", P.demod_block_packed_jit,
        P.demod_block_packed, (xb0[0], cfg), (xb1[0], cfg), {}, dev, smi,
        _packed_vs_cpu(1e-4), set(), ())
    del xb0, xb1

    for rate in (4e6, 20e6):
        cfg_r = DspConfig(channel_rate=rate)
        (_, f), _ = mixed_capture(cfg_r, 4, seed=9, planar=False)
        what = f"1-D at sps {cfg_r.sps}"
        out[what + " batch"], _ = _graph_case(
            what + ", batch of 2", K.demod_batch_packed_1d_jit,
            K.demod_batch_packed_1d, (f[:2], cfg_r), (f[2:], cfg_r), {},
            dev, smi, _packed_vs_cpu(1e-4), mask,
            ("detect_mask", "route B6 batch"))
        out[what + " block"], _ = _graph_case(
            what + ", one block", K.demod_block_packed_1d_jit,
            K.demod_block_packed_1d, (f[0], cfg_r), (f[1], cfg_r), {}, dev,
            smi, _packed_vs_cpu(1e-4), mask, ("detect_mask", "route B6"))
        del f

    p, q = rational_rate(RESAMPLED_RATE, cfg.channel_rate)
    geometry = RF.raw_geometry(cfg, p, q)[:3]
    (_, _, x0), (_, _, x1) = _raw_batches(
        os.path.join(tmp, "resampled.c64"), geometry, BATCH, 2 * BATCH,
        pinned=True)

    def fused_vs_cpu(card, cpu):
        np.testing.assert_allclose(card[1].numpy(), cpu[1].numpy(),
                                   rtol=1e-6, err_msg="fused AGC gains")
        worst = 0.0
        for j in range(card[0].shape[0]):
            def msgs(t, g):
                return table_to_messages(
                    P.unpack_table(t[j].numpy()), 0, cfg.channel_rate,
                    full_scale=float(g[j]) / 127.0)
            worst = max(worst, _same_messages(
                msgs(card[0], card[1]), msgs(cpu[0], cpu[1]),
                f"graphs: fused, block {j}"))
        return (f"== CPU (gains rtol 1e-6, messages field by field, "
                f"ref_dbfs within {worst:.2f} dB)")
    out["fused"], _ = _graph_case(
        "fused resample 10 -> 2 Msps", RF.resample_demod_packed_planar_jit,
        RF.resample_demod_packed_planar, (x0, None, cfg, p, q),
        (x1, None, cfg, p, q), {}, dev, smi, fused_vs_cpu, b1_b2,
        ("detect_cands", "slice_windows"))
    del x0, x1
    torch.cuda.empty_cache()
    out.update(phase_graphs_dist(cfg, dev, tmp, smi))
    torch.cuda.empty_cache()
    print(f"graphs: phase 20 took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


GRAFT_MESHES = (1, 8)        # phase 21: dryrun_multichip(1), _dryrun_steps(8)
GRAFT_FRAME_SPACING = 999    # phase 21's frames: samples apart at 2 Msps


class _HeldB1B2:
    """While entered, every call of the B1 and B2 wrappers
    (`preamble_detect_cands_planar`, `_slice_windows`) on card tensors is
    recorded: its arguments and its output, cloned where the call runs.
    In a graph's warm-up run the clones hold the eager values; in its
    capture they are nodes of the graph, and after the step they hold
    the last replay's. Each record also carries the dry-run step it ran
    in (`graft_entry.DryrunStep` is wrapped to mark the steps' ends).
    `check()` holds each record bit for bit against the wrapper on CPU
    copies of its arguments, i.e. the kernel's plain version. Recording
    launches no counted kernel."""

    def __init__(self):
        from airmodes_torch import graft_entry as G
        from airmodes_torch.kernels import preamble as K
        self.K, self.G = K, G
        self.orig = {"B1": K.preamble_detect_cands_planar,
                     "B2": K._slice_windows}
        self.calls, self.ends = [], []

    def _wrap(self, kernel):
        import torch
        fn = self.orig[kernel]

        def call(*args, **kw):
            out = fn(*args, **kw)
            if out.device.type == "cuda":
                self.calls.append((kernel, tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args), kw, out.clone()))
            return out
        return call

    def __enter__(self):
        real = self.step_type = self.G.DryrunStep

        def step(name, *rest):
            self.ends.append((name, len(self.calls)))
            return real(name, *rest)
        self.K.preamble_detect_cands_planar = self._wrap("B1")
        self.K._slice_windows = self._wrap("B2")
        self.G.DryrunStep = step
        return self

    def __exit__(self, *exc):
        self.K.preamble_detect_cands_planar = self.orig["B1"]
        self.K._slice_windows = self.orig["B2"]
        self.G.DryrunStep = self.step_type
        return False

    def check(self, what, steps=None):
        """Every record == the plain version on its inputs. Returns
        {step: {"B1": [calls, candidates], "B2": [calls, non-empty
        windows]}}, by the dry run's step names (`steps`: one name for
        calls made outside a dry run)."""
        import torch
        torch.cuda.synchronize()
        ends = self.ends or [(steps, len(self.calls))]
        held, lo = {}, 0
        for name, hi in ends:
            held[name] = {"B1": [0, 0], "B2": [0, 0]}
            for kernel, args, kw, out in self.calls[lo:hi]:
                host = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                             for a in args)
                want, got = self.orig[kernel](*host, **kw), out.cpu()
                if got.shape != want.shape or not torch.equal(got, want):
                    raise AssertionError(f"{what} {name}: {kernel} on the "
                                         f"card != its plain version on "
                                         f"the same inputs")
                n = (int(got[..., self.K._COUNT_ROW, :].sum())
                     if kernel == "B1" else int((host[2] >= 0).sum()))
                held[name][kernel][0] += 1
                held[name][kernel][1] += n
            lo = hi
        if lo != len(self.calls):
            raise AssertionError(f"{what}: calls after the last step")
        return held


def _graft_frames(n, dev):
    """The dry run's four planar steps (the planar step, with stream
    context, the fused resample step planar, PodPipeline(planar=True)'s
    two steps) at its mesh and config, on blocks holding DF17 frames (its
    own inputs are noise: every table empty), with B1 and B2 held against
    their plain versions on every call: the card's tables == the CPU's
    (int32 exact, noise rtol 1e-5; the resample step's messages field by
    field), every frame decoded, B1's candidate blocks not empty. Returns
    the number of frames."""
    import numpy as np
    import torch
    from airmodes_torch import graft_entry as G
    from airmodes_torch.config import DspConfig
    from airmodes_torch.dist import multihost, sharded
    from airmodes_torch.dsp.host import quantize_i8_np
    from airmodes_torch.dsp.pipeline import DetectionTable, pack_table
    from airmodes_torch.testing import encoder
    n_channel, n_time = G._mesh_shape(n)
    what = f"graft entry: frames on the {(n_channel, n_time)} mesh"
    pcfg = DspConfig(block_size=4096, max_detections=16)
    q = 3

    def capture(total, up, seed, phase=0):
        """DF17 frames every GRAFT_FRAME_SPACING samples at the channel
        rate times `up`, from 603 (+ phase raw samples), peak 0.9:
        (complex64, the frames' hexes)."""
        spacing, start = GRAFT_FRAME_SPACING * up, 603 * up + phase
        iq, truth = encoder.make_capture(
            encoder.random_df17_frames((total - start) // spacing,
                                       seed=seed),
            rate=pcfg.channel_rate * up, snr_db=20.0, spacing=spacing,
            start=start, seed=seed, total_samples=total)
        iq = (iq / np.max(np.abs(iq)) * 0.9).astype(np.complex64)
        return iq, {t.hex for t in truth}

    def tile(x):
        return np.ascontiguousarray(np.broadcast_to(x, (n_channel,) + x.shape))

    total = n_time * pcfg.block_size
    iq, want = capture(total, 1, 21)
    gain = 120.0
    xi, xq = (tile(quantize_i8_np(v, gain)) for v in (iq.real, iq.imag))
    zl = np.zeros((n_channel, pcfg.left_halo), np.int8)
    zr = np.zeros((n_channel, pcfg.right_halo), np.int8)
    # at 6 Msps the sub-chip phase (the frame's start mod 3) decides
    # whether a frame decodes after the resample to 2 samples per chip:
    # phase 2 decodes all 32 frames of the (1, 8) capture at 20 dB, 0
    # and 1 miss 7 and 5 of them, on the card and on the CPU alike
    raw, want_raw = capture(total * q, q, 22, phase=2)
    iqrp = tile(np.stack([raw.real, raw.imag]).astype(np.float32))
    Sp = multihost.PodPipeline(pcfg, n_channel=n_channel, n_time=n_time,
                               planar=True, device="cpu").samples_per_step
    ips, want_pod = capture(2 * Sp, 1, 23)

    def steps(device):
        mesh = sharded.make_mesh(n_channel, n_time, None, device)
        fnp = sharded.make_sharded_demod_planar(mesh, pcfg)
        fnc = sharded.make_sharded_demod_planar_ctx(mesh, pcfg)
        fnr = sharded.make_sharded_resample_demod(mesh, pcfg, 1, q,
                                                  planar=True)
        pipe = multihost.PodPipeline(pcfg, n_channel=n_channel,
                                     n_time=n_time, planar=True,
                                     device=device)
        planar = sharded.shard_input_planar(xi, xq, mesh)
        return {
            "make_sharded_demod_planar": lambda: fnp(*planar),
            "make_sharded_demod_planar_ctx": lambda: fnc(
                *planar, zl, zl, zr, zr),
            "make_sharded_resample_demod(planar=True)": lambda: fnr(
                sharded.shard_input_resample_planar(iqrp, mesh),
                np.float32(100.0)),
            "PodPipeline(planar=True).run_stream": lambda: list(
                pipe.run_stream(iter([tile(ips[:Sp]), tile(ips[Sp:])])))}

    sharded._planar_local.cache_clear()
    sharded._resample_local.cache_clear()
    on_cpu = {k: f() for k, f in steps("cpu").items()}
    for name, fn in steps(dev).items():
        with _HeldB1B2() as rec:
            card = fn()
        cpu = on_cpu[name]
        held = rec.check(what, name)[name]
        if isinstance(card, DetectionTable):
            table = DetectionTable(*(f.cpu() for f in card))
            if "resample" in name:
                msgs = _table_messages(table, pcfg, 100.0 / 127.0)
                _same_messages(msgs, _table_messages(cpu, pcfg,
                                                     100.0 / 127.0), name)
                truth = want_raw
            else:
                _check_batch(pack_table(table).numpy(),
                             pack_table(cpu).numpy(), f"{what} {name}", 1e-5)
                msgs = _table_messages(table, pcfg, 1.0)
                truth = want
        else:
            if card != cpu:
                raise AssertionError(f"{what} {name}: messages != the "
                                     f"CPU's")
            msgs, truth = [m for out in card for m in out], want_pod
        got = {m.split()[1] for m in msgs}
        if not truth <= got or not held["B1"][1] or not held["B2"][1]:
            raise AssertionError(f"{what} {name}: decoded {len(got & truth)}"
                                 f" of {len(truth)} frames; B1/B2 held "
                                 f"{held}")
        print(f"{what}: {name}: {len(msgs)} messages, every one of "
              f"{len(truth)} frames decoded, == the CPU's; B1 held on "
              f"{held['B1'][0]} calls ({held['B1'][1]} candidates), B2 on "
              f"{held['B2'][0]} ({held['B2'][1]} windows), each == its "
              f"plain version bit for bit", flush=True)
    return len(want) + len(want_raw) + len(want_pod)


def _graft_steps_vs_cpu(card, cpu, what):
    """The dry run's steps on the card against the CPU's, under the parity
    contract: the same steps on the same inputs; each table's int32
    columns exact and noise within rtol 1e-5 (planar) or 1e-4 (full
    block), except the fused resample steps' (phase 13's contract:
    messages field by field); run_stream's messages string for string.
    Returns the planar steps' names."""
    import numpy as np
    from airmodes_torch.dsp.pipeline import DetectionTable, pack_table
    import torch
    if [s.name for s in card] != [s.name for s in cpu]:
        raise AssertionError(f"{what}: steps {[s.name for s in card]} != "
                             f"the CPU's {[s.name for s in cpu]}")
    def tensors(table):
        return DetectionTable(*(torch.from_numpy(f) for f in table))

    planar = []
    for a, b in zip(card, cpu):
        name = f"{what} {a.name}"
        for x, y in zip(a.inputs, b.inputs):
            if not np.array_equal(x, y):
                raise AssertionError(f"{name}: inputs differ from the CPU's")
        if "planar" in a.name:
            planar.append(a.name)
        if not isinstance(a.outputs, DetectionTable):
            if a.outputs != b.outputs or len(a.outputs) != 2:
                raise AssertionError(f"{name}: messages != the CPU's")
            note = (f"{sum(map(len, a.outputs))} messages over 2 steps == "
                    f"the CPU's")
        elif "resample" in a.name:
            scale = 100.0 / 127.0 if "planar" in a.name else 1.0
            worst = _same_messages(
                _table_messages(tensors(a.outputs), a.cfg, scale),
                _table_messages(tensors(b.outputs), b.cfg, scale), name)
            n = int((a.outputs.index != b.outputs.index).sum())
            note = (f"table {a.outputs.index.shape}, "
                    f"{int((a.outputs.index >= 0).sum())} detections, "
                    f"messages == CPU field "
                    f"by field (ref_dbfs within {worst:.2f} dB; {n} "
                    f"detection indices differ)")
        else:
            pa, pb = (pack_table(tensors(t)).numpy()
                      for t in (a.outputs, b.outputs))
            rtol = 1e-5 if "planar" in a.name else 1e-4
            _check_batch(pa, pb, name, rtol)
            n = int((a.outputs.noise != b.outputs.noise).sum())
            note = (f"table {a.outputs.index.shape}, "
                    f"{int((a.outputs.index >= 0).sum())} detections, == "
                    f"CPU (int32 exact, "
                    f"noise within rtol {rtol:g}, {n} values not bit for "
                    f"bit)")
        print(f"graft entry: {name}: {note}; launches "
              f"B1 {a.launches['B1']}, B2 {a.launches['slice_windows']}",
              flush=True)
    return planar


def phase_graft_entry(dev, smi):
    """Phase 21: the graft entry points (`airmodes_torch.graft_entry`,
    the counterpart of `__graft_entry__.py`) on the card: entry()'s
    compiled step twice (equal bit for bit, and equal to the CPU's under
    the parity contract), then on a block of DF17 frames (== the CPU's,
    every frame decoded: the example block is noise and detects nothing),
    its time graphed and eager, as the host sees it and on the card
    alone, its graph's nodes and its profile; dryrun_multichip(1) and
    _dryrun_steps(8), the (1, 8) mesh on this one card, every step
    against the port's CPU run, B1 and B2 launched by every planar step
    and the counts read around each run, every call of B1's and B2's
    wrappers held against its plain version on the call's own inputs
    (`_HeldB1B2`); the planar steps again at each mesh on DF17 frames
    (`_graft_frames`: the dry run's inputs are noise); then `python -m
    airmodes_torch.graft_entry` (exit 0, the card's name in its output).
    Returns the B1 and B2 launches of the (1, 8) run."""
    import subprocess
    import numpy as np
    import torch
    from airmodes_torch import graft_entry as G
    from airmodes_torch.dist import sharded as S
    from airmodes_torch.dsp.host import table_to_messages
    from airmodes_torch.dsp import pipeline as P
    from airmodes_torch.dsp.pipeline import DetectionTable, pack_table
    from airmodes_torch.kernels import preamble as K
    from airmodes_torch.testing import encoder
    from airmodes_torch.utils import graphs
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))

    fn, args = G.entry(dev)
    one, two = (G._host_table(fn(*args)) for _ in range(2))
    cfn, cargs = G.entry("cpu")
    if not np.array_equal(args[0], cargs[0]):
        raise AssertionError("graft entry: entry()'s block differs by device")
    cpu = G._host_table(cfn(*cargs))
    for f, a, b in zip(one._fields, one, two):
        if not np.array_equal(a, b):
            raise AssertionError(f"graft entry: entry()'s two runs differ "
                                 f"in {f}")
    for f, a, b in zip(one._fields, one, cpu):
        if f == "noise":
            np.testing.assert_allclose(a, b, rtol=1e-4,
                                       err_msg="graft entry: entry noise")
        elif not np.array_equal(a, b):
            raise AssertionError(f"graft entry: entry()'s {f} != the CPU's")
    print(f"graft entry: entry()'s step twice, equal bit for bit, == the "
          f"CPU's (int32 exact, noise rtol 1e-4; "
          f"{int((one.noise != cpu.noise).sum())} noise values not bit for "
          f"bit); {int((one.index >= 0).sum())} detections", flush=True)
    # the example block is noise and detects nothing: the same step on a
    # block of its shape holding DF17 frames, card against CPU
    cfg = fn.keywords["cfg"]
    iq, truth = encoder.make_capture(encoder.random_df17_frames(6, seed=16),
                                     snr_db=20.0, spacing=4000,
                                     start=cfg.left_halo + 500, seed=16,
                                     total_samples=args[0].shape[0])
    block = np.stack([iq.real, iq.imag], -1).astype(np.float32)
    card, cpu = G._host_table(fn(block)), G._host_table(cfn(block))
    pc, pp = (pack_table(DetectionTable(*(torch.from_numpy(f) for f in t)))
              .numpy() for t in (card, cpu))
    _check_batch(pc, pp, "graft entry: entry() on frames", 1e-4)
    got = {m.split()[1] for m in table_to_messages(card, 0,
                                                   cfg.channel_rate)}
    if not {t.hex for t in truth} <= got:
        raise AssertionError(f"graft entry: entry() on frames decoded "
                             f"{len(got)} of {len(truth)}")
    print(f"graft entry: entry()'s step on a block of 6 DF17 frames == the "
          f"CPU's, {int(card.n_detected)} detections, every frame decoded",
          flush=True)
    card_ms = time_ms(lambda: fn(*args))
    host_ms = time_ms(lambda: fn(*args), device_only=False)
    with graphs.disable():
        eager_card = time_ms(lambda: fn(*args))
        eager_host = time_ms(lambda: fn(*args), device_only=False)
    print(f"graft entry: entry()'s step (demod_block_jit, block 2^15) "
          f"graphed {host_ms:.5f} ms as the host sees it, {card_ms:.5f} ms "
          f"on the card alone; eager {eager_host:.5f}, {eager_card:.5f} ms "
          f"[{smi}]", flush=True)
    _, types = graph_nodes(P.demod_block_jit, *args, **fn.keywords)
    print(f"graft entry: entry()'s graph holds {types}", flush=True)
    profile_step(lambda: fn(*args), smi)

    launches = {}
    for n in GRAFT_MESHES:
        t1 = time.perf_counter()
        # fresh captures, so that every planar step calls B1's and B2's
        # wrappers (a cached graph replays without them)
        S._planar_local.cache_clear()
        S._resample_local.cache_clear()
        K.reset_launches()
        with _HeldB1B2() as rec:
            if n == 1:
                card = G.dryrun_multichip(n, dev)
            else:
                card = G._dryrun_steps(n, dev)
        counts = dict(K.LAUNCHES, **K.DETECT_CANDS_ROUTES)
        what = f"dryrun {G._mesh_shape(n)}"
        planar = _graft_steps_vs_cpu(card, G._dryrun_steps(n, "cpu"), what)
        if len(planar) != 4:
            raise AssertionError(f"{what}: planar steps {planar}")
        held = rec.check(what)
        for s in card:
            want = "planar" in s.name
            got = s.launches["B1"] > 0 and s.launches["slice_windows"] > 0
            h = held[s.name]
            if got != want or (h["B1"][0] > 0 and h["B2"][0] > 0) != want:
                raise AssertionError(f"{what} {s.name}: launches "
                                     f"{s.launches}, wrapper calls held "
                                     f"{h}")
            if want:
                print(f"graft entry: {what} {s.name}: B1 held on "
                      f"{h['B1'][0]} calls ({h['B1'][1]} candidates), B2 "
                      f"on {h['B2'][0]} ({h['B2'][1]} windows), each == "
                      f"its plain version on the call's own inputs, bit "
                      f"for bit", flush=True)
        if counts["B1"] != sum(s.launches["B1"] for s in card) or \
                counts["slice_windows"] != sum(s.launches["slice_windows"]
                                               for s in card):
            raise AssertionError(f"{what}: counts {counts} != the steps' "
                                 f"sum")
        launches = {"B1": counts["B1"],
                    "slice_windows": counts["slice_windows"]}
        print(f"graft entry: {what}: B1 launched {counts['B1']} times and "
              f"B2 {counts['slice_windows']} times over {len(card)} steps, "
              f"every planar step both ({time.perf_counter() - t1:.1f} s)",
              flush=True)
        # the dry run's inputs are noise: its planar steps again, on frames
        t1 = time.perf_counter()
        n_frames = _graft_frames(n, dev)
        print(f"graft entry: {what}: the planar steps on {n_frames} DF17 "
              f"frames ({time.perf_counter() - t1:.1f} s)", flush=True)

    out = subprocess.run([sys.executable, "-m", "airmodes_torch.graft_entry"],
                         cwd=here, capture_output=True, text=True,
                         timeout=600)
    name = torch.cuda.get_device_name(0)
    if out.returncode != 0 or name not in out.stdout:
        raise AssertionError(f"python -m airmodes_torch.graft_entry: exit "
                             f"{out.returncode}, {out.stdout[-1000:]} "
                             f"{out.stderr[-2000:]}")
    for ln in out.stdout.splitlines():
        print(f"graft entry cli: {ln}", flush=True)
    torch.cuda.empty_cache()
    print(f"graft entry: phase 21 took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches


def _count(x):
    """The size of a figure's set of hexes (or ICAOs), or its count."""
    return len(x) if isinstance(x, (set, frozenset)) else x


def _table_messages(table, cfg, full_scale):
    """Messages of a sharded (C, T) table (indices global in the step),
    sorted by time."""
    from airmodes_torch.dsp import host
    from airmodes_torch.dsp.pipeline import DetectionTable
    arr = [f.cpu().numpy() for f in table]
    msgs = []
    for c in range(arr[0].shape[0]):
        for t in range(arr[0].shape[1]):
            msgs += host.table_to_messages(
                DetectionTable(*(a[c, t] for a in arr)), 0,
                cfg.channel_rate, full_scale=full_scale)
    return sorted(msgs, key=lambda m: (float(m.split()[5]), m))


# --- phase 22: the native framer alone --------------------------------------

FRAMER_BLOCKS = 32


def _write_memfd(name, data):
    """An in-memory file holding `data`, as a path the C pump can open."""
    fd = os.memfd_create(name)
    view = memoryview(data).cast("B")
    while view:
        view = view[os.write(fd, view):]
    return fd, f"/proc/self/fd/{fd}"


def phase_framer(smi, n_blocks=FRAMER_BLOCKS, cases=None):
    """The native framer alone, on the host: for each (wire format,
    config) of `cases` (default: sc16 at the 20 Msps geometry, uc8 at
    `DspConfig()`), a capture of n_blocks + 1 blocks whose level changes
    every block, written to an in-memory file, pumped into a ring that
    holds all of it (the pump's time), then n_blocks blocks framed with
    the AGC (each call timed; no block waits on the source). Every row,
    start and gain must equal `quantize_planar_i8_np` over the same frame
    of the capture as the pump converts it. Returns {format: (pump ms,
    framing ms) a block}."""
    import numpy as np
    from airmodes_torch.config import DspConfig
    from airmodes_torch.dsp.host import quantize_planar_i8_np
    from airmodes_torch.native import IQStream
    if cases is None:
        cases = (("sc16", DspConfig(channel_rate=20e6)), ("uc8", DspConfig()))
    rng = np.random.default_rng(22)
    out = {}
    for fmt, cfg in cases:
        left, N, right = cfg.left_halo, cfg.block_size, cfg.right_halo
        n = (n_blocks + 1) * N
        level = np.repeat(rng.uniform(0.05, 1.0, n_blocks + 1), 2 * N)
        if fmt == "sc16":
            words = np.round(rng.uniform(-1, 1, 2 * n) * level * 32767
                             ).astype(np.int16)
            x = words.astype(np.float32) * np.float32(1 / 32768)
        else:
            words = np.round(127.5 + rng.uniform(-1, 1, 2 * n) * level
                             * 127.5).astype(np.uint8)
            x = ((words.astype(np.float32) - np.float32(127.5))
                 * np.float32(1 / 127.5))
        iq = np.concatenate([np.zeros(2 * left, np.float32), x]
                            ).view(np.complex64)
        fd, path = _write_memfd(f"framer.{fmt}", words)
        st = IQStream(cfg, ring_samples=n + left + N + right)
        rows = np.zeros((n_blocks, 2, st.total), np.int8)
        got, frame_s = [], []
        try:
            t0 = time.perf_counter()
            st.start_file(path, fmt=fmt)
            while st.available < n:
                if time.perf_counter() - t0 > 60:
                    raise AssertionError(f"framer {fmt}: the pump put "
                                         f"{st.available} of {n} samples "
                                         f"in the ring in 60 s")
                time.sleep(0.0002)
            pump_s = time.perf_counter() - t0
            for k in range(n_blocks):
                t0 = time.perf_counter()
                got.append(st.next_block_planar_agc(rows[k, 0], rows[k, 1]))
                frame_s.append(time.perf_counter() - t0)
        finally:
            st.close()
            os.close(fd)
        for k, (start, gain) in enumerate(got):
            seg = iq[k * N: k * N + st.total]
            a = np.abs(seg.view(np.float32))
            peak = np.float32(np.max(a, initial=0, where=a <= 3.4e38)) or 1
            want_gain = np.float32(120.0) / np.float32(peak)
            wi, wq = quantize_planar_i8_np(seg, want_gain)
            if (start != k * N or gain != want_gain
                    or not np.array_equal(rows[k, 0], wi)
                    or not np.array_equal(rows[k, 1], wq)):
                raise AssertionError(
                    f"framer {fmt}: block {k} (start {start}, gain {gain}) "
                    f"!= quantize_planar_i8_np's (gain {want_gain}; "
                    f"{int((rows[k, 0] != wi).sum())} I and "
                    f"{int((rows[k, 1] != wq).sum())} Q bytes differ)")
        pump_ms = pump_s * 1e3 / (n_blocks + 1)
        ms = np.array(frame_s) * 1e3
        out[fmt] = (pump_ms, float(ms.mean()))
        print(f"framer alone, {fmt} at {cfg.channel_rate / 1e6:g} Msps, "
              f"{n_blocks} blocks of {N} (+{left}/{right} halo): pump "
              f"{pump_ms:.3f} ms a block into the ring; AGC framing "
              f"{ms.mean():.3f} ms a block (median {np.median(ms):.3f}, "
              f"min {ms.min():.3f}, max {ms.max():.3f}); every row, start "
              f"and gain == quantize_planar_i8_np [{smi}]", flush=True)
    return out


# --- phase 23: a block's table turned into wire lines -----------------------

DECODE_ROWS = 16             # the tables of one replay 16ch step
DECODE_REPS = 25
DECODE_BUSY = (0, 1, 3)      # threads running Python beside the timed pass


def _busy_python(n):
    """n threads that run Python bytecode until the returned event is set,
    as the framing pool's glue and the sink do beside the consumer."""
    import threading
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            sum(range(200))
    for _ in range(n):
        threading.Thread(target=spin, daemon=True).start()
    return stop


def _gil_held_vs_released(wire, tables, args, rate, smi):
    """The native pass per block called holding the GIL (`ctypes.PyDLL`,
    as `native.load` binds it) and letting go of it (`ctypes.CDLL`, the
    same function), in turns, beside DECODE_BUSY threads of Python: the
    median and the mean of DECODE_REPS calls a table."""
    import ctypes
    import types
    import numpy as np
    from airmodes_torch import native
    held = native.load().wire_lines
    released = ctypes.CDLL(native._LIB).wire_lines
    released.restype, released.argtypes = held.restype, held.argtypes
    wire_rel = native.WireLines(wire.k)
    wire_rel._lib = types.SimpleNamespace(wire_lines=released)
    for j in range(len(tables)):
        start, fs = args[j]
        if wire_rel(tables[j], start, rate, 0.0, fs) != wire(
                tables[j], start, rate, 0.0, fs):
            raise AssertionError(f"decode alone: table {j}: released != "
                                 f"held")
    for n in DECODE_BUSY:
        stop = _busy_python(n)
        times = {wire: [], wire_rel: []}
        try:
            for _ in range(DECODE_REPS):
                for j in range(len(tables)):
                    start, fs = args[j]
                    for w in (wire, wire_rel) if j % 2 else (wire_rel, wire):
                        t0 = time.perf_counter()
                        w(tables[j], start, rate, 0.0, fs)
                        times[w].append(time.perf_counter() - t0)
        finally:
            stop.set()
        h, r = (np.array(times[w]) * 1e3 for w in (wire, wire_rel))
        print(f"decode alone: beside {n} busy Python thread(s), the native "
              f"pass holding the GIL {np.median(h):.4f} ms a block (mean "
              f"{h.mean():.4f}), letting go of it {np.median(r):.4f} ms "
              f"(mean {r.mean():.4f}); {len(h)} calls each, in turns "
              f"[{smi}]", flush=True)


def _replay_tables(cfg, n, rng):
    """n packed (K+1, 9) tables at replay 16ch's shape: 52 frames (DF17
    long ones, DF11 short ones) and 20 CRC failures in the first slots of
    cfg.max_detections, at indices across the block and levels from -40 to
    0 dBFS of the row's full scale, the rest empty as the card leaves
    them."""
    import numpy as np
    k = cfg.max_detections
    rows = np.zeros((n, k + 1, 9), np.int32)
    rows[:, :, 0] = -1
    rows[:, :, 1] = 0xFF
    for r in rows:
        m = 72
        long = rng.random(m) < 0.6
        status = np.where(np.arange(m) < 20, 4, rng.choice(
            [0, 0, 0, 0, 1, 2, 3], m))
        r[:m, 0] = rng.integers(0, cfg.block_size, m)
        r[:m, 1] = (np.where(long, 17, 11) + (np.where(long, 112, 56) << 8)
                    + (status << 16))
        r[:m, 2] = rng.integers(0, 1 << 24, m)
        r[:m, 3] = (10.0 ** rng.uniform(-4, 0, m)).astype(np.float32).view(
            np.int32)
        r[:m, 5:9] = rng.integers(0, 1 << 28, (m, 4))
        r[k, :2] = (m + 30, 0)
    return rows


def phase_decode(dev, tmp, smi):
    """A block's table turned into wire lines on the host, per block: the
    Python rule against the native pass on 16 tables at replay 16ch's
    shape, each side timed DECODE_REPS times a table in turns (the median
    of the per-table times); lines and counts equal; then the pass holding
    the GIL against letting go of it (`_gil_held_vs_released`). Then
    `run_native_channels` on the card over two uc8 captures of two blocks:
    the native count (`io/stream.WIRE_ROWS`) must rise by every row
    decoded, the Python rule's not at all. Returns (rule ms, native ms) a
    block."""
    import numpy as np
    from airmodes_torch import native
    from airmodes_torch.config import DspConfig
    from airmodes_torch.dsp import host
    from airmodes_torch.dsp.pipeline import unpack_table
    from airmodes_torch.io import stream
    from airmodes_torch.io.native_stream import run_native_channels
    cfg = DspConfig()
    rng = np.random.default_rng(23)
    tables = _replay_tables(cfg, DECODE_ROWS, rng)
    gains = rng.uniform(50, 400, DECODE_ROWS).astype(np.float32)
    args = [((1 << 32) + j * cfg.block_size, float(gains[j]) / 127.0)
            for j in range(DECODE_ROWS)]
    wire = native.WireLines(cfg.max_detections)

    def rule(j, stats):
        start, fs = args[j]
        return host.table_to_messages(unpack_table(tables[j]), start,
                                      cfg.channel_rate, full_scale=fs,
                                      stats=stats)

    def native_pass(j, stats):
        start, fs = args[j]
        msgs = wire(tables[j], start, cfg.channel_rate, 0.0, fs)
        for name, c in zip(native.WIRE_COUNTS, wire.counts.tolist()):
            setattr(stats, name, getattr(stats, name) + c)
        return msgs

    n_lines = 0
    for j in range(DECODE_ROWS):
        want_stats, got_stats = host.BlockStats(), host.BlockStats()
        want, got = rule(j, want_stats), native_pass(j, got_stats)
        if got != want or got_stats != want_stats:
            raise AssertionError(f"decode alone: table {j}: the native "
                                 f"pass != the Python rule")
        n_lines += len(got)
    times = {rule: [], native_pass: []}
    for _ in range(DECODE_REPS):
        for j in range(DECODE_ROWS):
            for f in (rule, native_pass) if j % 2 else (native_pass, rule):
                t0 = time.perf_counter()
                f(j, host.BlockStats())
                times[f].append(time.perf_counter() - t0)
    rule_ms = float(np.median(times[rule])) * 1e3
    native_ms = float(np.median(times[native_pass])) * 1e3
    print(f"decode alone: {DECODE_ROWS} tables of {cfg.max_detections} "
          f"slots, {n_lines / DECODE_ROWS:.1f} lines a table: Python rule "
          f"{rule_ms:.4f} ms a block, native pass {native_ms:.4f} ms "
          f"({rule_ms / native_ms:.1f}x; medians of {DECODE_REPS} a table, "
          f"in turns); lines and BlockStats equal [{smi}]", flush=True)
    _gil_held_vs_released(wire, tables, args, cfg.channel_rate, smi)

    paths = []
    for c in range(2):
        paths.append(os.path.join(tmp, f"decode{c}.uc8"))
        write_capture(cfg, paths[-1], 2, seed=40 + c)
    before = dict(stream.WIRE_ROWS)
    steps = list(run_native_channels(paths, cfg, fmt="uc8", device=dev))
    used = {k: stream.WIRE_ROWS[k] - before[k] for k in before}
    rows = sum(m is not None for st in steps for m in st)
    if used != {"native": rows, "python": 0} or rows != 4:
        raise AssertionError(f"decode alone: run_native_channels decoded "
                             f"{rows} rows; wire lines by path {used}")
    print(f"decode alone: run_native_channels over 2 channels of 2 blocks: "
          f"wire lines by path {used} (io/stream.WIRE_ROWS)", flush=True)
    return rule_ms, native_ms


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from airmodes_torch.config import DspConfig
    from airmodes_torch.kernels import _ext
    from airmodes_torch.kernels import preamble as K
    from airmodes_torch.kernels.opcount import (
        B2_OPS_PER_WINDOW_SAMPLE, PEAK_F32_INSTR_S, b1_ops_parent,
        b1_ops_per_sample, b34_ops_per_sample, b5p_ops_per_sample,
        b6_ops_per_sample, bound)
    from airmodes_torch.probes import flush_buffer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = smi_line()
    print(f"card: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}",
          flush=True)
    build_s = _ext.build_all()
    print(f"kernels built in {build_s:.2f} s", flush=True)
    for name in _ext.SIGNATURES:
        for line in _ext.build_log(name).splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                print(f"ptxas {name}: {line.strip()}", flush=True)
    flush = flush_buffer(dev)

    cfg = DspConfig()
    t0 = time.perf_counter()
    ((mi, mq), mf), _ = mixed_capture(cfg, BATCH, seed=0)
    ((di, dq), df), _ = mixed_capture(cfg, BATCH, snr_db=15.0, seed=2,
                                      spacing=1500)
    zeros = np.zeros_like(mi)
    cfg2 = DspConfig(channel_rate=4e6)
    ((si, sq), sf), _ = mixed_capture(cfg2, BATCH, seed=4)
    cfg10 = DspConfig(channel_rate=20e6)
    (_, tf), _ = mixed_capture(cfg10, BATCH, seed=6)
    print(f"captures built in {time.perf_counter() - t0:.2f} s", flush=True)
    planar_in = {"mixed": (mi, mq), "dense": (di, dq),
                 "silence": (zeros, zeros)}
    b1_out, b1_err, b1_t = phase_b1(cfg, planar_in, dev, flush)
    if b1_out["dense"][4] <= 0:
        raise AssertionError("dense input did not overflow K")
    b1_out2, err2, _ = phase_b1(cfg2, {"mixed": (si, sq)}, dev, flush)
    b1_err = max(b1_err, err2)
    b5, b5_out = {}, {}
    for variant in ("B5o", "B5p"):
        out, err, timing = phase_b1(cfg, planar_in, dev, flush, variant)
        out2, err2, _ = phase_b1(cfg2, {"mixed": (si, sq)}, dev, flush,
                                 variant)
        b5[variant] = (max(err, err2), timing)
        b5_out[variant] = (out, out2)
    # the ordered layout past 8 hits per lane column: frames every 2048
    # samples start on one lane column, which spills past per_lane = 12
    (spill, _), _ = mixed_capture(cfg, BATCH, snr_db=12.0, seed=5,
                                  spacing=2048)
    b5o12_out, err, _ = phase_b1(cfg, {"lane spill": spill}, dev, flush,
                                 "B5o per_lane 12")
    b5["B5o"] = (max(b5["B5o"][0], err), b5["B5o"][1])
    most = int(K.detect_cands_plain(
        *b5o12_out["lane spill"][:2], cfg, K.default_tile(cfg), ordered=True,
        per_lane=12)[:, :, 4].max())
    print(f"B5o per_lane 12: the fullest lane column holds {most} hits of "
          f"a tile", flush=True)
    if most <= 12:
        raise AssertionError("the spill input did not spill past 12 hits")

    b2_err, b2_t = phase_b2(cfg, {k: b1_out[k] for k in ("mixed", "dense")},
                            flush)
    b2_err = max(b2_err, phase_b2(cfg2, b1_out2, flush)[0])
    # the launch floor: what a kernel with next to no work takes in this
    # harness, beside the microsecond-scale kernels (B2, B3, B6 at C = 1)
    one = torch.zeros(1, device=dev)
    floor_ms = time_ms(lambda: one.add_(1.0), flush=flush)
    print(f"launch floor: a one-element in-place add {floor_ms:.5f} ms "
          f"(L2 left warm: {time_ms(lambda: one.add_(1.0)):.5f} ms) "
          f"[{smi}]", flush=True)
    b34_in = {"mixed": mf, "dense": df, "silence": np.zeros_like(mf),
              "mixed[0]": mf[:1], "dense[0]": df[:1],
              "silence[0]": np.zeros_like(mf[:1]),
              "mixed int8": wire(mf, np.int8),
              "mixed int16": wire(mf, np.int16),
              "mixed[0] int8": wire(mf[:1], np.int8),
              "mixed[0] int16": wire(mf[:1], np.int16)}
    b34_out, b34_err, b34_t = phase_b34(cfg, b34_in, dev, flush)
    b34_out2, err2, _ = phase_b34(cfg2, {"mixed": sf}, dev, flush)
    b34_err = max(b34_err, err2)
    nan_blk = mf[:1].copy()       # a corrupt sample of each kind
    nan_blk[0, cfg.left_halo + 500_000, 0] = np.nan
    nan_blk[0, cfg.left_halo + 700_000, 1] = np.inf
    b6_in = {"mixed": mf, "dense": df, "silence": np.zeros_like(mf),
             "mixed[0]": mf[:1], "dense[0]": df[:1],
             "silence[0]": np.zeros_like(mf[:1]),
             "mixed int8": wire(mf, np.int8),
             "mixed[0] int8": wire(mf[:1], np.int8),
             "mixed[0] NaN, Inf": nan_blk}
    b6_out, b6_err, b6_t = phase_b34(cfg, b6_in, dev, flush, one_d=True)
    b6_out2, err2, _ = phase_b34(cfg2, {"mixed": sf, "mixed[0]": sf[:1]},
                                 dev, flush, one_d=True)
    b6_out10, err10, b6_t10 = phase_b34(
        cfg10, {"mixed": tf, "mixed[0]": tf[:1],
                "mixed int8": wire(tf, np.int8)}, dev, flush, one_d=True)
    b6_err = max(b6_err, err2, err10)
    # a block of 1023 x 1024 samples: any multiple of 1024, as the
    # reference's tiles; the last chunk of each channel is ragged
    cfg_big = DspConfig(block_size=1023 * 1024)
    (_, bf), _ = mixed_capture(cfg_big, BATCH, seed=8, planar=False)
    big_in = {"mixed 1023x1024": bf, "mixed[0] 1023x1024": bf[:1]}
    big_out, err, _ = phase_b34(cfg_big, big_in, dev, flush, tile=1024)
    big6_out, err6, _ = phase_b34(cfg_big, big_in, dev, flush, one_d=True,
                                  tile=1024)
    b34_err, b6_err = max(b34_err, err), max(b6_err, err6)
    del mf, df, sf, tf, bf, b34_in, b6_in, nan_blk, big_in

    phase_repeat(cfg, b1_out, dev, REPEAT)
    phase_repeat(cfg2, b1_out2, dev, REPEAT)
    for variant, (out, out2) in b5_out.items():
        phase_repeat(cfg, out, dev, REPEAT, variant)
        phase_repeat(cfg2, out2, dev, REPEAT, variant)
    phase_repeat_b34(cfg, {k: b34_out[k] for k in
                           ("mixed", "dense", "silence", "mixed[0]",
                            "dense[0]")}, dev, REPEAT)
    phase_repeat_b34(cfg, {k: b6_out[k] for k in
                           ("mixed", "dense", "silence", "mixed[0]",
                            "dense[0]", "mixed[0] NaN, Inf")}, dev, REPEAT,
                     one_d=True)
    phase_repeat_b34(cfg10, {"mixed": b6_out10["mixed"]}, dev, REPEAT,
                     one_d=True)
    phase_repeat(cfg, b5o12_out, dev, REPEAT, "B5o per_lane 12")
    phase_repeat_b34(cfg_big, big_out, dev, REPEAT)
    phase_repeat_b34(cfg_big, big6_out, dev, REPEAT, one_d=True)
    del b1_out, b1_out2, b5_out, b34_out, b34_out2, b6_out, b6_out2, b6_out10
    del b5o12_out, big_out, big6_out

    with tempfile.TemporaryDirectory() as tmp:
        launches, truth, main_msgs = phase_main(cfg, dev, tmp, smi)
        phase_reports(main_msgs, truth, tmp)
        b5_launches = phase_planar_options(
            cfg, dev, os.path.join(tmp, "main.uc8"), truth, smi)
        routes, truth = phase_main_f32(cfg, dev, tmp, smi)
        b6_launches = phase_1d(cfg, dev, os.path.join(tmp, "main.c64"),
                               truth, tmp, smi)
        phase_c1(dev, tmp, smi)
        chan_launches = phase_channels(cfg, dev, tmp, smi)
        rs_launches, rs_chan_launches, r1_t, rs_path = phase_resampled(
            cfg, dev, tmp, smi)
        phase_cli(cfg, dev, tmp, smi, os.path.join(tmp, "main.uc8"),
                  rs_path, [os.path.join(tmp, "ch0.uc8"),
                            os.path.join(tmp, "ch1.uc8")])
        sh_launches = phase_sharded(cfg, dev, tmp, smi)
        probe_rows = phase_probes(dev, smi, flush)
        phase_profile(cfg, dev, tmp, smi, os.path.join(tmp, "main.uc8"),
                      flush)
        phase_entry_points(dev, tmp, smi)
        phase_bench(dev, smi)
        phase_graphs(cfg, dev, tmp, smi)
        graft_launches = phase_graft_entry(dev, smi)
        phase_framer(smi)
        phase_decode(dev, tmp, smi)

    half = cfg.nms_chips * cfg.sps
    b1_ms, b1_plain, b1_bytes, b1_samples = b1_t
    b1_out_bytes = BATCH * (cfg.block_size // 131072) * 8 * 128 * 4
    b1_bound, b1_by = bound(b1_bytes + b1_out_bytes,
                            b1_samples * b1_ops_per_sample(cfg.sps, half))
    print(f"yardstick: B1's operation bound was "
          f"{b1_samples * b1_ops_parent(cfg.sps, half) / 67e12 * 1e3:.5f} ms "
          f"({b1_ops_parent(cfg.sps, half)} operations per sample, an FMA "
          f"as two, over 67 TFLOP/s); it is now "
          f"{b1_samples * b1_ops_per_sample(cfg.sps, half) / PEAK_F32_INSTR_S * 1e3:.5f}"
          f" ms ({b1_ops_per_sample(cfg.sps, half)} f32 instructions per "
          f"sample over {PEAK_F32_INSTR_S / 1e12:.1f} T/s)", flush=True)
    # B1's and B2's launches on each path that runs them; "launches" is
    # the int8 main path's
    by_path = {k: {"int8 main path": launches[k],
                   "run_native_channels": chan_launches[k],
                   "run_resampled_fused": rs_launches[k],
                   "run_resampled_fused_channels": rs_chan_launches[k],
                   "PodPipeline (2, 4) sharded": sh_launches[k],
                   "graft_entry dryrun (1, 8)": graft_launches[k]}
               for k in ("B1", "slice_windows")}
    kernels = [
        {"name": "detect_cands (B1)", "route": "cuda",
         "source": "airmodes_torch/kernels/csrc/detect_cands.cu",
         "replaces": "airmodes/kernels/preamble_pallas.py:1096",
         "launches": launches["B1"], "max_abs_err": b1_err,
         "ms": b1_ms, "plain_ms": b1_plain, "bound_ms": b1_bound,
         "bound_by": b1_by, "library_ms": None,
         "launches_by_path": by_path["B1"]},
    ]
    # B2 at the demod paths' width and at the reference's; both entries
    # count the kernel's launches on the int8 path, which runs the first
    for width in ("main", "reference"):
        ms, plain_ms, n_in, n_out = b2_t[width]
        bms, by = bound(2 * n_in + 4 * n_out,
                        B2_OPS_PER_WINDOW_SAMPLE * n_in)
        kernels.append(
            {"name": f"slice_windows (B2, {width} width)", "route": "cuda",
             "source": "airmodes_torch/kernels/csrc/slice_windows.cu",
             "replaces": "airmodes/kernels/preamble_pallas.py:1386",
             "launches": launches["slice_windows"], "max_abs_err": b2_err,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
             "bound_by": by, "library_ms": b2_t["library"],
             "launches_by_path": by_path["slice_windows"]})
    for C, kid, line in ((1, "B3", 303), (BATCH, "B4", 517)):
        ms, plain_ms, n_bytes, samples = b34_t[C]
        bms, by = bound(n_bytes, samples * b34_ops_per_sample(cfg.sps, half))
        kernels.append(
            {"name": f"detect_mask ({kid}, C={C})", "route": "cuda",
             "source": "airmodes_torch/kernels/csrc/detect_mask.cu",
             "replaces": f"airmodes/kernels/preamble_pallas.py:{line}",
             "launches": routes[kid], "max_abs_err": b34_err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
             "library_ms": None})
    for kid, line, ops in (("B5o", 1033, b1_ops_per_sample(cfg.sps, half)),
                           ("B5p", 636, b5p_ops_per_sample(cfg.sps))):
        err, (ms, plain_ms, n_bytes, samples) = b5[kid]
        bms, by = bound(n_bytes + b1_out_bytes, samples * ops)
        kernels.append(
            {"name": f"detect_cands ({kid})", "route": "cuda",
             "source": "airmodes_torch/kernels/csrc/detect_cands.cu",
             "replaces": f"airmodes/kernels/preamble_pallas.py:{line}",
             "launches": b5_launches[kid], "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
             "library_ms": None})
    for C, line in ((1, 57), (BATCH, 395)):
        ms, plain_ms, n_bytes, samples = b6_t[C]
        bms, by = bound(n_bytes, samples * b6_ops_per_sample(cfg.sps, half))
        kernels.append(
            {"name": f"detect_mask (B6, C={C})", "route": "cuda",
             "source": "airmodes_torch/kernels/csrc/detect_mask.cu",
             "replaces": f"airmodes/kernels/preamble_pallas.py:{line}",
             "launches": b6_launches[C], "max_abs_err": b6_err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
             "library_ms": None})
    # R1 on each wire format at the fused cell's shapes; it runs on the
    # fused paths alone, one launch a step
    for fmt, (ms, plain_ms, bms, by) in r1_t.items():
        kernels.append(
            {"name": f"raw_planar (R1, {fmt})", "route": "cuda",
             "source": "airmodes_torch/kernels/csrc/raw_planar.cu",
             "replaces": None, "launches": rs_launches["raw_planar"],
             "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bms, "bound_by": by, "library_ms": None,
             "launches_by_path": {
                 "run_resampled_fused": rs_launches["raw_planar"],
                 "run_resampled_fused_channels":
                     rs_chan_launches["raw_planar"]}})
    kernels += probe_rows
    ms, plain_ms, n_bytes, samples = b6_t10[BATCH]
    half10 = cfg10.nms_chips * cfg10.sps
    bms, by = bound(n_bytes, samples * b6_ops_per_sample(cfg10.sps, half10))
    print(f"B6 at 20 Msps (sps 10), C={BATCH}: {ms:.5f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bms:.5f} ms ({by}; "
          f"{b6_ops_per_sample(cfg10.sps, half10)} operations per sample) "
          f"[{smi}]", flush=True)
    for k in kernels:
        print(f"bound share: {k['name']}: {k['bound_ms'] / k['ms']:.3f} of "
              f"its bound ({k['bound_by']}), {k['ms'] / floor_ms:.2f}x the "
              f"launch floor [{smi}]", flush=True)
    print(f"channels: B1 launched {chan_launches['B1']} times and B2 "
          f"{chan_launches['slice_windows']} times on the run_native_channels "
          f"path (the int8 main path: {launches['B1']} and "
          f"{launches['slice_windows']})", flush=True)
    print(f"resampled: B1 launched {rs_launches['B1']} times and B2 "
          f"{rs_launches['slice_windows']} times on run_resampled_fused, "
          f"{rs_chan_launches['B1']} and {rs_chan_launches['slice_windows']} "
          f"on run_resampled_fused_channels", flush=True)
    print(f"sharded: B1 launched {sh_launches['B1']} times and B2 "
          f"{sh_launches['slice_windows']} times on PodPipeline.run_stream "
          f"over a {SHARDED_MESH} mesh (once per step)", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
