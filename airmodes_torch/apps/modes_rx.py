"""CLI receiver on the card: the port of `airmodes/apps/modes_rx.py`.

    python -m airmodes_torch.apps.modes_rx -s cap.c64 -r 10e6 --int8 -d out.db
    python -m airmodes_torch.apps.modes_rx --device cpu -s cap.c64 ...

Wires a source -> (optional polyphase resample) -> demod on the card ->
wire messages -> pub/sub relay -> enabled output plugins, with every option
of the reference plus `--device` (default "cuda"; "cpu" runs the kernels'
plain versions):

  -s/--source file|udp|synthetic     (uhd/osmocom raise: no SDR hardware here)
  -r/--rate, -f/--freq, -g/--gain, -T/--threshold, -l/--location
  -P (SBS-1 port), -K (KML file), -d (SQLite db), -w (raw TCP port),
  -m (FlightGear host:port), -n (no console print)

Where the port differs from the reference: the fused resample path runs
when the device is a card (the reference's, on a TPU); `--batch 0` picks 8
on a card and 1 on the CPU; `--compile-cache` is accepted and does
nothing; and every validation exit closes the plugins already registered.
`--pub` publishes on a ZeroMQ PUB socket (pyzmq, optional as in the
reference).

Clean shutdown on KeyboardInterrupt closes sockets/DB like the reference.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="modes_rx",
        description="Mode S / ADS-B receiver (PyTorch, CUDA kernels)")
    src = p.add_argument_group("source")
    src.add_argument("-s", "--source", action="append", default=None,
                     help="file path, 'udp', 'synthetic', or a remote "
                     "receiver 'beast://host:port' / 'avr://host:port' "
                     "[synthetic]. Repeat for multi-channel operation: "
                     "every -s becomes one channel of a single batched "
                     "device call per step; messages publish on 'dl_data' "
                     "(merged) and 'dl_data/ch<N>' (per channel). Network "
                     "sources skip the DSP entirely (aggregator mode) and "
                     "may not be mixed with sample sources")
    src.add_argument("-r", "--rate", type=float, default=2e6,
                     help="source sample rate [2e6]")
    src.add_argument("--file-format", default="complex64",
                     choices=["complex64", "sc16", "uc8", "beast",
                              "beastgps", "avr"],
                     help="IQ sample format, or a demodulated frame "
                     "recording ('beast' binary / 'beastgps' with "
                     "radarcape GPS counters / 'avr' ASCII, e.g. from "
                     "dump1090/readsb or this framework's -B/-w servers) "
                     "replayed through the decode stack without DSP")
    src.add_argument("-f", "--freq", type=float, default=1090e6)
    src.add_argument("-g", "--gain", type=float, default=None)
    src.add_argument("-e", "--error", type=float, default=0.0,
                     help="frequency error ppm")
    src.add_argument("--udp-port", type=int, default=10000)
    src.add_argument("--throttle", action="store_true",
                     help="replay files at real-time rate")
    src.add_argument("--start-sample", type=int, default=0,
                     help="resume a file capture from this sample counter")
    src.add_argument("--udp-timeout", type=float, default=0.0,
                     metavar="SECONDS",
                     help="end the -s udp stream after this long without "
                     "datagrams (0 = never: a live receiver must survive "
                     "upstream feeder restarts) [0]")

    dsp = p.add_argument_group("dsp")
    dsp.add_argument("-T", "--threshold", type=float, default=5.0,
                     help="preamble detection threshold dB over noise [5]")
    dsp.add_argument("--block-size", type=int, default=1 << 20)
    dsp.add_argument("--max-detections", type=int, default=128)
    dsp.add_argument("--channel-rate", type=float, default=2e6)
    dsp.add_argument("--batch", type=int, default=0, metavar="N",
                     help="blocks per device call (0 = auto: 8 on a "
                     "card, 1 on the CPU); N>1 amortizes per-dispatch "
                     "overhead")
    dsp.add_argument("--int8", action="store_true",
                     help="quantize blocks to int8 (SDR-native "
                     "precision; enables the traffic-minimal planar "
                     "kernels B1 and B2 — 4x less host->device traffic; "
                     "with -r, the fused resample path on a card)")
    dsp.add_argument("--i8-scale", type=float, default=None, metavar="GAIN",
                     help="fixed int8 quantize gain (int8 = f32 * GAIN) "
                     "replacing the default per-block AGC (gain = "
                     "120/peak) on the --int8 path; use when the "
                     "capture's full-scale use is known (e.g. 127 for a "
                     "full-scale uc8/sc16 recording — skips the peak "
                     "scan and keeps dBFS absolute)")
    dsp.add_argument("--depth", type=int, default=2,
                     help="device calls kept in flight (H2D/compute/D2H "
                     "overlap) [2]")
    dsp.add_argument("--no-native", action="store_true",
                     help="disable the native C++ streaming runtime "
                     "(file read + framing + int8/planar conversion in a "
                     "producer thread) and use the pure-Python source path")
    dsp.add_argument("--compile-cache", default="~/.cache/airmodes-xla",
                     metavar="DIR", help="accepted for compatibility and "
                     "ignored: the port has no XLA compile cache (its CUDA "
                     "kernels build once per checkout)")
    dsp.add_argument("--device", default="cuda",
                     help="torch device the demod runs on: 'cuda' (a card; "
                     "the hand kernels) or 'cpu' (their plain versions) "
                     "[cuda]")

    out = p.add_argument_group("output")
    out.add_argument("-P", "--sbs1", type=int, default=None, metavar="PORT",
                     help="serve SBS-1/BaseStation CSV on TCP port (30003)")
    out.add_argument("-K", "--kml", default=None, metavar="FILE")
    out.add_argument("-d", "--db", default=None, metavar="FILE",
                     help="SQLite database file")
    out.add_argument("-w", "--raw", type=int, default=None, metavar="PORT")
    out.add_argument("-B", "--beast", type=int, default=None, metavar="PORT",
                     help="serve Mode-S Beast binary frames on TCP port "
                     "(30005; what readsb/VRS feed clients consume)")
    out.add_argument("--beast-gps", action="store_true",
                     help="-B serves radarcape-style GPS/UTC timestamps "
                     "instead of the 12 MHz counter (mlat-grade feed for "
                     "modes_mlat beastgps://)")
    out.add_argument("-j", "--json", default=None, metavar="FILE",
                     help="write a dump1090-style aircraft.json snapshot "
                     "every second of stream time")
    out.add_argument("-m", "--flightgear", default=None, metavar="HOST:PORT")
    out.add_argument("--http", type=int, default=None, metavar="PORT",
                     help="serve a live web map + dump1090-style "
                     "/data/aircraft.json API on this port")
    out.add_argument("-n", "--no-print", action="store_true")
    out.add_argument("-l", "--location", default=None, metavar="LAT,LON[,ALT]")
    out.add_argument("--cpr-global-first", action="store_true",
                     help="require an even/odd CPR pair for an aircraft's "
                     "first position instead of local-decoding single "
                     "frames against --location (immune to the half-zone "
                     "alias of receiver-referenced local decode, at the "
                     "cost of first-fix latency)")
    out.add_argument("--stats-interval", type=float, default=10.0,
                     help="print per-interval pipeline stats (0 = off)")
    out.add_argument("--wx", default=None, metavar="FILE",
                     help="append NDJSON aircraft-derived weather "
                     "observations (EHS/MRAR wind, temperature, pressure, "
                     "hazards joined with the aircraft's last ADS-B "
                     "position; '-' for stdout)")
    out.add_argument("--declination", type=float, default=0.0, metavar="DEG",
                     help="local magnetic declination (east positive) to "
                     "de-bias the --wx wind-triangle derivation (BDS6,0 "
                     "heading is magnetic, BDS5,0 track is true)")
    out.add_argument("--stats-json", default=None, metavar="FILE",
                     help="append one NDJSON stats record per interval "
                     "(machine-readable ops feed; '-' for stdout)")
    out.add_argument("--max-blocks", type=int, default=None,
                     help="stop after N blocks (testing)")
    out.add_argument("--max-messages", type=int, default=None,
                     help="aggregator mode: stop after N messages (testing)")
    out.add_argument("--dedup-window", type=float, default=1.0,
                     help="aggregator mode: suppress the same frame from "
                     "overlapping feeds on the merged topic within this "
                     "many seconds [1.0]; per-channel topics are never "
                     "deduplicated")
    out.add_argument("--pub", default=None, metavar="ADDR",
                     help="also publish raw messages on a zmq PUB socket")
    out.add_argument("--profile", default=None, metavar="LOGDIR",
                     help="capture a torch.profiler Chrome trace of the "
                     "run into LOGDIR")
    return p


def parse_location(s: Optional[str]):
    """LAT,LON[,ALT] -> tuple; raises ValueError with a usable message on
    malformed input (a typo'd -l should be a clean CLI error at startup,
    not an IndexError traceback — same convention as network URLs)."""
    if not s:
        return None
    try:
        parts = [float(x) for x in s.split(",")]
    except ValueError:
        parts = []
    if len(parts) not in (2, 3):
        raise ValueError(f"bad -l/--location {s!r}: expected LAT,LON[,ALT] "
                         "(decimal degrees)")
    return (parts[0], parts[1], parts[2] if len(parts) > 2 else 0.0)


def _on_card(device) -> bool:
    import torch
    return torch.device(device).type == "cuda"


def _fused_resample_ok(cfg, rate_in: float, device) -> bool:
    """Whether the fused resample->quantize->planar-demod device path
    (io/stream.run_resampled_fused) runs this cfg/rate: on a card, when
    the kernels' own gates (supported_planar_tile, raw_geometry) accept
    it. On the CPU the host resample path runs, as the reference's does
    off a TPU."""
    if not _on_card(device):
        return False
    from ..kernels.preamble import supported_planar_tile
    if supported_planar_tile(cfg) is None:
        return False
    try:
        from ..resample.fused import raw_geometry
        from ..resample.polyphase import rational_rate
        raw_geometry(cfg, *rational_rate(rate_in, cfg.channel_rate))
    except ValueError:
        return False
    return True


def build_msg_iter(args, cfg, *, epoch: float, stats=None):
    """Single-channel source -> wire-message-list iterator: the one
    dispatch over the native C++ runtime, the fused resample device path
    and the pure-Python sources. Raises ValueError for unsupported
    source/option combos (callers print it as a CLI error).

    Paths, in priority order:
    - resampled + --int8 on a card: fused group-matmul resample ->
      device int8 quantize -> planar demod (kernels B1 and B2)
    - --int8 native: C++ framing + per-block AGC quantize + planar
      split in producer threads, threaded device dispatch (--i8-scale
      replaces the AGC with a fixed gain)
    - f32 native: C++ framing only, python device pipeline
    - pure Python: resample/file/udp/synthetic source + run_pipelined
    """
    import itertools
    from ..io import native_stream
    from ..io import sources as src_mod
    from ..io.stream import run_pipelined

    needs_resample = abs(args.rate - cfg.channel_rate) > 1e-3
    if args.source in ("uhd", "osmocom"):
        raise ValueError(
            f"SDR source '{args.source}' needs the UHD/osmosdr hardware "
            "libraries (unavailable); use a recorded file or udp")
    if needs_resample and args.source in ("udp", "synthetic"):
        raise ValueError("resampling is only wired for file sources")
    if args.source == "udp" and args.file_format != "complex64":
        # every UDP path (python and native pump) parses datagrams as
        # complex64 pairs; sc16/uc8 bytes would frame as garbage with
        # zero decodes and no diagnostic
        raise ValueError("-s udp takes complex64 datagrams; "
                         "--file-format sc16/uc8 applies to file sources")
    batch = args.batch
    if batch <= 0:
        batch = 8 if _on_card(args.device) else 1
    dev = args.device

    if needs_resample and args.int8 and _fused_resample_ok(cfg, args.rate,
                                                           dev):
        from ..io.stream import run_resampled_fused
        return run_resampled_fused(
            args.source, cfg, dtype=args.file_format, rate_in=args.rate,
            start_sample=args.start_sample, epoch=epoch, stats=stats,
            depth=args.depth, batch=batch, scale=args.i8_scale,
            max_blocks=args.max_blocks, device=dev)

    native_ok = (not args.no_native and not needs_resample
                 and args.source not in ("synthetic",)
                 and native_stream.native_available())
    if native_ok and args.int8:
        kw = dict(cfg=cfg, epoch=epoch, stats=stats, batch=batch,
                  depth=args.depth, max_blocks=args.max_blocks,
                  scale=args.i8_scale, device=dev)
        if args.source == "udp":
            return native_stream.run_native_pipelined(
                udp_port=args.udp_port, udp_timeout_s=args.udp_timeout,
                **kw)
        return native_stream.run_native_pipelined(
            path=args.source, fmt=args.file_format,
            start_sample=args.start_sample, **kw)

    if needs_resample:
        blocks = src_mod.resampled_file_source(
            args.source, cfg, dtype=args.file_format, rate_in=args.rate,
            start_sample=args.start_sample, device=dev)
    elif args.source == "udp":
        blocks = src_mod.udp_source(cfg, port=args.udp_port,
                                    timeout_s=args.udp_timeout)
    elif args.source == "synthetic":
        blocks = src_mod.synthetic_source(cfg,
                                          n_blocks=args.max_blocks or 4)
    elif native_ok:
        # f32 precision requested: native framing only (producer
        # thread), device layout/transfer via the pipelined runner
        from ..native import IQStream

        def native_f32_blocks():
            st = IQStream(cfg)
            st.start_file(args.source, fmt=args.file_format,
                          offset_samples=args.start_sample)
            try:
                yield from st.blocks()
            finally:
                st.close()
        blocks = native_f32_blocks()
    else:
        blocks = src_mod.file_source(args.source, cfg,
                                     dtype=args.file_format,
                                     start_sample=args.start_sample)
    if args.max_blocks:
        blocks = itertools.islice(blocks, args.max_blocks)
    return run_pipelined(blocks, cfg, epoch=epoch, stats=stats,
                         batch=batch, quantize_i8=args.int8,
                         depth=args.depth, device=dev)


def _close_all(closers) -> None:
    """Teardown in REVERSE registration order: feed clients (appended
    last) stop before the output plugins they publish into, so no plugin
    receives frames after its socket or DB connection closed."""
    for c in reversed(closers):
        try:
            c()
        except Exception:
            pass


def _run_multichannel(args, srcs, cfg, bus, closers, stats=None) -> int:
    """Multi-channel operation (BASELINE config 4): every -s source is one
    channel of a single batched device call per step (the single-chip
    realization of the mesh "channel" axis). Merged messages publish on
    'dl_data'; channel c's also publish on f'dl_data/ch{c}'."""
    import itertools
    from ..dsp import host
    from ..io import native_stream
    from ..io import sources as src_mod
    from ..io.stream import run_channels

    needs_resample = abs(args.rate - cfg.channel_rate) > 1e-3

    dev = args.device

    def resampled_channel(path):
        # per-channel streaming resampler (each channel owns its filter
        # state and framer); shared helper with the single-channel path
        return src_mod.resampled_file_source(
            path, cfg, dtype=args.file_format, rate_in=args.rate,
            start_sample=args.start_sample, device=dev)

    # resampled + --int8 on a card: one batched fused device step per
    # time step (resample -> device quantize -> planar kernels) across all
    # channels — the channel-axis twin of the single-channel fused path
    fused_mc = (needs_resample and args.int8
                and all(s not in ("uhd", "osmocom", "udp", "synthetic")
                        for s in srcs)
                and _fused_resample_ok(cfg, args.rate, dev))

    chans = []
    if not fused_mc:
        for s in srcs:
            # both refusals close the plugins main() registered, as every
            # other validation exit does
            if s in ("uhd", "osmocom", "udp"):
                print(f"multi-channel mode takes file/synthetic sources, "
                      f"not {s!r}", file=sys.stderr)
                _close_all(closers)
                return 2
            if s == "synthetic":
                if needs_resample:
                    print("resampling is only wired for file sources",
                          file=sys.stderr)
                    _close_all(closers)
                    return 2
                chans.append(src_mod.synthetic_source(
                    cfg, n_blocks=args.max_blocks or 4))
            elif needs_resample:
                chans.append(resampled_channel(s))
            else:
                chans.append(src_mod.file_source(
                    s, cfg, dtype=args.file_format,
                    start_sample=args.start_sample))
        if args.max_blocks:
            chans = [itertools.islice(c, args.max_blocks) for c in chans]

    stats = stats if stats is not None else host.BlockStats()
    epoch = time.time()
    t_stats = time.time()
    n_steps = 0
    samples_done = 0
    # same native treatment as the single-channel path: all-file sources
    # with --int8 run the C++ framer (per-block AGC quantize, Python
    # semantics) + planar kernel + threaded dispatch
    if fused_mc:
        from ..io.stream import run_resampled_fused_channels
        chans = srcs
        step_iter = run_resampled_fused_channels(
            list(srcs), cfg, dtype=args.file_format, rate_in=args.rate,
            start_sample=args.start_sample, epoch=epoch, stats=stats,
            depth=args.depth, scale=args.i8_scale,
            max_blocks=args.max_blocks, device=dev)
    elif (not args.no_native and not needs_resample and args.int8
            and all(s not in ("synthetic",) for s in srcs)
            and args.start_sample >= 0
            and native_stream.native_available()):
        step_iter = native_stream.run_native_channels(
            list(srcs), cfg, fmt=args.file_format,
            start_sample=args.start_sample, epoch=epoch, stats=stats,
            depth=args.depth, max_blocks=args.max_blocks,
            scale=args.i8_scale, device=dev)
    else:
        step_iter = run_channels(chans, cfg, epoch=epoch, stats=stats,
                                 depth=args.depth, quantize_i8=args.int8,
                                 device=dev)
    from ..utils.profiling import trace
    try:
      with trace(args.profile):
        for step_msgs in step_iter:
            for c, msgs in enumerate(step_msgs):
                for m in msgs or []:
                    bus.publish("dl_data", m)
                    bus.publish(f"dl_data/ch{c}", m)
            n_steps += 1
            # dead channels yield None: count only LIVE channels so the
            # reported aggregate rate doesn't inflate after a shorter
            # capture ends
            samples_done += cfg.block_size * sum(
                1 for m in step_msgs if m is not None)
            if args.throttle:
                # one step = one block of per-channel stream time
                ahead = (n_steps * cfg.block_size / cfg.channel_rate
                         - (time.time() - epoch))
                if ahead > 0:
                    time.sleep(ahead)
            ivl = args.stats_interval or (10.0 if args.stats_json else 0)
            if ivl and time.time() - t_stats > ivl:
                rate = samples_done / (time.time() - epoch) / 1e6
                if args.stats_interval:
                    drop = (f" | RING-DROP {stats.ring_dropped}"
                            if stats.ring_dropped else "")
                    print(f"# {rate:.1f} Msps aggregate over {len(chans)} "
                          f"channels | preambles {stats.preambles} | "
                          f"ok {stats.crc_ok} | corrected {stats.corrected}"
                          f" | emitted {stats.emitted}{drop}",
                          file=sys.stderr)
                _emit_stats_json(args.stats_json, rate, stats, n_steps)
                t_stats = time.time()
    except KeyboardInterrupt:
        pass
    finally:
        _close_all(closers)
    print(f"# done: {n_steps} steps x {len(chans)} channels, "
          f"{stats.emitted} messages ({stats.crc_ok} crc-ok, "
          f"{stats.corrected} corrected)", file=sys.stderr)
    elapsed = time.time() - epoch
    _emit_stats_json(args.stats_json,
                     samples_done / elapsed / 1e6 if elapsed > 0 else 0.0,
                     stats, n_steps)
    return 0


def _write_ndjson(path, record: dict) -> None:
    """Append one NDJSON record to `path` ('-' = stdout). The single sink
    for every stats feed (DSP pipeline + aggregator): monitoring must
    never take down the receive chain, so OSError is swallowed here."""
    if not path:
        return
    import json
    rec = json.dumps(record)
    if path == "-":
        print(rec, flush=True)
        return
    try:
        with open(path, "a") as f:
            f.write(rec + "\n")
    except OSError:
        pass


def _emit_stats_json(path, rate_msps, stats, n_blocks) -> None:
    """One NDJSON record of the pipeline counters (ops/monitoring feed)."""
    _write_ndjson(path, {
        "ts": round(time.time(), 3), "msps": round(rate_msps, 3),
        "blocks": n_blocks, "preambles": stats.preambles,
        "crc_ok": stats.crc_ok, "corrected": stats.corrected,
        "crc_fail": stats.crc_fail, "emitted": stats.emitted,
        "overflow": stats.overflow, "ring_dropped": stats.ring_dropped,
    })


def _run_aggregator(args, net_urls, bus, closers) -> int:
    """Aggregator mode (beyond reference): subscribe remote receivers over
    Beast binary / AVR TCP and fan their frames through the same decode
    stack and output plugins as locally demodulated ones. Channel c's
    messages also publish on 'dl_data/ch<c>' (undeduplicated); the merged
    'dl_data' topic suppresses the same frame arriving from overlapping
    feeds within --dedup-window."""
    import threading
    from ..io.netclient import client_for_url, frame_deduper

    n_emitted = [0]
    done = threading.Event()
    lock = threading.Lock()
    dedup = frame_deduper(window_s=args.dedup_window)

    def make_cb(chan: int):
        def cb(wire: str) -> None:
            with lock:  # plugins are not thread-safe across client threads
                bus.publish(f"dl_data/ch{chan}", wire)
                if not dedup.accept(wire.split()[1]):
                    return
                bus.publish("dl_data", wire)
                n_emitted[0] += 1
                if args.max_messages and n_emitted[0] >= args.max_messages:
                    done.set()
        return cb

    clients = []
    for c, url in enumerate(net_urls):
        cli = client_for_url(url, make_cb(c)).start()
        clients.append(cli)
        closers.append(cli.close)
    def agg_stats_json() -> None:
        _write_ndjson(args.stats_json, {
            "ts": round(time.time(), 3), "feeds": len(clients),
            "frames": sum(c.n_frames for c in clients),
            "crc_dropped": sum(c.n_dropped for c in clients),
            "emitted": n_emitted[0],
        })

    t_stats = time.time()
    try:
        while not done.is_set():
            done.wait(0.5)
            ivl = args.stats_interval or (10.0 if args.stats_json else 0)
            if ivl and time.time() - t_stats > ivl:
                frames = sum(c.n_frames for c in clients)
                dropped = sum(c.n_dropped for c in clients)
                if args.stats_interval:
                    print(f"# aggregating {len(clients)} feeds | frames "
                          f"{frames} | crc-dropped {dropped}",
                          file=sys.stderr)
                agg_stats_json()
                t_stats = time.time()
    except KeyboardInterrupt:
        pass
    finally:
        _close_all(closers)
    print(f"# done: {n_emitted[0]} messages from {len(clients)} feeds",
          file=sys.stderr)
    agg_stats_json()   # final summary record
    return 0


def _run_frame_replay(args, path, bus, closers) -> int:
    """Replay a recorded Beast/AVR frame capture (e.g. a dump1090/readsb
    recording, or this framework's own -B/-w output) through the decode
    stack — no DSP. --throttle paces by the recording's 12 MHz MLAT
    counters."""
    from ..io.netclient import replay_file

    fmt = "beast" if args.file_format == "beastgps" else args.file_format
    n = 0
    t0 = time.time()
    try:
        for wire_msg, off in replay_file(
                path, fmt=fmt, gps_time=args.file_format == "beastgps"):
            if args.throttle:
                ahead = off - (time.time() - t0)
                if ahead > 0:
                    time.sleep(ahead)
            bus.publish("dl_data", wire_msg)
            n += 1
            if args.max_messages and n >= args.max_messages:
                break
    except KeyboardInterrupt:
        pass
    finally:
        _close_all(closers)
    print(f"# done: replayed {n} frames from {path}", file=sys.stderr)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_argparser().parse_args(argv)
    # --compile-cache is accepted and ignored: there is no XLA cache here

    from ..config import DspConfig
    from ..dsp import host
    from ..io.relay import local_pubsub

    cfg = DspConfig(channel_rate=args.channel_rate,
                    threshold_db=args.threshold,
                    block_size=args.block_size,
                    max_detections=args.max_detections)

    try:
        loc = parse_location(args.location)
    except ValueError as e:     # typo'd -l: clean CLI error, no traceback
        print(str(e), file=sys.stderr)
        return 2
    my_pos = (loc[0], loc[1]) if loc else None

    # shared pipeline counters: created before the plugins so observability
    # outputs (httpd /data/stats.json) can read them live. Only the DSP
    # paths update them — frame-replay/aggregator modes do not wire
    # them into httpd (a permanently-zero pipeline section reads as "the
    # pipeline is dead", worse than absent).
    stats = host.BlockStats()
    srcs = args.source or ["synthetic"]
    dsp_mode = (args.file_format not in ("beast", "beastgps", "avr")
                and not any(s.startswith(("beast://", "beastgps://",
                                          "avr://")) for s in srcs))
    if dsp_mode:
        # the demod's device, before any plugin or source opens: without
        # a card, --device cuda is a clean CLI error
        from ..dsp.pipeline import resolve_device
        try:
            resolve_device(args.device)
        except RuntimeError as e:
            print(str(e), file=sys.stderr)
            return 2

    # --- plugins ---------------------------------------------------------
    bus = local_pubsub()
    closers = []
    from ..decode.parse import parse as _parse_cls

    def parse_cls(pos):
        return _parse_cls(pos, cpr_global_first=args.cpr_global_first)

    shared_parser = parse_cls(my_pos)
    if not args.no_print:
        from ..outputs.msprint import output_print
        bus.subscribe("dl_data", output_print(shared_parser).output)
    if args.sbs1 is not None:
        from ..outputs.sbs1 import output_sbs1
        plug = output_sbs1(args.sbs1, parse_cls(my_pos))
        bus.subscribe("dl_data", plug.output)
        closers.append(plug.close)
    sql_plug = None
    if args.db:
        from ..outputs.sql import output_sql
        sql_plug = plug = output_sql(args.db, parse_cls(my_pos))
        bus.subscribe("dl_data", plug.output)
        closers.append(plug.close)
    if args.kml:
        if not args.db:
            print("KML output requires -d/--db", file=sys.stderr)
            _close_all(closers)
            return 2
        from ..outputs.kml import output_kml
        plug = output_kml(args.kml, args.db, my_pos)
        # flush the SQL batch before kml's final rewrite: teardown runs
        # in reverse registration order, so kml closes before sql
        # commits its tail and the final KML would read stale data
        closers.append(lambda k=plug, s=sql_plug:
                       (s.flush() if s is not None else None, k.close()))
    if args.raw is not None:
        from ..outputs.raw_server import output_raw
        plug = output_raw(args.raw)
        bus.subscribe("dl_data", plug.output)
        closers.append(plug.close)
    if args.beast is not None:
        from ..outputs.beast import output_beast
        plug = output_beast(args.beast, gps_time=args.beast_gps)
        bus.subscribe("dl_data", plug.output)
        closers.append(plug.close)
    if args.json:
        from ..outputs.json_out import output_json
        plug = output_json(args.json, parse_cls(my_pos))
        bus.subscribe("dl_data", plug.output)
        closers.append(plug.close)
    if args.wx:
        from ..outputs.wx import output_wx
        plug = output_wx(args.wx, parse_cls(my_pos),
                         declination_deg=args.declination)
        bus.subscribe("dl_data", plug.output)
        closers.append(plug.close)
    if args.http is not None:
        from ..outputs.httpd import output_http
        plug = output_http(args.http, parse_cls(my_pos), my_position=my_pos,
                           block_stats=stats if dsp_mode else None)
        bus.subscribe("dl_data", plug.output)
        closers.append(plug.close)
    if args.flightgear:
        from ..outputs.flightgear import output_flightgear
        hostname, _, port = args.flightgear.partition(":")
        plug = output_flightgear(hostname, int(port or 5000), parse_cls(my_pos))
        bus.subscribe("dl_data", plug.output)
        closers.append(plug.close)
    if args.pub:
        from ..io.relay import zmq_pubsub_iface
        relay = zmq_pubsub_iface(pubaddr=args.pub)
        bus.subscribe("dl_data", lambda m: relay.publish("dl_data", m))
        closers.append(relay.close)

    # --- source ----------------------------------------------------------
    if args.file_format in ("beast", "beastgps", "avr"):
        if len(srcs) != 1 or srcs[0] in ("udp", "synthetic", "uhd",
                                         "osmocom") or "://" in srcs[0]:
            print("frame-recording replay takes exactly one file source "
                  "(for a live network feed use -s beast://host:port "
                  "without --file-format)", file=sys.stderr)
            _close_all(closers)
            return 2
        return _run_frame_replay(args, srcs[0], bus, closers)
    n_net = sum(1 for s in srcs
                if s.startswith(("beast://", "beastgps://", "avr://")))
    if n_net:
        if n_net != len(srcs):
            print("network sources (beast://, beastgps://, avr://) may "
                  "not be mixed with sample sources", file=sys.stderr)
            _close_all(closers)
            return 2
        from ..io.netclient import parse_net_url
        for s in srcs:  # validate now: a typo'd URL should be a clean
            try:        # CLI error, not a traceback (or a silent dead feed)
                parse_net_url(s)
            except ValueError as e:
                print(str(e), file=sys.stderr)
                _close_all(closers)
                return 2
        return _run_aggregator(args, srcs, bus, closers)
    if len(srcs) > 1:
        return _run_multichannel(args, srcs, cfg, bus, closers, stats)
    args.source = srcs[0]

    # --- run loop: double-buffered device pipeline --------------------------
    from ..utils.profiling import trace
    epoch = time.time()
    t_stats = time.time()
    n_blocks = 0
    samples_done = 0
    import os
    try:
        # eager config/source validation: these otherwise raise lazily on
        # the first msg_iter step and escape as raw tracebacks
        cfg.sps                       # channel_rate must be a chip multiple
        if cfg.block_size < cfg.left_halo:
            raise ValueError(f"--block-size {cfg.block_size} < left halo "
                             f"{cfg.left_halo}")
        if args.source not in ("udp", "synthetic", "uhd", "osmocom") \
                and not os.path.exists(args.source):
            # uhd/osmocom excluded: they get build_msg_iter's dedicated
            # no-SDR-hardware diagnostic, not 'no such capture file: uhd'
            raise ValueError(f"no such capture file: {args.source}")
        msg_iter = build_msg_iter(args, cfg, epoch=epoch, stats=stats)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        _close_all(closers)   # plugins are already registered: a library
        # caller of main() must not leak bound ports/threads
        return 2
    try:
      with trace(args.profile):
        for msgs in msg_iter:
            for m in msgs:
                bus.publish("dl_data", m)
            n_blocks += 1
            samples_done += cfg.block_size
            if args.throttle:
                ahead = samples_done / cfg.channel_rate - (time.time() - epoch)
                if ahead > 0:
                    time.sleep(ahead)
            # --stats-json has its own cadence so --stats-interval 0
            # (quiet stderr) does not silence the machine-readable feed
            ivl = args.stats_interval or (10.0 if args.stats_json else 0)
            if ivl and time.time() - t_stats > ivl:
                rate = samples_done / (time.time() - epoch) / 1e6
                if args.stats_interval:
                    drop = (f" | RING-DROP {stats.ring_dropped}"
                            if stats.ring_dropped else "")
                    print(f"# {rate:.1f} Msps | preambles {stats.preambles}"
                          f" | ok {stats.crc_ok} | corrected "
                          f"{stats.corrected} | rejected {stats.crc_fail} |"
                          f" emitted {stats.emitted} | overflow "
                          f"{stats.overflow}{drop}", file=sys.stderr)
                _emit_stats_json(args.stats_json, rate, stats, n_blocks)
                t_stats = time.time()
    except KeyboardInterrupt:
        pass
    finally:
        _close_all(closers)
    print(f"# done: {n_blocks} blocks, {stats.emitted} messages "
          f"({stats.crc_ok} crc-ok, {stats.corrected} corrected)",
          file=sys.stderr)
    elapsed = time.time() - epoch
    _emit_stats_json(args.stats_json,
                     samples_done / elapsed / 1e6 if elapsed > 0 else 0.0,
                     stats, n_blocks)   # final summary record
    return 0


if __name__ == "__main__":
    sys.exit(main())
