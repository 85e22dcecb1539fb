"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout (or `python -m benchmark.run ...`). The cell
is an entry of BENCHMARK.json; its configuration, traffic mix and
per-layer readers are files of this folder, found by name (`spec.py`).

Set-up (`setup_s`): the load generator's process starts and builds the
captures from the seed while this process imports torch and the port,
loads (on a checkout's first run, builds) the kernels and captures the
device step's graph on zero rows of the cell's shapes; then the stream
opens and its first blocks warm the path. The window follows:

- closed loop (`input_msps`): the generator writes as fast as the source
  takes the bytes; the source samples whose messages reached the sink
  inside the window, over the window's length;
- open loop (`latency_p50_ms`, `latency_p95_ms`): the generator writes each
  chunk once its last sample is due; for every channel-block whose row's
  last sample was due inside the window, the time its messages reached the
  sink less that due time.

Each value is worked out in every run of its kind, and the result reports
those that the cell's entries in BENCHMARK.json name.

After the window the generator ends the stream on a whole block and every
block taken in is drained (a minute at most): `attempted` counts them,
`failed` those whose messages never came. With `--trace 1` the port's
profiler records a steady part of the window and the per-layer readers
take their metrics from it; the end-to-end metrics are not reported.

Then the program's state is freed and the reference works out every
judged block again (`reference.py`, `modes.py`); `correct` is the
comparison's with it and with the generator's ground truth (`judge.py`). The last line of standard output is the result's JSON
object. Without a card (or with fewer than the cell asks for), or with
JAX or the JAX package loaded, it exits with another code than 0 and
prints no result.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if __package__ in (None, ""):
    # run as a script: import the benchmark as a package from the root,
    # not its modules from this folder
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    sys.path.insert(0, ROOT)

from benchmark import judge as judge_mod  # noqa: E402
from benchmark import spec, traffic as traffic_mod  # noqa: E402
from benchmark.tracing import WINDOW, Trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "airmodes")
DRAIN_S = 60.0
REPORT_EVERY = 16          # one block in this many keeps its reports
TRACE_LEAD_S = 2.0         # the trace opens this long into the window


def _say(line: str) -> None:
    print(f"# {line}", file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (`airmodes_torch` is not `airmodes`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def sampled(seed: int, c: int, b: int) -> bool:
    """Whether channel c's block b keeps its reports: one block in
    REPORT_EVERY, drawn from the seed."""
    return traffic_mod.derive_seed(seed, 0x5A5, c, b) % REPORT_EVERY == 0


def _range(name: str):
    import torch
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


class _Generator:
    """The load generator's process and its command pipe."""

    def __init__(self, job: dict):
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "gen.py"), json.dumps(job)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            bufsize=1)
        self.done = None

    def ready(self) -> str:
        line = self.proc.stdout.readline().split()
        if not line or line[0] != "ready":
            raise RuntimeError(f"load generator failed: {line}")
        return line[1]

    def wait_filled(self) -> None:
        """A file sink: wait until the generator has written its lead."""
        line = self.proc.stdout.readline().split()
        if not line or line[0] != "filled":
            raise RuntimeError(f"load generator failed: {line}")

    def send(self, line: str) -> None:
        try:
            self.proc.stdin.write(line + "\n")
            self.proc.stdin.flush()
        except (BrokenPipeError, ValueError):
            pass

    def finish(self, timeout: float = 30.0) -> None:
        """Close its commands, read its summary, wait for it."""
        try:
            out, _ = self.proc.communicate(timeout=timeout)
        except (subprocess.TimeoutExpired, BrokenPipeError, ValueError):
            self.kill()
            return
        for line in out.splitlines():
            if line.startswith("done "):
                self.done = json.loads(line[5:])

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def _device_info(device, count: int) -> dict:
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout.strip()
        info["power_limit_w"] = float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def _resampler_kernels(cfg, q: int, rows: int, device, tmp: str) -> list:
    """Names of the device kernels one call of the port's resampler
    (`resample_groups_halo`, the FIR of the fused step) launches on the
    cell's shapes, in order: profiled alone, at set-up."""
    import torch
    from airmodes_torch.resample.fused import raw_geometry
    from airmodes_torch.resample.polyphase import resample_groups_halo
    from airmodes_torch.utils.profiling import profiler
    left, block, right, _ = raw_geometry(cfg, 1, q)
    x = torch.zeros((2 * rows, left + block + right), device=device)
    resample_groups_halo(x, 1, q)
    torch.cuda.synchronize()
    with profiler() as prof:
        with torch.profiler.record_function(WINDOW):
            resample_groups_halo(x, 1, q)
            torch.cuda.synchronize()
    del x
    path = os.path.join(tmp, "resampler.json")
    prof.export_chrome_trace(path)
    tr = Trace.load(path)
    os.remove(path)
    return [d[0] for d in tr.device if d[4] == "kernel"]


class _Window:
    """Which channel-blocks the window takes in, and when it closes.

    Closed loop: the window opens when every channel has delivered its
    warm-up blocks and lasts `seconds`; it takes in the blocks delivered
    after it opened, up to the end of the stream that the generator ends
    once it closes. Open loop: it holds the blocks whose row's last sample
    is due in [w0, w0 + seconds), w0 the end of the warm-up blocks' air
    time; it closes once all of them reached the sink."""

    def __init__(self, t0, seconds, cfg, traffic, q, rate, chans):
        self.seconds = seconds
        self.open_loop = traffic["loop"] == "open"
        self.warm = traffic["warmup_blocks"]
        self.t0, self.cfg, self.q, self.rate = t0, cfg, q, rate
        self.chunk = traffic["chunk_samples"]
        self.w0 = self.w1 = None
        self.attempted = set()
        if self.open_loop:
            n = cfg.block_size
            self.w0 = t0 + self.warm * n * q / rate
            self.w1 = self.w0 + seconds
            first = last = self.warm
            while self.due(first) < self.w0:
                first += 1
            while self.due(last) < self.w1:
                last += 1
            self.attempted = {(c, b) for c in range(chans)
                              for b in range(first, last)}

    def due(self, b: int) -> float:
        """When the last sample of block b's row (its overlap included)
        was due on the open-loop stream."""
        n = self.cfg.block_size
        return traffic_mod.due_time(
            self.t0, self.q * ((b + 1) * n + self.cfg.right_halo) - 1,
            self.chunk, self.rate)

    def step(self, now: float, delivered: int) -> None:
        """After a step: a closed loop opens once each channel delivered
        its warm-up blocks."""
        if not self.open_loop and self.w0 is None and delivered >= self.warm:
            self.w0, self.w1 = now, now + self.seconds

    def done(self, now: float, rec) -> bool:
        if self.w1 is None:
            return False
        if self.open_loop:
            return all(k in rec for k in self.attempted)
        return now >= self.w1

    def close(self, rec, written, blk: int, right: int, chans: int):
        """Closed loop: the blocks taken in, from each channel's first block
        delivered in the window to the last whole block the generator
        wrote."""
        if self.open_loop:
            return
        ends = ([max(0, (w - right) // blk) for w in written] if written
                else [max([b + 1 for c2, b in rec if c2 == c], default=0)
                      for c in range(chans)])
        first = {}
        for (c, b), (td, _, _) in rec.items():
            if self.w0 < td and (c not in first or b < first[c]):
                first[c] = b
        self.attempted = {(c, b) for c in range(chans)
                          for b in range(first.get(c, ends[c]), ends[c])}

    def end_to_end(self, rec, n: int) -> dict:
        if not self.open_loop:
            inside = sum(1 for td, _, _ in rec.values()
                         if self.w0 < td <= self.w1)
            return {"input_msps": inside * n * self.q / self.seconds / 1e6}
        lat = sorted((rec[k][0] - self.due(k[1])) * 1e3
                     for k in self.attempted if k in rec)
        if not lat:
            return {}
        p95 = (statistics.quantiles(lat, n=100, method="inclusive")[94]
               if len(lat) > 1 else lat[0])
        return {"latency_p50_ms": statistics.median(lat),
                "latency_p95_ms": p95}


class _Profile:
    """The port's profiler over a steady part of the window: it opens
    TRACE_LEAD_S into the window and records `seconds`, inside the range
    `tracing.WINDOW`; `trace_mono` is that span on the monotonic clock."""

    def __init__(self, seconds: float, cuda: bool):
        self.seconds, self.cuda = seconds, cuda
        self.cm = self.prof = self.win = None
        self.trace_mono = None

    @property
    def over(self) -> bool:
        return self.trace_mono is not None and self.trace_mono[1] is not None

    def step(self, now: float, w0) -> bool:
        """Open or close the session; True when it has just closed its
        window (the caller ends the stream before the profiler stops)."""
        import torch
        if self.prof is None and w0 is not None and now >= w0 + TRACE_LEAD_S:
            from airmodes_torch.utils.profiling import profiler
            self.cm = profiler()
            self.prof = self.cm.__enter__()
            self.win = torch.profiler.record_function(WINDOW)
            self.win.__enter__()
            self.trace_mono = [time.monotonic(), None]
        elif self.prof is not None and not self.over and \
                now >= self.trace_mono[0] + self.seconds:
            if self.cuda:
                torch.cuda.synchronize()
            self.win.__exit__(None, None, None)
            self.trace_mono[1] = time.monotonic()
            return True
        return False

    def stop(self) -> None:
        self.cm.__exit__(None, None, None)

    def trace(self, tmp: str) -> Trace:
        path = os.path.join(tmp, "trace.json")
        self.prof.export_chrome_trace(path)
        tr = Trace.load(path)
        os.remove(path)
        return tr


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", log=_say) -> dict:
    """One run of `cell`; returns the result's object (see the module's
    docstring)."""
    tmp = tempfile.mkdtemp(prefix="airmodes-bench-")
    try:
        return _run(cell, seed, seconds, trace, device, log, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(cell, seed, seconds, trace, device, log, tmp) -> dict:
    config, traffic = cell.config, cell.traffic
    chans = traffic["channels"]
    q = round(config["source_rate"] / config["dsp"]["channel_rate"])
    parts = {}
    gen = stream = sink = None
    try:
        t = time.monotonic()
        job = {"config": config, "traffic": traffic, "seed": seed,
               "sink": config["sink"], "loop": traffic["loop"],
               "rate": config["source_rate"],
               "chunk_samples": traffic["chunk_samples"], "paths": []}
        if config["sink"] == "fifo":
            for c in range(chans):
                p = os.path.join(tmp, f"ch{c}.fifo")
                os.mkfifo(p)
                job["paths"].append(p)
        gen = _Generator(job)
        parts["generator_spawn_s"] = time.monotonic() - t

        t = time.monotonic()
        import torch
        from airmodes_torch.dsp import host
        from airmodes_torch.kernels import preamble as K
        from benchmark import sut
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.init()
            torch.cuda.reset_peak_memory_stats()
        parts["import_s"] = time.monotonic() - t

        t = time.monotonic()
        db = config["sqlite_db"]
        args = sut.modes_rx_args(config, job["paths"] or ["-"], device,
                                 os.path.join(tmp, "sink.db")
                                 if db == "file" else db)
        cfg = sut.dsp_config(args)
        sut.check_config(config, cfg)
        batch = args.batch if args.batch > 0 else (8 if cuda else 1)
        rows = chans if chans > 1 else batch
        blk, right = sut.stream_geometry(config, cfg)
        sut.warm_step(config, cfg, chans, batch, device)
        parts["kernels_and_graph_s"] = time.monotonic() - t

        res_names = []
        if trace and q > 1 and cuda:
            t = time.monotonic()
            res_names = _resampler_kernels(cfg, q, rows, device, tmp)
            parts["resampler_profile_s"] = time.monotonic() - t
            log(f"resampler kernels (one call alone): {res_names}")

        t = time.monotonic()
        path = gen.ready()
        if config["sink"] == "memfd":
            args.source = [path]
        parts["captures_wait_s"] = time.monotonic() - t

        t = time.monotonic()
        sink = sut.Sink(args.db)
        stats = host.BlockStats()
        t0 = time.monotonic() + 0.3
        # a file sink stays ahead of all the fused runner can hold in
        # flight (two read chunks of 2^22 samples and depth + 2 batches),
        # twice over, and 2^26 samples more
        ahead = 2 * (2 * (4 << 20) + (args.depth + 2) * batch * (
            blk + right)) + (1 << 26)
        gen.send(f"start {t0!r} {ahead}")
        if config["sink"] == "memfd":
            gen.wait_filled()
        stream = sut.open_stream(config, args, cfg, stats)
        if trace:
            # a traced run's window ends with its trace: stopping the
            # profiler collects its events on this thread, which would
            # stall the stream inside the window
            seconds = min(seconds, TRACE_LEAD_S + traffic["trace_seconds"]
                          + 1.0)
        win = _Window(t0, seconds, cfg, traffic, q, config["source_rate"],
                      chans)
        prof = _Profile(traffic["trace_seconds"], cuda) if trace else None
        nxt = [0] * chans
        rec = {}
        launches0 = dict(K.LAUNCHES)
        deadline = None

        def stop(now):
            # a file sink ends two batches past what was taken
            gen.send(f"stop {blk} {right} {min(nxt) + 2 * batch}")
            return max(now, win.w1) + DRAIN_S

        it = iter(stream)
        while True:
            with _range("bench.next"):
                step = next(it, None)
            if step is None:
                break
            for c, msgs in step:
                b = nxt[c]
                nxt[c] += 1
                if msgs is None:
                    continue
                with _range("bench.sink"):
                    kept = sink.take(msgs, sampled(seed, c, b))
                rec[(c, b)] = (time.monotonic(), msgs, None if kept is None
                               else [(m, judge_mod.report_fields(r))
                                     for m, r in kept])
            now = time.monotonic()
            if config["sink"] == "memfd":
                gen.send(f"progress {min(nxt) * blk}")
            win.step(now, min(nxt))
            if "stream_warmup_s" not in parts and win.w0 is not None \
                    and now >= win.w0:
                parts["stream_warmup_s"] = now - t
            if prof is not None and prof.step(now, win.w0):
                if not win.open_loop:
                    deadline = stop(now)
                prof.stop()
            if deadline is None and (
                    (win.done(now, rec) and (prof is None or prof.over))
                    or (win.w1 is not None and now > win.w1 + DRAIN_S)):
                deadline = stop(now)
            if deadline is not None and now > deadline:
                log("drain: the stream did not end within a minute")
                break
        t_end = time.monotonic()
        launches = {k: K.LAUNCHES[k] - launches0[k] for k in K.LAUNCHES}
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        setup_s = (win.w0 if win.w0 is not None else t_end) - T_START
        if win.open_loop:
            parts["open_loop_start_s"] = t0 - T_START
    finally:
        if stream is not None:
            stream.close()
        if sink is not None:
            sink.close()
        if gen is not None:
            gen.finish()
            gen.kill()
        stream = None

    win.close(rec, (gen.done or {}).get("written"), blk, right, chans)
    e2e = win.end_to_end(rec, cfg.block_size)
    e2e["setup_s"] = setup_s
    judged = {k: (rec[k][1], rec[k][2]) for k in win.attempted if k in rec}
    failed = len(win.attempted) - len(judged)
    log(f"set-up parts (s): {json.dumps(parts)}")
    log(f"end to end: {json.dumps(e2e)}")
    log(f"window: {win.seconds} s; blocks taken in {len(win.attempted)}, "
        f"delivered {len(judged)}; B1 launches "
        f"{launches.get('detect_cands')}, B2 {launches.get('slice_windows')};"
        f" messages {stats.emitted} ({stats.crc_ok} crc-ok, "
        f"{stats.corrected} corrected), preambles {stats.preambles}, "
        f"overflow {stats.overflow}")
    spans = sorted(e - s for s, e, _ in sink.spans
                   if win.w0 is not None and win.w0 <= s)
    if spans:
        log(f"sink: {len(spans)} blocks after the window opened, "
            f"{1e3 * sum(spans) / len(spans):.2f} ms each, p99 "
            f"{1e3 * spans[int(0.99 * (len(spans) - 1))]:.2f} ms, max "
            f"{1e3 * spans[-1]:.2f} ms")
    if gen.done:
        log(f"load generator: {json.dumps(gen.done)}")

    result = {"metrics": {}}
    dev_extra = {}
    if prof is not None and prof.over:
        tr = prof.trace(tmp)
        ctx = spec.ReadContext(
            trace=tr, sink_spans=sink.spans,
            trace_mono=tuple(prof.trace_mono), config=config,
            traffic=traffic, rows_per_call=rows, resampler_kernels=res_names)
        result["metrics"] = spec.read_metrics(cell, ctx)
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
        dev_extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
    elif not trace:
        result["metrics"] = {
            m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in e2e}
    prof = None

    # -- the reference, once the program's state is freed -------------------
    import gc
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.monotonic()
    from benchmark.reference import Reference
    caps = traffic_mod.build(config, traffic, seed)
    ref = Reference(config, [cp.data for cp in caps], device)
    numbers = judge_mod.judge(judged, ref, {c: (cp.truth, cp.samples)
                                            for c, cp in enumerate(caps)})
    chk = judge_mod.check(numbers, config["limits"], failed)
    log(f"reference and comparison took {time.monotonic() - t:.1f} s: "
        f"{json.dumps(numbers['counts'])}")
    n = numbers["counts"]
    log(f"ground truth (no limit): {n['injected_missed']} of "
        f"{n['injected']} injected frames in the judged blocks not emitted"
        f" ({n['injected_any_phase_missed']} of {n['injected_any_phase']} "
        f"at any phase)")

    dev = _device_info(device, cell.chips)
    dev["memory_peak_bytes"] = peak
    dev.update(dev_extra)
    out = {"correct": judge_mod.passed(chk), "attempted": len(win.attempted),
           "failed": failed, "metrics": result["metrics"], "device": dev}
    if "breakdown" in result:
        out["breakdown"] = result["breakdown"]
    out["check"] = chk
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
    cell = spec.load_cell(a.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run(cell, a.seed, a.seconds, bool(a.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
