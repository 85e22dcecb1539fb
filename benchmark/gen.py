"""The load generator: a process of its own that writes each channel's
looped capture into the system under test's source.

    python3 benchmark/gen.py '<json job>'

The job (from the harness) names the configuration and the traffic mix,
the seed and the sinks. The generator builds the
captures from the seed (`traffic.build`), prints `ready <path>` and waits
for commands on its standard input, one per line:

    start <t0> <a>   begin writing; an open-loop mix paces from t0
                     (time.monotonic(), one clock for every process); a
                     file sink stays a samples ahead of the harness
    progress <n>     the harness has taken n samples of the stream
                     (file sinks only: the generator stays ahead of it)
    stop <b> <r> [m] write on to the next whole block (M * b + r samples
                     end M blocks of b samples with a right halo of r),
                     then close; a file sink ends at m blocks instead,
                     cutting what the reader has not read

Sinks. `fifo`: one named pipe per channel, opened for writing in channel
order (the reader opens them in the same order), written without blocking
so that one full pipe never holds back another channel. `memfd`: one
in-memory file (never on disk), which the reader opens as a path under
/proc; the generator keeps it ahead of what the harness took by more than
the reader can hold in flight, and frees the pages behind, so the file grows without bound while holding
little memory. A closed-loop mix writes as fast as the sink takes the
bytes; an open-loop one writes chunk n of every channel once its last
sample is due, t0 + (n + 1) * chunk / rate, and never slows for the
system: it records how late each chunk went into its pipe.

At the end it prints `done <json>`: per channel the samples written and
the whole blocks they hold, and the open loop's lateness.
"""

from __future__ import annotations

import ctypes
import fcntl
import json
import os
import select
import sys
import threading
import time

if __package__ in (None, ""):
    _here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _here]
    sys.path.insert(0, os.path.dirname(_here))
from benchmark import traffic as traffic_mod  # noqa: E402

F_SETPIPE_SZ = 1031
PIPE_BYTES = 1 << 20
BEHIND = 64 << 20               # memfd: bytes kept behind the reader
FILLED = 256 << 20              # memfd: bytes written before the reader
#                                 opens it (it reads slower than this fills)
FALLOC_PUNCH = 3                # FALLOC_FL_KEEP_SIZE | FALLOC_FL_PUNCH_HOLE


class _Commands:
    """The harness's commands, read on a thread of their own."""

    def __init__(self):
        self.t0 = None
        self.taken = 0
        self.stop = False
        self.block = self.right = 1
        self.blocks = None
        self.ahead = 0
        self.started = threading.Event()
        self.closed = threading.Event()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in sys.stdin:
            word, _, arg = line.strip().partition(" ")
            if word == "start":
                t0, ahead = arg.split()
                self.t0, self.ahead = float(t0), int(ahead)
                self.started.set()
            elif word == "progress":
                self.taken = int(arg)
            elif word == "stop":
                v = [int(x) for x in arg.split()]
                self.block, self.right = v[:2]
                self.blocks = v[2] if len(v) > 2 else None
                self.stop = True
        self.stop = True             # the harness is gone
        self.started.set()
        self.closed.set()


class _Channel:
    """One channel's looped capture and what is queued for its sink."""

    def __init__(self, data, bps: int):
        self.data = memoryview(data)            # bytes of the capture
        self.bps = bps
        self.appended = 0            # bytes handed to the queue
        self.written = 0             # bytes the sink took
        self.queue = []              # memoryviews not yet taken
        self.ends = []               # (byte end, due) of open-loop chunks
        self.late = []
        self.gone = False

    def append(self, nbytes: int, due=None) -> None:
        n = len(self.data)
        while nbytes:
            pos = self.appended % n
            take = min(nbytes, n - pos)
            self.queue.append(self.data[pos:pos + take])
            self.appended += take
            nbytes -= take
        if due is not None:
            self.ends.append((self.appended, due))

    def pending(self) -> int:
        return self.appended - self.written

    def write(self, fd: int) -> None:
        while self.queue:
            try:
                k = os.write(fd, self.queue[0])
            except BlockingIOError:
                break
            except BrokenPipeError:        # the reader is gone
                self.queue.clear()
                self.written = self.appended
                self.gone = True
                break
            self.written += k
            if k == len(self.queue[0]):
                self.queue.pop(0)
            else:
                self.queue[0] = self.queue[0][k:]
                break
        now = time.monotonic()
        while self.ends and self.ends[0][0] <= self.written:
            self.late.append(now - self.ends.pop(0)[1])


def _stop_target(appended_samples: int, block: int, right: int) -> int:
    """Samples that end the stream on whole blocks: the least M*block +
    right at or past what was already queued."""
    m = max(1, -(-(appended_samples - right) // block))
    return m * block + right


def _run_fifo(job, chans, cmds) -> None:
    bps = chans[0].bps
    chunk = job["chunk_samples"] * bps
    rate = job["rate"]
    open_loop = job["loop"] == "open"
    cmds.started.wait()
    t0 = cmds.t0 if cmds.t0 is not None else time.monotonic()
    fds = []
    for path in job["paths"]:
        fd = os.open(path, os.O_WRONLY)          # waits for the reader
        try:
            fcntl.fcntl(fd, F_SETPIPE_SZ, PIPE_BYTES)
        except OSError:
            pass
        fl = fcntl.fcntl(fd, fcntl.F_GETFL)
        fcntl.fcntl(fd, fcntl.F_SETFL, fl | os.O_NONBLOCK)
        fds.append(fd)
    n = 0
    target = None
    while True:
        now = time.monotonic()
        if cmds.stop and target is None:
            target = _stop_target(max(c.appended for c in chans) // bps,
                                  cmds.block, cmds.right) * bps
        if target is not None:
            for c in chans:
                if c.appended < target and not c.gone:
                    c.append(target - c.appended)
        elif open_loop:
            while t0 + (n + 1) * job["chunk_samples"] / rate <= now:
                due = t0 + (n + 1) * job["chunk_samples"] / rate
                for c in chans:
                    c.append(chunk, due)
                n += 1
        else:
            for c in chans:
                while c.pending() < 2 * chunk and not c.gone:
                    c.append(chunk)
        for c, fd in zip(chans, fds):
            if c.queue:
                c.write(fd)
        if target is not None and not any(c.queue for c in chans):
            break
        if open_loop and target is None:
            wait = t0 + (n + 1) * job["chunk_samples"] / rate - \
                time.monotonic()
            wait = max(0.0, min(wait, 0.005 if any(c.queue for c in chans)
                                else wait))
        else:
            wait = 0.005
        busy = [fd for c, fd in zip(chans, fds) if c.queue]
        if busy:
            poller = select.poll()
            for fd in busy:
                poller.register(fd, select.POLLOUT)
            poller.poll(wait * 1e3)
        else:
            time.sleep(wait)
    for fd in fds:
        os.close(fd)


def _run_memfd(chans, cmds, fd) -> None:
    c = chans[0]
    step = 16 << 20
    freed = 0
    libc = ctypes.CDLL(None, use_errno=True)
    libc.fallocate.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_long,
                               ctypes.c_long]
    cmds.started.wait()
    target = None
    filled = False
    while True:
        taken = cmds.taken * c.bps
        if cmds.stop and target is None:
            target = (cmds.blocks * cmds.block + cmds.right) * c.bps
            if target < c.appended:
                # the reader has what it already read; the file now ends
                # on the harness's M blocks
                os.ftruncate(fd, target)
                c.appended = c.written = target
        limit = target if target is not None else \
            taken + cmds.ahead * c.bps
        while c.appended < limit:
            c.append(min(step, limit - c.appended))
            while c.queue:
                c.write(fd)
            if not filled and c.written >= min(limit, FILLED):
                break
        if not filled and c.written >= min(limit, FILLED):
            print("filled", flush=True)
            filled = True
        if target is not None:
            break
        keep = taken - BEHIND
        if keep - freed >= step:
            libc.fallocate(fd, FALLOC_PUNCH, freed, keep - freed)
            freed = keep
        time.sleep(0.002)


def main(argv) -> int:
    job = json.loads(argv[1])
    caps = traffic_mod.build(job["config"], job["traffic"], job["seed"])
    bps = traffic_mod.BYTES_PER_SAMPLE[job["config"]["sample_format"]]
    chans = [_Channel(cap.data.view("u1"), bps) for cap in caps]
    cmds = _Commands()
    if job["sink"] == "memfd":
        fd = os.memfd_create("airmodes-bench-capture")
        path = f"/proc/{os.getpid()}/fd/{fd}"
        print(f"ready {path}", flush=True)
        _run_memfd(chans, cmds, fd)
    else:
        print("ready -", flush=True)
        _run_fifo(job, chans, cmds)
    late = sorted(x for c in chans for x in c.late)
    done = {"written": [c.written // bps for c in chans],
            "chunks": len(late)}
    if late:
        done.update(late_ms_p50=1e3 * late[len(late) // 2],
                    late_ms_p95=1e3 * late[int(0.95 * (len(late) - 1))],
                    late_ms_max=1e3 * late[-1])
    print("done " + json.dumps(done), flush=True)
    if job["sink"] == "memfd":
        # the reader may still be reading the file: keep it open until
        # the harness closes our standard input
        cmds.closed.wait()
        os.close(fd)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
