"""The load generator: the same seed gives the same captures and stream,
byte for byte; the open loop's pacing arithmetic."""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from conftest import ROOT
from benchmark import traffic

CONFIG = {"source_rate": 2e6, "sample_format": "uc8"}
TRAFFIC = {"channels": 3, "capture_samples": 1 << 17, "msg_rate_hz": 500.0,
           "snr_db": 15.0}


def test_captures_are_a_function_of_the_seed():
    seed = 2 ** 31 + 17          # larger than 32 signed bits hold
    a = traffic.build(CONFIG, TRAFFIC, seed)
    b = traffic.build(CONFIG, TRAFFIC, seed)
    c = traffic.build(CONFIG, TRAFFIC, seed + 1)
    assert len(a) == 3
    for x, y in zip(a, b):
        assert np.array_equal(x.data, y.data) and x.truth == y.truth
    assert not np.array_equal(a[0].data, c[0].data)
    assert not np.array_equal(a[0].data, a[1].data)   # channels differ
    assert a[0].data.dtype == np.uint8 and a[0].samples == 1 << 17
    sc = traffic.build(dict(CONFIG, sample_format="sc16", source_rate=1e7),
                       dict(TRAFFIC, channels=1), seed)[0]
    assert sc.data.dtype == np.int16
    assert np.abs(sc.data.astype(np.int32)).max() <= 32767


def test_traffic_mix_and_rate():
    cap = traffic.build(CONFIG, dict(TRAFFIC, channels=1), 5)[0]
    want = int((1 << 17) / 2e6 * 500)
    assert len(cap.truth) in (want, want - 1)      # the last may not fit
    dfs = [int(h[:2], 16) >> 3 for _, h in cap.truth]
    assert 0.55 <= sum(d == 17 for d in dfs) / len(dfs) <= 0.65
    assert {0, 11, 16, 17, 20, 21} <= set(dfs) and max(dfs) >= 24


def test_due_time_arithmetic():
    # chunk n of 65536 samples at 2 Msps is due once its last sample is
    assert traffic.due_time(10.0, 0, 65536, 2e6) == 10.0 + 65536 / 2e6
    assert traffic.due_time(10.0, 65535, 65536, 2e6) == 10.0 + 65536 / 2e6
    assert traffic.due_time(10.0, 65536, 65536, 2e6) == \
        10.0 + 2 * 65536 / 2e6
    n = (1 << 20) + 1792 - 1        # a block's row ends in chunk 16
    assert traffic.due_time(0.0, n, 65536, 2e6) == 17 * 65536 / 2e6


def _gen(job):
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "benchmark", "gen.py"),
         json.dumps(job)], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        text=True, bufsize=1)


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_generator_writes_the_looped_capture(tmp_path, loop):
    """Through a named pipe, closed and open loop: the stream is the
    capture looped, and `stop` ends it on a whole block (M * block +
    right samples)."""
    tr = dict(TRAFFIC, channels=1, capture_samples=1 << 16)
    fifo = str(tmp_path / "ch0.fifo")
    os.mkfifo(fifo)
    job = {"config": CONFIG, "traffic": tr, "seed": 9, "sink": "fifo",
           "loop": loop, "rate": 2e8 if loop == "open" else 2e6,
           "chunk_samples": 4096, "paths": [fifo]}
    p = _gen(job)
    assert p.stdout.readline().split() == ["ready", "-"]
    import time
    p.stdin.write(f"start {time.monotonic()!r} 0\n")
    p.stdin.flush()
    got = bytearray()

    def reader():
        with open(fifo, "rb") as f:
            while True:
                b = f.read(1 << 16)
                if not b:
                    return
                got.extend(b)
    th = threading.Thread(target=reader)
    th.start()
    while len(got) < 3 * (1 << 17):
        time.sleep(0.01)
    p.stdin.write("stop 8192 100\n")
    p.stdin.flush()
    th.join(timeout=30)
    out, _ = p.communicate(timeout=30)
    done = json.loads(out.split("done ", 1)[1])
    cap = traffic.build(CONFIG, tr, 9)[0].data.tobytes()
    n = len(got) // 2
    assert (n - 100) % 8192 == 0 and done["written"] == [n]
    reps = -(-len(got) // len(cap))
    assert bytes(got) == (cap * reps)[:len(got)]
    if loop == "open":
        assert done["chunks"] > 0 and done["late_ms_max"] >= 0
