#!/usr/bin/env python3
"""Device times of the port's detect kernels in two trees, in turns, on one
CUDA card.

    python3 kernel_times.py OLD_ROOT NEW_ROOT [--out FILE]

OLD_ROOT and NEW_ROOT are checkouts of the repository (for instance the
parent commit unpacked with `git archive` into the git-ignored
`.archive_check/`, and `.`). The script makes the inputs once, from fixed
seeds, then runs one process per tree in the order old, new, new, old, so
that each imports its own `airmodes_torch` and builds its own kernels. Each
process times, on the same inputs, the kernels B1, B5o (ordered) and B5p
(prescreen) on 8 planar int8 channels at DspConfig(); B2 on the windows of
B1's detections there, at the demod paths' width and at the reference's
(a tree whose B2 has one width times it for both); B3 on one f32 block
and B4 and B6 on 8; B6 on 8 blocks at 20 Msps (sps 10); and a one-element
in-place add, the launch floor of the harness. A time is what
chip_smoke.py takes: the median of 20 CUDA-event timings after 3 untimed
runs, the L2 cache evicted before each. It prints each run's times, then
per kernel the median of each tree's runs, with the card's name and power
limit, and last one JSON line of the same; --out writes that line to FILE.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = ["B1", "B5o", "B5p", "B2 main width", "B2 reference width", "B3",
           "B4", "B6", "B6 sps 10", "launch floor"]


def _smoke():
    """This tree's chip_smoke.py, loaded by path (its helpers import the
    package lazily, so they serve whichever tree a process imported)."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_inputs(path: str) -> None:
    import numpy as np
    from airmodes_torch.config import DspConfig
    S = _smoke()
    ((xi, xq), xf), _ = S.mixed_capture(DspConfig(), S.BATCH, seed=0)
    (_, x10), _ = S.mixed_capture(DspConfig(channel_rate=20e6), S.BATCH,
                                  seed=6, planar=False)
    np.savez(path, xi=xi, xq=xq, xf=xf, x10=x10)


def time_tree(inputs: str) -> dict:
    """Median ms of each kernel of the tree on sys.path[0]."""
    import numpy as np
    import torch
    from airmodes_torch.config import DspConfig
    from airmodes_torch.kernels import _ext
    from airmodes_torch.kernels import preamble as K
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    S = _smoke()
    dev = torch.device("cuda", 0)
    _ext.build_all()
    d = np.load(inputs)
    cfg, cfg10 = DspConfig(), DspConfig(channel_rate=20e6)
    ti, tq = (torch.from_numpy(d[k]).to(dev) for k in ("xi", "xq"))
    xf = torch.from_numpy(d["xf"]).to(dev)
    x10 = torch.from_numpy(d["x10"]).to(dev)
    tile = K.supported_2d_tile(cfg)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    # B2's windows as chip_smoke times them: B1's detections and 3 more
    det, valid, _, _ = K.compact_candidates_unordered(
        K.preamble_detect_cands_planar(ti, tq, cfg, ordered=False), cfg,
        K.default_tile(cfg))
    base = S.b2_bases(cfg, ti, det, valid)[: det.numel() + 3]
    ri, rq = ti.reshape(-1, 128), tq.reshape(-1, 128)
    if hasattr(K, "_slice_windows"):
        def b2(main):
            return K._slice_windows(ri, rq, base, cfg, 0,
                                    K._slice_cols(cfg, 0, main))
    else:
        def b2(main):
            return K.slice_windows_planar(ri, rq, base, cfg)
    one = torch.zeros(1, device=dev)
    calls = {
        "B1": lambda: K.preamble_detect_cands_planar(ti, tq, cfg,
                                                     ordered=False),
        "B5o": lambda: K.preamble_detect_cands_planar(ti, tq, cfg,
                                                      ordered=True),
        "B5p": lambda: K.preamble_detect_cands_planar(ti, tq, cfg,
                                                      ordered=False,
                                                      prescreen=True),
        "B2 main width": lambda: b2(True),
        "B2 reference width": lambda: b2(False),
        "B3": lambda: K.preamble_detect_2d(xf[0], cfg, tile),
        "B4": lambda: K.preamble_detect_2d_batch(xf, cfg, tile),
        "B6": lambda: K.preamble_detect_1d_batch(xf, cfg, 16384),
        "B6 sps 10": lambda: K.preamble_detect_1d_batch(x10, cfg10, 16384),
        "launch floor": lambda: one.add_(1.0),
    }
    return {k: S.time_ms(fn, flush=flush) for k, fn in calls.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--out")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        sys.path.insert(0, os.path.abspath(a.one))
        print(json.dumps(time_tree(a.inputs)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    smi = _smoke().smi_line()
    runs = {a.old: [], a.new: []}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.npz")
        make_inputs(inputs)
        for root in (a.old, a.new, a.new, a.old):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), a.old, a.new,
                 "--one", root, "--inputs", inputs], capture_output=True,
                text=True, check=True)
            ms = json.loads(out.stdout.strip().splitlines()[-1])
            runs[root].append(ms)
            print(f"run {root}: " + ", ".join(f"{k} {ms[k]:.5f}"
                                              for k in KERNELS), flush=True)
    med = {root: {k: statistics.median(r[k] for r in rs) for k in KERNELS}
           for root, rs in runs.items()}
    for k in KERNELS:
        print(f"{k}: old {med[a.old][k]:.5f} ms, new {med[a.new][k]:.5f} ms "
              f"[{smi}]", flush=True)
    line = json.dumps({"card": smi, "old": a.old, "new": a.new,
                       "median_ms": med, "runs": runs})
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
