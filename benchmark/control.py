"""The control of `correct`: the reference put in the program's place,
computed in the nearest precision below the configuration's, must come out
as not correct. It reads the numbers the comparison holds to the limits.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--device cuda]

For each seed it builds the cell's captures at the cell's own size and
judges, against the reference and the generator's ground truth, the
messages that the control gives for every block of one period of each
channel's looped stream (each block the window can hold, once). The control is the reference with int4
samples (7 quantizer steps a side on the same full scale); on a
configuration with a resampler, a second line gives the reference with its
FIR in f32 with TF32 on, for the record. It prints one JSON line per seed
and control, and whether each passed the configuration's limits (it must
not). The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if __package__ in (None, ""):
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    sys.path.insert(0, ROOT)

from benchmark import judge, spec, traffic  # noqa: E402
from benchmark.reference import Reference  # noqa: E402


def readings(cell, seed: int, device: str, **control) -> dict:
    """The numbers of one control on one seed's captures."""
    built = traffic.build(cell.config, cell.traffic, seed)
    caps = [c.data for c in built]
    ref = Reference(cell.config, caps, device)
    ctl = Reference(cell.config, caps, device, **control)
    blocks = [(c, b) for c in range(len(caps))
              for b in range(ref.period, 2 * ref.period)]
    truth = {c: (cp.truth, cp.samples) for c, cp in enumerate(built)}
    nums = judge.judge(judge.control_judged(ctl, blocks), ref, truth)
    chk = judge.check(nums, cell.config["limits"], 0)
    return {"numbers": {k: nums[k] for k in judge.NUMBERS},
            "counts": nums["counts"], "passed": judge.passed(chk)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    cell = spec.load_cell(a.workload, ROOT)
    controls = [("int4", {"levels": 7})]
    if cell.config.get("resampler"):
        controls.append(("tf32", {"tf32": True}))
    for seed in (int(s) for s in a.seeds.split(",")):
        for name, kw in controls:
            t = time.monotonic()
            r = readings(cell, seed, a.device, **kw)
            r.update(workload=a.workload, seed=seed, control=name,
                     seconds=round(time.monotonic() - t, 1))
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
