#!/usr/bin/env python3
"""What the port's profiler trace shows of its hand kernels, tree by tree,
on one CUDA card (fault C2, ROADMAP C).

    python3 trace_check.py ROOT [ROOT ...] [--windows N] [--out FILE]

Each ROOT is a checkout of the repository (for instance the parent commit
unpacked with `git archive` into the git-ignored `.archive_check/`, and
`.`). One process per tree imports that tree's `airmodes_torch`, builds its
kernels and runs `c2_report` of the chip_smoke.py beside this script over a
32-block uc8 capture made from a fixed seed: the libcudart each kernel
library links and the process maps; `modes_rx --int8 --profile`, its
wrappers' launch counts against its trace's device events and ranges; B1
and B2 launched bare, without and with a torch kernel between them; the
int8 step; N (200) profiler sessions of one int8 step each, counting the
sessions that lost a device event and the card clock's offset; B1 and the
whole planar step at C = 64 blocks of 2^22 beside their card times behind
a spin. A tree whose `utils/profiling.py` has no `profiler()` is profiled
with the session its chip_smoke opened (host and card, the calling thread
only). The script reports and does not judge: chip_smoke's phase 17 holds
its own tree to the same numbers. It also takes a SHA-256 of each kernel
library's `cuobjdump -sass` (with the anonymous namespaces' path-derived
names made equal) and says whether the trees' device code is the same,
with the first lines of any difference. Last it prints one JSON line of
every tree's report (--out also writes it to FILE).
"""

from __future__ import annotations

import argparse
import difflib
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))


def _smoke():
    """This tree's chip_smoke.py, loaded by path (its helpers import the
    package lazily, so they serve whichever tree a process imported)."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def report_tree(out: str, windows: int) -> None:
    """c2_report and the SASS digests of the tree on sys.path[0], as JSON
    into `out`."""
    import torch
    from airmodes_torch.config import DspConfig
    from airmodes_torch.kernels import _ext
    from airmodes_torch.probes import flush_buffer
    from airmodes_torch.utils import profiling
    if not torch.cuda.is_available():
        raise SystemExit("trace_check: no CUDA device")
    if not hasattr(profiling, "profiler"):
        from torch.profiler import ProfilerActivity, profile
        profiling.profiler = lambda: profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA])
    S = _smoke()
    dev = torch.device("cuda", 0)
    _ext.build_all()
    cuobjdump = os.path.join(os.path.dirname(_ext._nvcc()), "cuobjdump")
    sass = {}
    for name in _ext.SIGNATURES:
        dump = subprocess.run([cuobjdump, "-sass", _ext._target(name)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        # nvcc names each source's anonymous namespace by a hash that
        # depends on the source's path, not on the code
        dump = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", dump)
        sass[name] = hashlib.sha256(dump.encode()).hexdigest()
        with open(f"{out}.{name}.sass", "w") as f:
            f.write(dump)
    cfg = DspConfig()
    with tempfile.TemporaryDirectory() as tmp:
        uc8 = os.path.join(tmp, "main.uc8")
        S.write_capture(cfg, uc8, S.N_MAIN_BLOCKS)
        rep = S.c2_report(cfg, dev, tmp, uc8, flush_buffer(dev), windows)
    rep["sass"] = sass
    rep["torch"] = torch.__version__
    with open(out, "w") as f:
        json.dump(rep, f)


def _summary(root: str, rep: dict) -> None:
    print(f"== {root} (torch {rep['torch']})")
    print(f"   libcudart mapped: {rep['cudart']['maps']}")
    for name, lines in rep["cudart"]["ldd"].items():
        print(f"   ldd lib{name}: {lines or 'no libcudart (static runtime)'}")
    syms = ("detect_chunk_kernel", "merge_unordered_kernel",
            "slice_windows_kernel")
    ranges = ("B1 detect_cands", "B2 slice_windows")
    cli = rep["cli"]
    views = [("modes_rx --int8 --profile", cli["trace"],
              f"launch counts {cli['launches']}, exit {cli['rc']}")]
    views += [(f"{k}, 5 calls", rep[k], "") for k in
              ("bare", "bare+op", "step")]
    views += [(f"C = 64 x 2^22 {k!r}, 5 calls", v["trace"],
               f"card {v['card_ms']} ms") for k, v in rep["big"].items()]
    for what, t, extra in views:
        if t is None:
            print(f"   {what}: no trace written; {extra}")
            continue
        print(f"   {what}: device events "
              f"{ {s: t['kernels'][s] for s in syms} }, without their CPU "
              f"launch { {s: t['orphans'][s] for s in syms} }, ranges "
              f"{ {r: t['ranges'].get(r, 0) for r in ranges} }, "
              f"{t['host_ops']} host ops on {t['host_threads']} threads, "
              f"{t['lost']} launches without a device event (primer "
              f"{t['primer_lost']}), clock lead "
              f"{t['lead_us']:.1f} us, busy "
              f"{t['busy_us']:.1f} us over {t['device_events']} device "
              f"events; {extra}")
    w = rep["windows"]
    print(f"   {len(w)} one-step sessions: "
          f"{sum(1 for x in w if x['lost'] or x['B1'] != 1)} lost device "
          f"events ({sum(x['lost'] for x in w)} launches in all), "
          f"{sum(1 for x in w if x.get('primer_lost'))} their primer's; the "
          f"card's clock mapped up to {max(x['lead_us'] for x in w):.1f} us "
          f"early")
    k = rep["big"]["k"]
    b1 = (k["trace"]["kernel_us"]["detect_chunk_kernel"]
          + k["trace"]["kernel_us"]["merge_unordered_kernel"]) / 5 / 1e3
    print(f"   B1 at C = 64 x 2^22: {b1:.5f} ms per call in the trace, "
          f"{k['card_ms']:.5f} ms card time")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 trace_check.py")
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--out")
    ap.add_argument("--windows", type=int, default=200,
                    help="one-step profiler sessions per tree [200]")
    ap.add_argument("--report", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.report:
        sys.path.insert(0, os.path.abspath(args.roots[0]))
        report_tree(args.report, args.windows)
        return 0
    reports, failed = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for i, root in enumerate(args.roots):
            path = os.path.join(tmp, f"{i}.json")
            rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                 root, "--report", path, "--windows",
                                 str(args.windows)],
                                timeout=1200).returncode
            if rc != 0:
                print(f"trace_check: {root}: exit {rc}", flush=True)
                failed.append(root)
                continue
            with open(path) as f:
                reports[root] = json.load(f)
            _summary(root, reports[root])
        if failed:
            return 1
        digests = {root: r["sass"] for root, r in reports.items()}
        first = next(iter(digests.values()))
        for name in first:
            same = len({d[name] for d in digests.values()}) == 1
            print(f"sass lib{name}: "
                  f"{'the same in every tree' if same else 'DIFFERS'} "
                  f"({first[name][:16]})")
            if not same:
                dumps = []
                for i in range(len(args.roots)):
                    with open(os.path.join(tmp, f"{i}.json.{name}.sass")) as f:
                        dumps.append(f.read().splitlines())
                diff = list(difflib.unified_diff(dumps[0], dumps[-1],
                                                 lineterm="", n=1))
                print(f"  {len(diff)} lines of diff, the first 30:")
                for ln in diff[:30]:
                    print(f"  {ln}")
    line = json.dumps(reports)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
