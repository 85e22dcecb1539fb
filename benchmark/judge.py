"""The comparison that decides `correct`: what the timed path emitted for
each judged block, against the plain reference's messages for that block
(`reference.py`, `modes.py`) and against the generator's ground truth.

A message is keyed by everything on the wire but its level: DF, frame,
syndrome, status, and both timestamps (which place it at one sample of
one block). Three numbers, each held to a limit of its own (the
configuration file's `limits`):

- `diff_share`: reference messages the program did not emit, and program
  messages the reference does not hold, over the reference's messages;
  where the reference's frame hangs on an exact tie (`modes.decide`),
  whatever the program emits at that sample, or nothing, is taken;
- `dbfs_gap_db`: the widest gap between the two levels (dBFS, as printed on
  the wire) of one message emitted by both;
- `report_diff_share`: of the reports that the program's parser made for
  the sampled blocks' messages (those that went into SQLite), the share
  that differs from `modes.fields` of the same frame in DF, address or
  barometric altitude, where those rules decide the field; a message the
  parser refused counts as differing. An exact comparison: limit 0.

`undelivered` counts attempted blocks whose messages never reached the
sink: its limit is 0.

Beside them, and held to no limit, the ground truth: the frames the
generator injected whose preamble lies in a judged block, and how many the
program did not emit with the same hex within `TRUTH_SLACK` channel
samples of where they were injected (`truth_missed`); behind a resampler
also counted over the frames whose chips a demod at one sample a chip can
resolve (`Reference.resolvable`). The int4 control misses no more of them
than sound runs do at the cells' 15 dB, so no limit could tell the two
apart (PERF.md).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from . import modes

NUMBERS = ("diff_share", "dbfs_gap_db", "report_diff_share")
FIELDS = ("df", "icao", "altitude_ft")
TRUTH_SLACK = 2


def report_fields(rep) -> Optional[dict]:
    """The compared fields of one of the program's reports, None for a
    message its parser refused."""
    if rep is None:
        return None
    return {f: getattr(rep, f, None) for f in FIELDS}


def _split(msg: str) -> Tuple[tuple, float]:
    p = msg.split()
    return (p[0], p[1], p[2], p[3], p[5], p[6] if len(p) > 6 else ""), \
        float(p[4])


def _stamp(key: tuple) -> str:
    return f"{key[4]} {key[5]}"


def _report_differs(msg: str, got: Optional[dict]) -> bool:
    want = modes.fields(msg.split()[1])
    return got is None or any(got.get(k) != v for k, v in want.items())


def truth_missed(judged, truth, block: int, q: int, rate: float,
                 resolvable=lambda s: True) -> Tuple[int, int, int, int]:
    """(missed, injected) of the frames of `truth` ({channel: (frames,
    period)}: the (sample at the source rate, hex) pairs of one period of
    the looped capture, in sample order, and its length) whose preamble
    lies in a judged block and that `resolvable` accepts, and the same of
    every such frame: a frame is missed when no judged message of its
    channel holds it within TRUTH_SLACK channel samples."""
    seen: Dict[Tuple[int, str], List[int]] = {}
    for (c, _), (msgs, _) in judged.items():
        for m in msgs:
            p = m.split()
            sample = int(p[6]) * int(rate) // 1_000_000_000 \
                if len(p) > 6 else round(float(p[5]) * rate)
            seen.setdefault((c, p[1]), []).append(sample)
    for v in seen.values():
        v.sort()
    missed = injected = missed_all = injected_all = 0
    starts = {c: [p for p, _ in frames] for c, (frames, _) in truth.items()}
    for (c, b) in judged:
        frames, period = truth[c]
        lo, hi = b * block * q, (b + 1) * block * q
        for k in range(lo // period, (hi - 1) // period + 1):
            i0 = bisect.bisect_left(starts[c], lo - k * period)
            i1 = bisect.bisect_left(starts[c], hi - k * period)
            for p, hx in frames[i0:i1]:
                s = p + k * period
                at = s / q
                near = seen.get((c, hx), [])
                i = bisect.bisect_left(near, at - TRUTH_SLACK)
                lost = not (i < len(near) and near[i] <= at + TRUTH_SLACK)
                injected_all += 1
                missed_all += lost
                if resolvable(s):
                    injected += 1
                    missed += lost
    return missed, injected, missed_all, injected_all


def judge(judged: Dict[Tuple[int, int], tuple], ref, truth=None) -> dict:
    """judged: {(channel, block): (messages, [(message, report fields)] or
    None)}; ref: a prepared-on-demand `reference.Reference`; truth: per
    channel, (frames, period) of the generator's looped capture. Returns
    the numbers and the counts they were taken from."""
    ref.prepare(judged.keys())
    n_ref = n_prog = miss = extra = rep_n = rep_diff = n_tied = 0
    gap = 0.0
    for key in sorted(judged):
        msgs, reps = judged[key]
        want = dict(_split(m) for m in ref.messages(*key))
        got = dict(_split(m) for m in msgs)
        ties = ref.tied(*key)
        n_ref += len(want)
        n_prog += len(got)
        n_tied += sum(1 for k in got if _stamp(k) in ties)
        miss += sum(1 for k in want if k not in got and _stamp(k) not in ties)
        extra += sum(1 for k in got if k not in want and _stamp(k) not in ties)
        for k, lv in got.items():
            if k in want:
                gap = max(gap, abs(lv - want[k]))
        for m, fields in reps or ():
            rep_n += 1
            rep_diff += _report_differs(m, fields)
    t_miss = t_inj = t_miss_all = t_inj_all = 0
    if truth is not None:
        t_miss, t_inj, t_miss_all, t_inj_all = truth_missed(
            judged, truth, ref.cfg.block_size, ref.q, ref.cfg.channel_rate,
            ref.resolvable)
    return {"diff_share": (miss + extra) / max(n_ref, 1),
            "dbfs_gap_db": round(gap, 6),
            "report_diff_share": rep_diff / max(rep_n, 1),
            "counts": {"blocks": len(judged), "reference_msgs": n_ref,
                       "program_msgs": n_prog, "program_msgs_tied": n_tied,
                       "missed": miss,
                       "extra": extra, "reports": rep_n,
                       "reports_differing": rep_diff,
                       "injected": t_inj, "injected_missed": t_miss,
                       "injected_any_phase": t_inj_all,
                       "injected_any_phase_missed": t_miss_all}}


def check(numbers: dict, limits: dict, undelivered: int) -> Dict[str, dict]:
    """{name: {"value", "limit"}} of every compared number, in order."""
    out = {n: {"value": numbers[n], "limit": limits[n]} for n in NUMBERS}
    out["undelivered"] = {"value": undelivered, "limit": 0}
    return out


def passed(chk: Dict[str, dict]) -> bool:
    return all(v["value"] <= v["limit"] for v in chk.values())


def control_judged(ref_control, blocks: List[Tuple[int, int]]):
    """The control's outputs in the program's place: each block's messages
    from the control reference (its reports are not the control's to
    make: none)."""
    ref_control.prepare(blocks)
    return {key: (ref_control.messages(*key), None) for key in blocks}
