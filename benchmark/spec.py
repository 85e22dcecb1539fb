"""What a cell is, found by name: its entry in BENCHMARK.json, its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`) and the readers of its per-layer metrics
(`metrics/<metric>.py`, each with `read(ctx)`). A later cell, mix,
configuration or metric is a new file and a new entry; nothing here names
one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    here: str = HERE

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def bench_path(root: str) -> str:
    return os.path.join(root, "BENCHMARK.json")


def load_cell(name: str, root: str, here: str = HERE) -> Cell:
    """The cell `name` of the BENCHMARK.json in `root`, with its files
    from the benchmark's folder `here`."""
    bench = _load(bench_path(root))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    config = _load(os.path.join(here, "configs", f"{w['config']}.json"))
    traffic = _load(os.path.join(here, "traffic", f"{w['traffic']}.json"))

    def mine(m):
        return name in m.get("workloads", [name])
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    moves = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if mine(m) and ("workloads" in m or m["moves"] in moves)]
    return Cell(name, w, config, traffic, e2e, layers, here)


def reader(metric: str, here: str = HERE) -> Callable:
    """`read(ctx)` of metrics/<metric>.py, loaded by its path (a metric's
    name may hold dots)."""
    path = os.path.join(here, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(cell: Cell, ctx) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of the cell's per-layer metrics whose
    reader found something to read."""
    out = {}
    for m in cell.per_layer:
        v = reader(m["name"], cell.here)(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


@dataclasses.dataclass
class ReadContext:
    """What a per-layer reader reads: the traced window's `trace`
    (`tracing.Trace`), the sink's spans [(start, end, messages)] on the
    host's monotonic clock and the traced window on that clock
    (`trace_mono`), the cell's files, the rows each device call carries,
    and, for a cell with a resampler, the names of the kernels one call of
    the resampler alone launched at set-up, in order."""

    trace: object
    sink_spans: list
    trace_mono: tuple
    config: dict
    traffic: dict
    rows_per_call: int
    resampler_kernels: list = dataclasses.field(default_factory=list)
