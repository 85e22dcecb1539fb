"""A cell, a configuration, a traffic mix and a per-layer metric are added
by adding files and entries alone: a copy of the benchmark's folder gains
them, and the harness finds, runs and reads them by name."""

import json
import shutil

from conftest import ROOT, small_cell
from benchmark import run, spec


def test_files_and_entries_alone_add_a_cell(tmp_path, quiet):
    here = tmp_path / "benchmark"
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(f"{ROOT}/benchmark/{d}", here / d)
    bench = json.load(open(f"{ROOT}/BENCHMARK.json"))

    # the new files: a configuration (the int8 one at a small block and a
    # 7 dB threshold), a traffic mix, a metric's reader
    cfg = small_cell("int8_2msps.replay_1ch").config
    cfg["modes_rx"][cfg["modes_rx"].index("5")] = "7"
    cfg["dsp"]["threshold_db"] = 7.0
    (here / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    (here / "traffic" / "dummy_mix.json").write_text(json.dumps({
        "channels": 2, "loop": "closed", "capture_samples": 4 << 15,
        "chunk_samples": 1 << 14, "msg_rate_hz": 300.0, "snr_db": 15.0,
        "warmup_blocks": 2, "trace_seconds": 1.0}))
    (here / "metrics" / "dummy.count.py").write_text(
        "def read(ctx):\n    return float(len(ctx.sink_spans))\n")
    # ... and their entries
    bench["configs"].append({"name": "dummy_cfg", "source": "a test",
                             "file": "benchmark/configs/dummy_cfg.json",
                             "reduced": []})
    bench["workloads"].append({"name": "dummy_cfg.dummy_mix",
                               "config": "dummy_cfg", "traffic": "dummy_mix",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy.count", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "decode and outputs",
                               "moves": "input_msps",
                               "workloads": ["dummy_cfg.dummy_mix"]})
    for m in bench["end_to_end"]:
        if m["name"] == "input_msps":
            m["workloads"].append("dummy_cfg.dummy_mix")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("dummy_cfg.dummy_mix", str(tmp_path), str(here))
    assert cell.config["dsp"]["threshold_db"] == 7.0
    assert cell.traffic["channels"] == 2
    assert [m["name"] for m in cell.end_to_end] == ["input_msps", "setup_s"]
    assert "dummy.count" in [m["name"] for m in cell.per_layer]

    r = run.run(cell, 123, 1.5, False, device="cpu", log=quiet)
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"input_msps", "setup_s"}
    ctx = spec.ReadContext(None, [(0.0, 1.0, 3)] * 4, (0.0, 2.0), cell.config,
                           cell.traffic, 2)
    assert spec.read_metrics(cell, ctx)["dummy.count"]["value"] == 4.0
