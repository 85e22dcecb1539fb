"""On a card: one short run of each cell through the benchmark's command,
whose last line is the result's JSON object with `correct` true.
Skips where there is no card.

    python -m pytest benchmark/tests/test_harness_card.py -q   # on the card
"""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = ["int8_2msps.replay_1ch", "fused_10to2.replay_1ch",
         "int8_2msps.live_16ch", "int8_2msps.replay_16ch"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(card, name):
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "2147483659", "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=340)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert "setup_s" in r["metrics"]
    assert list(r)[-1] == "check"
