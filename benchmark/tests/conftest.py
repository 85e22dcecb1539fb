"""Shared set-up of the benchmark's own tests (CPU; the card's test skips
without one). They run from the checkout's root:

    python -m pytest benchmark/tests -q
"""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def small_cell(name, block=1 << 15, blocks=4, **traffic):
    """Cell `name` of BENCHMARK.json at a size the CPU runs in seconds:
    blocks of `block` samples, captures of `blocks` blocks, two blocks of
    warm-up, and any traffic key given."""
    from benchmark import spec
    cell = spec.load_cell(name, ROOT)
    cell.config = copy.deepcopy(cell.config)
    cell.config["modes_rx"] = cell.config["modes_rx"] + [
        "--block-size", str(block)]
    cell.config["dsp"]["block_size"] = block
    cell.traffic = dict(cell.traffic, capture_samples=block * blocks,
                        warmup_blocks=2, **traffic)
    return cell


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """Let modes_rx pick the fused resample path on the CPU (on a card it
    does by itself), so that the fused cell's runner runs here."""
    import airmodes_torch.apps.modes_rx as mr
    monkeypatch.setattr(mr, "_fused_resample_ok", lambda *a: True)


@pytest.fixture
def quiet():
    return lambda line: None
