"""The Hopper count (`airmodes_torch.kernels.opcount`): the per-sample f32
instruction counts of the detect kernels and the bound that chip_smoke's
kernels line reports. The counterpart of the reference's TPU op count
(`airmodes/kernels/opcount.py`) counts another machine, so the two are not
compared; these are the counts' own values."""

import os
import sys

import pytest

from airmodes_torch.kernels import opcount

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("sps,half,b1,b34,b5p,b6", [
    (1, 2, 44, 42, 31, 42),       # 2 Msps, nms_chips 2
    (2, 4, 50, 48, 33, 49),       # 4 Msps
    (10, 20, 90, 88, 41, 89)])    # 20 Msps (B6 only)
def test_instructions_per_sample(sps, half, b1, b34, b5p, b6):
    assert opcount.b1_ops_per_sample(sps, half) == b1
    assert opcount.b34_ops_per_sample(sps, half) == b34
    assert opcount.b5p_ops_per_sample(sps) == b5p
    assert opcount.b6_ops_per_sample(sps, half) == b6
    # the earlier yardstick counted an FMA as two operations
    assert opcount.b1_ops_parent(sps, half) == b1 + 2
    assert opcount.B2_OPS_PER_WINDOW_SAMPLE == 5


def test_bound_takes_the_binding_rate():
    assert opcount.PEAK_BYTES_S == 3.35e12
    assert opcount.PEAK_F32_INSTR_S == 33.5e12
    assert opcount.bound(3.35e9, 1.0) == (1.0, "bytes")
    assert opcount.bound(1.0, 33.5e9) == (1.0, "operations")
    ms, by = opcount.bound(3.35e9, 67e9)
    assert by == "operations" and ms == pytest.approx(2.0)


def test_chip_smoke_takes_the_counts_from_the_port():
    """chip_smoke no longer keeps its own copy of the counts."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    for name in ("b1_ops_per_sample", "b1_ops_parent", "b34_ops_per_sample",
                 "b5p_ops_per_sample", "b6_ops_per_sample", "PEAK_BYTES_S",
                 "PEAK_F32_INSTR_S"):
        assert not hasattr(chip_smoke, name), name
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        assert "from airmodes_torch.kernels.opcount import" in f.read()
