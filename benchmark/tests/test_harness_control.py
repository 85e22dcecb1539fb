"""`correct` at a size the CPU holds: sound runs of each cell pass; the
control (the reference in the program's place, with int4 samples) fails;
and a run whose timed path is broken underneath fails, for each fault the
cells can have: half of each batch left out, an answer altered where it is
produced. (One chip: no exchange between chips to leave out; no training
state to leave unchanged.)"""

import pytest
import torch

from conftest import small_cell
from benchmark import judge, run, traffic
from benchmark.reference import Reference

CELLS = ["int8_2msps.replay_1ch", "fused_10to2.replay_1ch",
         "int8_2msps.live_16ch", "int8_2msps.replay_16ch"]
SIZE = {"int8_2msps.live_16ch": {"channels": 3, "chunk_samples": 4096},
        "int8_2msps.replay_16ch": {"channels": 3}}


def _cell(name):
    return small_cell(name, msg_rate_hz=1500.0, **SIZE.get(name, {}))


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name, fused_on_cpu, quiet):
    r = run.run(_cell(name), 2 ** 33 + 1, 1.5, False, device="cpu",
                log=quiet)
    assert r["correct"], (r["check"]["undelivered"], r["attempted"])
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("name", ["int8_2msps.replay_1ch",
                                  "fused_10to2.replay_1ch"])
def test_the_control_is_not_correct(name):
    cell = _cell(name)
    caps = [c.data for c in traffic.build(cell.config, cell.traffic, 42)]
    ref = Reference(cell.config, caps, "cpu")
    ctl = Reference(cell.config, caps, "cpu", levels=7)
    blocks = [(0, b) for b in range(ref.period, 2 * ref.period)]
    nums = judge.judge(judge.control_judged(ctl, blocks), ref)
    chk = judge.check(nums, cell.config["limits"], 0)
    assert not judge.passed(chk), chk


def _half_batch(monkeypatch, name):
    """Every device step sees the second half of its rows as silence."""
    if name.startswith("fused"):
        import airmodes_torch.io.stream as mod
        attr = "resample_demod_packed_planar_jit"
    else:
        import airmodes_torch.io.native_stream as mod
        attr = "demod_batch_packed_planar_jit"
    real = getattr(mod, attr)

    def broken(x, *a, **k):
        x = torch.as_tensor(x).clone()
        x[x.shape[0] // 2:] = 0
        if a and not name.startswith("fused"):
            y = torch.as_tensor(a[0]).clone()
            y[y.shape[0] // 2:] = 0
            a = (y,) + a[1:]
        return real(x, *a, **k)
    monkeypatch.setattr(mod, attr, broken)


def _altered_answer(monkeypatch, name):
    """One message of each block altered where the table becomes
    messages: a bit of its frame flipped."""
    import airmodes_torch.dsp.host as host
    real = host.table_to_messages

    def broken(*a, **k):
        msgs = real(*a, **k)
        if msgs:
            f = msgs[0].split()
            f[1] = f"{int(f[1], 16) ^ 1:0{len(f[1])}x}"
            msgs[0] = " ".join(f)
        return msgs
    monkeypatch.setattr(host, "table_to_messages", broken)


@pytest.mark.parametrize("fault", [_half_batch, _altered_answer],
                         ids=["half_batch", "altered_answer"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch,
                                            fused_on_cpu, quiet):
    fault(monkeypatch, name)
    cell = _cell(name)
    if name == "int8_2msps.replay_1ch" and fault is _half_batch:
        # the CPU picks batch 1, where half a batch is no row: use 4
        cell.config["modes_rx"] = cell.config["modes_rx"] + ["--batch", "4"]
    if name == "fused_10to2.replay_1ch" and fault is _half_batch:
        cell.config["modes_rx"] = cell.config["modes_rx"] + ["--batch", "4"]
    r = run.run(cell, 2 ** 33 + 2, 1.5, False, device="cpu", log=quiet)
    assert not r["correct"], r["check"]


def test_a_sound_run_with_the_database_in_a_file(monkeypatch, quiet):
    """`sqlite_db` "file": the sink writes a database file under TMPDIR."""
    import sqlite3
    from benchmark import sut
    seen = []
    real = sut.Sink.close

    def close(self):
        real(self)
        seen.append(sqlite3.connect(self.db).execute(
            "select count(*) from aircraft").fetchone()[0])
    monkeypatch.setattr(sut.Sink, "close", close)
    cell = _cell("int8_2msps.replay_1ch")
    cell.config["sqlite_db"] = "file"
    r = run.run(cell, 2 ** 33 + 5, 1.5, False, device="cpu", log=quiet)
    assert r["correct"] and r["attempted"] > 0
    assert seen and seen[0] > 0
