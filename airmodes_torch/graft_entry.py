"""Entry points: the single-card compiled step and the multi-shard dry run.

The counterpart of the repository's `__graft_entry__.py`:

- `entry(device)` returns `(fn, (iq,))`: the full Mode S demod program on
  one IQ block, as the compiled step (`dsp.pipeline.demod_block_jit`, one
  captured CUDA graph on a card), with its example block;
- `dryrun_multichip(n_devices, device)` factors n_devices into a
  ("channel", "time") mesh and runs every sharded step of `dist.sharded`
  once on it (the f32 step, the planar int8 step and its stream-context
  form, the fused resample + demod step, f32 and planar), then two steps
  of `dist.multihost.PodPipeline` on the f32 and on the planar path, and
  checks their shapes.

    python -m airmodes_torch.graft_entry [--device cuda|cpu]

runs `entry()`'s step, prints its table's shapes (and on a card the step's
time beside the card's name and power limit), then
`dryrun_multichip(torch.cuda.device_count())` (one device on the CPU):
its n shards all on the first card, in this one process (spreading them
over the cards needs NCCL between them, not yet ported). Every entry point defaults to the card and raises without one; nothing
falls back to the CPU.

A mesh of `dist.sharded` with no process group is owned by this one
process, every shard on its one device, as the reference's one-process
mesh runs on its (virtual) devices: `dryrun_multichip(8)` runs the (1, 8)
mesh on one card. Inside an initialized group (`multihost.initialize`)
each rank owns its run of shards. The reference's start-up switches (its
`XLA_FLAGS` / `jax_platforms` block, which pins JAX to its virtual CPU
devices) and its Pallas `interpret=True` have no counterpart: the device is
the `device` argument, and the kernels' plain versions run where the
tensors lie on the CPU (kernels B1 and B2 on a card).

With GRAFT_MULTIPROCESS=1 in the environment `dryrun_multichip(n,
device="cpu")` also starts two worker processes (`python -m
airmodes_torch.graft_entry --worker <host:port> 2 <rank>`) that join a gloo group on the CPU, stream
one capture through `PodPipeline` over a (1, 8) mesh, four shards each,
and print the messages of their own shards; no message may appear twice,
and the union must hold every injected frame. The workers are CPU
processes on purpose, as the reference's are: two NCCL ranks cannot
share one card. So the check is a CPU mode: asked for with a card, the
dry run raises, and a worker refuses `--device cuda`.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import socket
import subprocess
import sys
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import DspConfig
from .dist import multihost, sharded
from .dsp.pipeline import DetectionTable, demod_block_jit, resolve_device
from .kernels.preamble import LAUNCH_COUNTERS

MP_PROCS = 2                 # worker processes of the multi-process check
MP_TIMEOUT_S = 240           # each worker's time limit


def _tiny_cfg(block_size=4096, max_detections=16):
    return DspConfig(block_size=block_size, max_detections=max_detections,
                     noise_window=64)


def entry(device="cuda"):
    """The single-device compiled step and its example arguments:
    `(fn, (iq,))`, fn(iq) -> DetectionTable on `device`."""
    dev = resolve_device(device)
    cfg = _tiny_cfg(block_size=1 << 15, max_detections=32)
    n = cfg.left_halo + cfg.block_size + cfg.right_halo
    rng = np.random.default_rng(0)
    iq = (rng.standard_normal((n, 2)) * 0.05).astype(np.float32)

    fn = functools.partial(demod_block_jit, cfg=cfg, device=dev)
    return fn, (iq,)


class DryrunStep(NamedTuple):
    """One step of the dry run: its host inputs as the step took them, its
    outputs on the host (a DetectionTable of this rank's shards, or the
    message lists of run_stream's steps) and the hand-kernel launches it
    made (deltas of the counters of `kernels.preamble.LAUNCH_COUNTERS`, by
    wrapper and by route: "slice_windows" is B2, "B1" is B1)."""

    name: str
    cfg: DspConfig
    inputs: tuple
    outputs: object
    launches: Dict[str, int]


def _mesh_shape(n_devices: int) -> Tuple[int, int]:
    """n_devices as (n_channel, n_time), time sharded 8, 4 or 2 ways where
    that divides (halo traffic on the time axis)."""
    n_time = next((t for t in (8, 4, 2) if n_devices % t == 0), 1)
    return n_devices // n_time, n_time


def _launch_counts() -> Dict[str, int]:
    return {k: n for d in LAUNCH_COUNTERS for k, n in d.items()}


def _host_table(table) -> DetectionTable:
    return DetectionTable(*(f.cpu().numpy() for f in table))


def _dryrun_steps(n_devices: int, device="cuda") -> List[DryrunStep]:
    """Every step of the dry run, in the reference's order, on random
    inputs drawn from one default_rng(0) in the reference's order and
    shapes. One process owns every shard, or inside an initialized
    default process group each rank its run of them."""
    import torch.distributed as dist
    dev = resolve_device(device)
    group = dist.group.WORLD if dist.is_initialized() else None
    n_channel, n_time = _mesh_shape(n_devices)
    cfg = _tiny_cfg()
    mesh = sharded.make_mesh(n_channel, n_time, group, dev)
    steps: List[DryrunStep] = []

    def run(name, step_cfg, fn, *inputs):
        before = _launch_counts()
        out = fn(*inputs)
        launched = {k: n - before[k] for k, n in _launch_counts().items()}
        if isinstance(out, DetectionTable):
            out = _host_table(out)
        steps.append(DryrunStep(name, step_cfg, inputs, out, launched))

    rng = np.random.default_rng(0)
    total = n_time * cfg.block_size
    iq = (rng.standard_normal((n_channel, total, 2)) * 0.05).astype(np.float32)
    fn = sharded.make_sharded_demod(mesh, cfg)
    run("make_sharded_demod", cfg,
        lambda x: fn(sharded.shard_input(x, mesh)), iq)

    # the planar int8 step needs the planar noise_window=128 geometry
    pcfg = DspConfig(block_size=4096, max_detections=16)
    xi = (rng.standard_normal((n_channel, total)) * 6).astype(np.int8)
    xq = (rng.standard_normal((n_channel, total)) * 6).astype(np.int8)
    fnp = sharded.make_sharded_demod_planar(mesh, pcfg)
    run("make_sharded_demod_planar", pcfg,
        lambda a, b: fnp(*sharded.shard_input_planar(a, b, mesh)), xi, xq)

    # the planar step with stream context at the step edges (zeros: the
    # stream's own edges), PodPipeline(planar=True)'s step
    zl = np.zeros((n_channel, pcfg.left_halo), np.int8)
    zr = np.zeros((n_channel, pcfg.right_halo), np.int8)
    fnc = sharded.make_sharded_demod_planar_ctx(mesh, pcfg)
    run("make_sharded_demod_planar_ctx", pcfg,
        lambda a, b, li, lq, ri, rq: fnc(
            *sharded.shard_input_planar(a, b, mesh), li, lq, ri, rq),
        xi, xq, zl, zl, zr, zr)

    # the fused resample + demod step from 6 Msps (p/q = 1/3), f32 ...
    p_up, q_dn = 1, 3
    raw_total = n_time * cfg.block_size * q_dn
    iqr = (rng.standard_normal((n_channel, raw_total, 2)) * 0.05
           ).astype(np.float32)
    fnr = sharded.make_sharded_resample_demod(mesh, cfg, p_up, q_dn)
    run("make_sharded_resample_demod", cfg,
        lambda x: fnr(sharded.shard_input(x, mesh)), iqr)
    # ... and planar: (C, 2, N) f32 input, int8 at a fixed gain, planar demod
    raw_p = n_time * pcfg.block_size * q_dn
    iqrp = (rng.standard_normal((n_channel, 2, raw_p)) * 0.05
            ).astype(np.float32)
    fnrp = sharded.make_sharded_resample_demod(mesh, pcfg, p_up, q_dn,
                                               planar=True)
    run("make_sharded_resample_demod(planar=True)", pcfg,
        lambda x, g: fnrp(sharded.shard_input_resample_planar(x, mesh), g),
        iqrp, np.float32(100.0))

    # the streaming pipeline over the same mesh: two steps through
    # run_stream, on the f32 path and on the planar path
    def stream(pipe, chunks):
        return [out for out in pipe.run_stream(iter(chunks))]

    pipe = multihost.PodPipeline(cfg, n_channel=n_channel, n_time=n_time,
                                 planar=False, device=dev)
    S = pipe.samples_per_step
    iqs = (rng.standard_normal(2 * S) * 0.05 +
           1j * rng.standard_normal(2 * S) * 0.05).astype(np.complex64)
    run("PodPipeline.run_stream", cfg, lambda *c: stream(pipe, c),
        np.tile(iqs[None, :S], (n_channel, 1)),
        np.tile(iqs[None, S:], (n_channel, 1)))

    pipe_p = multihost.PodPipeline(pcfg, n_channel=n_channel, n_time=n_time,
                                   planar=True, device=dev)
    Sp = pipe_p.samples_per_step
    iqp = (rng.standard_normal(2 * Sp) * 0.05 +
           1j * rng.standard_normal(2 * Sp) * 0.05).astype(np.complex64)
    run("PodPipeline(planar=True).run_stream", pcfg,
        lambda *c: stream(pipe_p, c),
        np.tile(iqp[None, :Sp], (n_channel, 1)),
        np.tile(iqp[None, Sp:], (n_channel, 1)))
    return steps


def dryrun_multichip(n_devices: int, device="cuda") -> List[DryrunStep]:
    """One run of every sharded step on an n_devices mesh (tiny shapes):
    checks each table's shape (this rank's shards) and each stream's step
    count, prints the reference's summary line, and with
    GRAFT_MULTIPROCESS=1 runs the multi-process check, whose workers are
    CPU processes (gloo): it asks for device="cpu" and refuses the card.
    Returns the steps."""
    multiprocess = bool(os.environ.get("GRAFT_MULTIPROCESS"))
    if multiprocess and torch.device(device).type != "cpu":
        raise ValueError("GRAFT_MULTIPROCESS=1 runs CPU worker processes on "
                         "gloo (two NCCL ranks cannot share one card): "
                         "pass device='cpu'")
    steps = _dryrun_steps(n_devices, device)
    n_channel, n_time = _mesh_shape(n_devices)
    shapes = {}
    for s in steps:
        if isinstance(s.outputs, DetectionTable):
            shape = s.outputs.index.shape
            assert shape[2:] == (s.cfg.max_detections,), (s.name, shape)
            shapes[s.name] = shape
        else:
            assert len(s.outputs) == 2, (s.name, len(s.outputs))
    local = {shape[:2] for shape in shapes.values()}
    assert len(local) == 1, local
    if not torch.distributed.is_initialized():
        assert local == {(n_channel, n_time)}, local
    print(f"dryrun_multichip OK: mesh=({n_channel} channel x {n_time} time), "
          f"detections table {shapes['make_sharded_demod']}, planar "
          f"table {shapes['make_sharded_demod_planar']}, fused resample+demod "
          f"table {shapes['make_sharded_resample_demod']} (+ planar fused "
          f"{shapes['make_sharded_resample_demod(planar=True)']}), "
          f"run_stream steps {len(steps[-2].outputs)} f32 + "
          f"{len(steps[-1].outputs)} PLANAR (production pod driver)",
          flush=True)

    if multiprocess:
        per_proc, want = _multiprocess()
        msgs = set()
        for out in per_proc:
            assert not msgs & set(out), "duplicate cross-host emission"
            msgs |= set(out)
        got = {m.split()[1] for m in msgs}
        assert set(want) <= got, set(want) - got
        print(f"dryrun multiprocess OK: {len(per_proc)} procs, "
              f"{len(msgs)} msgs, {len(want)} truth decoded", flush=True)
    return steps


def _free_address() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    return addr


def _multiprocess() -> Tuple[List[List[str]], List[str]]:
    """Start MP_PROCS CPU workers on one gloo group and collect their
    messages. Returns (each worker's messages by rank, the injected
    frames' hexes)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    coord = _free_address()
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "airmodes_torch.graft_entry", "--worker",
         coord, str(MP_PROCS), str(pid)], cwd=repo, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(MP_PROCS)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=MP_TIMEOUT_S)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    outs.sort(key=lambda o: o["pid"])
    return [o["msgs"] for o in outs], outs[0]["want"]


def _worker(coord: str, nproc: int, pid: int) -> int:
    """One CPU worker of the multi-process check: rank `pid` of a gloo
    group of `nproc`, streaming one capture through PodPipeline over a
    (1, 8) mesh; prints one JSON line with the messages of its shards."""
    import torch.distributed as dist
    from .testing import encoder
    torch.set_num_threads(1)
    multihost.initialize(coord, nproc, pid, device="cpu")
    try:
        assert dist.get_world_size() == nproc, dist.get_world_size()
        cfg = DspConfig(block_size=1 << 14, max_detections=32)
        pipe = multihost.PodPipeline(cfg, n_channel=1, n_time=8,
                                     device="cpu")
        assert pipe.mesh.per_rank == 8 // nproc, pipe.mesh.per_rank
        S = pipe.samples_per_step
        frames = encoder.random_df17_frames(10, seed=77)
        # traffic through the step and a tail, so a second (padded) step runs
        iq, truth = encoder.make_capture(frames, snr_db=22.0, spacing=S // 12,
                                         seed=77, total_samples=S + 4321)
        msgs = [m for out in pipe.run_stream([iq[None, :]]) for m in out]
        print(json.dumps({"pid": pid, "msgs": msgs,
                          "want": sorted(t.hex for t in truth)}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m airmodes_torch.graft_entry")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; a worker runs on the "
                         "CPU only")
    ap.add_argument("--worker", nargs=3, metavar=("COORD", "NPROC", "PID"),
                    help="run as a worker of the multi-process check "
                         "(CPU, gloo)")
    args = ap.parse_args(argv)
    if args.worker:
        if args.device not in (None, "cpu"):
            ap.error("--worker runs on the CPU (gloo): --device "
                     f"{args.device} is not supported")
        coord, nproc, pid = args.worker
        return _worker(coord, int(nproc), int(pid))
    dev = resolve_device(args.device or "cuda")
    fn, fargs = entry(dev)
    out = fn(*fargs)
    print("entry OK:", {k: tuple(v.shape)
                        for k, v in out._asdict().items()}, flush=True)
    if dev.type == "cuda":
        from .probes import smi_line, time_ms
        card = time_ms(lambda: fn(*fargs))
        host = time_ms(lambda: fn(*fargs), device_only=False)
        print(f"entry step: {host:.5f} ms as the host sees it, "
              f"{card if card is None else f'{card:.5f}'} ms on the card "
              f"alone [{smi_line()}]", flush=True)
    dryrun_multichip(torch.cuda.device_count() if dev.type == "cuda" else 1,
                     dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
