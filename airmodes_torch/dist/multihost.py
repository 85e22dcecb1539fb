"""Multi-process streaming pipeline on `torch.distributed`.

The counterpart of `airmodes/dist/multihost.py`. The reference's
cross-machine story is `jax.distributed` for the control plane and one
("channel", "time") mesh over every host's devices; here it is a
`torch.distributed` process group (NCCL between cards, gloo on the CPU) and
the mesh of `dist.sharded`, one rank per device. Each rank ships its own
shards of every step, runs the step on its device, and converts only the
tables of the shards it owns to wire messages, so the fan-out stays local
to the rank and free of duplicates.

    python -m airmodes_torch.dist.multihost [--device cpu]

sweeps the local mesh (one process) and prints one JSON line per mesh.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DspConfig
from ..dsp import host as host_mod
from ..dsp.pipeline import iq_to_device_layout, resolve_device
from . import sharded


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda") -> None:
    """Join the process group the pipelines run over
    (`torch.distributed.init_process_group`), with NCCL when `device` is a
    card (default; without one it raises) and gloo on the CPU.

    With explicit arguments: num_processes <= 1 does nothing; otherwise
    the group meets at the `host:port` coordinator over a tcp:// store,
    this process being rank process_id. With no arguments it configures
    itself from the standard torch launcher environment (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE; LOCAL_RANK picks the card), which
    stands in for JAX's environment auto-configuration; a world of one
    process, or no launcher environment, does nothing. The reference's
    Cloud TPU metadata branch has no counterpart: no launcher of a GPU
    machine coordinates through TPU metadata."""
    import torch.distributed as dist
    dev = resolve_device(device)
    env = os.environ
    if num_processes is None:
        if not (coordinator_address or env.get("MASTER_ADDR")):
            return
        num_processes = int(env.get("WORLD_SIZE", "1"))
        if process_id is None:
            process_id = int(env.get("RANK", "0"))
    if num_processes <= 1:
        return
    if dev.type == "cuda" and dev.index is None:
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(_backend(dev), init_method=init,
                            world_size=num_processes, rank=process_id)


@dataclasses.dataclass
class PodPipeline:
    """Streaming multi-shard demod over a mesh spanning the ranks of the
    process group (one process: every shard on one device).

    planar=None selects the planar int8 path (kernels B1 and B2; 8x less
    halo traffic than f32) when the device is a card and the planar
    kernels take the config, else the f32 path (full-block `demod_block`).
    gain is the int8 quantization gain applied to complex chunks in planar
    run_stream; reported dBFS stays referenced to the float full scale.
    The mesh spans the default process group when torch.distributed is
    initialized (`initialize`), else this one process."""

    cfg: DspConfig
    n_channel: int = 1
    n_time: Optional[int] = None
    planar: Optional[bool] = None
    gain: float = 120.0
    device: object = "cuda"

    def __post_init__(self):
        import torch.distributed as dist
        from ..kernels.preamble import default_tile, supported_planar_tile
        dev = resolve_device(self.device)
        group = dist.group.WORLD if dist.is_initialized() else None
        if self.n_time is None:
            world = 1 if group is None else dist.get_world_size(group)
            self.n_time = max(world // self.n_channel, 1)
        if self.n_time * self.cfg.block_size >= (1 << 31):
            # detection indices are step-global int32 on the wire
            # (pack_table): past 2^31 samples/step they wrap negative and
            # frames silently vanish. Shard such workloads over "channel"
            # instead (indices stay per-channel-step).
            raise ValueError(
                f"samples_per_step {self.n_time * self.cfg.block_size} "
                ">= 2^31 overflows the int32 detection index; use more "
                "channel shards / smaller blocks")
        self.mesh = sharded.make_mesh(self.n_channel, self.n_time, group,
                                      dev)
        if self.planar is None:
            # the kernels' own gate, as the reference asks its kernels
            self.planar = (dev.type == "cuda"
                           and supported_planar_tile(self.cfg) is not None)
        cfg, mesh = self.cfg, self.mesh
        left, right = cfg.left_halo, cfg.right_halo
        # each step: the sharded step's host front, then its compiled
        # local step with the packing inside (one captured graph on a
        # card), so the whole step comes back as ONE (C_loc, T_loc, K+1,
        # 9) int32 fetch. step3_fn slices the step context from the
        # neighbouring steps' inputs, already on the device (transfers
        # where a channel row spans ranks), outside the graph: a replay
        # copies one step's input and two halo-sized contexts.
        if self.planar:
            tile = default_tile(cfg)

            def step_fn(xi, xq, li, lq, ri, rq):
                return sharded._planar_local(
                    *sharded._planar_front(mesh, cfg, xi, xq, (li, lq),
                                           (ri, rq)),
                    mesh=mesh, cfg=cfg, tile=tile, pack=True,
                    device=mesh.device)

            def step3_fn(pi, pq, ci, cq, ni, nq):
                (li, lq), (ri, rq) = sharded._stream_edges(
                    mesh, (pi, pq), (ni, nq), left, right)
                return step_fn(ci, cq, li, lq, ri, rq)
        else:
            def step_fn(x, lctx, rctx):
                return sharded._f32_local(
                    *sharded._f32_front(mesh, cfg, x, lctx, rctx),
                    mesh=mesh, cfg=cfg, pack=True, device=mesh.device)

            def step3_fn(pv, cur, nx):
                (lctx,), (rctx,) = sharded._stream_edges(mesh, (pv,), (nx,),
                                                         left, right)
                return step_fn(cur, lctx, rctx)

        self.step_fn = step_fn
        self.step3_fn = step3_fn
        self.samples_per_step = self.n_time * self.cfg.block_size

    def _emit(self, packed: torch.Tensor, step_start_sample: int,
              epoch: float, stats, full_scale: float = 1.0) -> List[str]:
        """Wire messages of this rank's own shards, from the step's ONE
        fetch, sorted by time."""
        from ..dsp.pipeline import unpack_table
        arr = packed.cpu().numpy()
        msgs: List[str] = []
        for c in range(arr.shape[0]):
            for t in range(arr.shape[1]):
                msgs.extend(host_mod.table_to_messages(
                    unpack_table(arr[c, t]), step_start_sample,
                    self.cfg.channel_rate, epoch=epoch, stats=stats,
                    full_scale=full_scale))
        return sorted(msgs, key=lambda m: float(m.split()[5]))

    def run_step(self, iq_step: np.ndarray, step_start_sample: int,
                 epoch: float = 0.0,
                 stats: Optional[host_mod.BlockStats] = None,
                 lctx: Optional[np.ndarray] = None,
                 rctx: Optional[np.ndarray] = None) -> List[str]:
        """One step over (n_channel, n_time*block, 2) float32 input (the
        same full array on every rank).

        lctx/rctx: (n_channel, left_halo/right_halo, 2) stream context
        around the step (zeros = stream edge). Returns the wire messages
        of this rank's shards, indices globalized with step_start_sample.
        """
        if self.planar:
            raise ValueError("planar pipeline: use run_step_planar "
                             "or run_stream")
        x = iq_to_device_layout(iq_step)
        if lctx is None:
            lctx = np.zeros((self.n_channel, self.cfg.left_halo, 2),
                            np.float32)
        if rctx is None:
            rctx = np.zeros((self.n_channel, self.cfg.right_halo, 2),
                            np.float32)
        packed = self.step_fn(sharded.shard_input(x, self.mesh), lctx, rctx)
        return self._emit(packed, step_start_sample, epoch, stats)

    def run_step_planar(self, xi: np.ndarray, xq: np.ndarray,
                        step_start_sample: int, epoch: float = 0.0,
                        stats: Optional[host_mod.BlockStats] = None,
                        lctx=None, rctx=None,
                        full_scale: float = 1.0) -> List[str]:
        """One step over planar (n_channel, n_time*block) int8 I/Q.

        lctx/rctx: ((C, left_halo), (C, left_halo)) / ((C, right_halo),
        (C, right_halo)) int8 planar (I, Q) context pairs around the step
        (None = stream edge, zeros). full_scale rescales reported dBFS to
        the pre-quantization float full scale (gain/127 for a host
        quantizer with gain)."""
        if not self.planar:
            raise ValueError("f32 pipeline: use run_step or run_stream")
        if lctx is None:
            z = np.zeros((self.n_channel, self.cfg.left_halo), np.int8)
            lctx = (z, z)
        if rctx is None:
            z = np.zeros((self.n_channel, self.cfg.right_halo), np.int8)
            rctx = (z, z)
        di, dq = sharded.shard_input_planar(xi, xq, self.mesh)
        packed = self.step_fn(di, dq, lctx[0], lctx[1], rctx[0], rctx[1])
        return self._emit(packed, step_start_sample, epoch, stats,
                          full_scale=full_scale)

    def run_stream(self, chunks: Iterable[np.ndarray], epoch: float = 0.0,
                   stats: Optional[host_mod.BlockStats] = None,
                   depth: int = 2) -> Iterable[List[str]]:
        """Drive a (n_channel, N) complex64 chunk iterator through steps
        (every rank iterates the same chunks).

        Each step's input ships to the device exactly ONCE; the step slices
        its left context from the PREVIOUS step's (still on the device)
        input and its right context from the NEXT step's. One device zeros
        step serves both true stream edges, so a frame straddling two
        consecutive steps decodes exactly once (owned by the step holding
        its preamble start) and a tail of any length drains zero-padded
        only past the stream end. In planar mode chunks are quantized to
        int8 with self.gain before shipping.

        Step n dispatches once step n+1's input is buffered (one step of
        look-ahead: this is a throughput path; the live low-latency path
        is io.native_stream), and `depth` dispatched steps stay in flight
        before the oldest one's fetch."""
        from collections import deque
        S = self.samples_per_step
        # chunk buffer as a LIST of arrays, copied once per step:
        # concatenating onto a growing array is O(buffered) per chunk
        parts: List[np.ndarray] = []
        buffered = 0

        def take_step():
            """Pop exactly S samples (zero-padded past stream end)."""
            nonlocal parts, buffered
            have = min(buffered, S)
            out = np.zeros((self.n_channel, S), np.complex64)
            pos = 0
            while pos < have:
                p = parts[0]
                n = min(p.shape[1], have - pos)
                out[:, pos: pos + n] = p[:, :n]
                if n == p.shape[1]:
                    parts.pop(0)
                else:
                    parts[0] = p[:, n:]
                pos += n
            buffered -= have
            return out

        if self.planar:
            # one fused native pass when the C++ runtime builds, else the
            # numpy quantizer: the same round-half-even + clip, bit for bit
            from ..io.native_stream import native_available
            if native_available():
                from ..native import quantize_planar_i8 as _q

                def conv(x):
                    return _q(x, self.gain)
            else:
                def conv(x):
                    return host_mod.quantize_planar_i8_np(x, self.gain)

            def ship(step):
                return sharded.shard_input_planar(step[0], step[1],
                                                  self.mesh)

            def dispatch(pv, cu, nx):
                return self.step3_fn(pv[0], pv[1], cu[0], cu[1],
                                     nx[0], nx[1])
        else:
            conv = iq_to_device_layout   # zero-copy (..., 2) f32 view

            def ship(step):
                return sharded.shard_input(step, self.mesh)

            dispatch = self.step3_fn

        full_scale = (self.gain / 127.0) if self.planar else 1.0
        zeros = ship(conv(np.zeros((self.n_channel, S), np.complex64)))
        prev = zeros                      # device tail provider for step 0
        cur = None                        # (shipped device step, start)
        start = 0
        done = False
        chunks = iter(chunks)
        inflight: deque = deque()
        while True:
            while not done and buffered < S:
                try:
                    c = np.ascontiguousarray(next(chunks))
                except StopIteration:
                    done = True
                    break
                if c.shape[0] != self.n_channel:
                    # numpy would BROADCAST a (1, N) chunk across all
                    # channels in take_step: every frame decoded
                    # n_channel times with plausible provenance
                    raise ValueError(
                        f"run_stream chunk has {c.shape[0]} channels; "
                        f"pipeline was built with n_channel="
                        f"{self.n_channel}")
                parts.append(c)
                buffered += c.shape[1]
            if buffered == 0:
                break
            dev = ship(conv(take_step()))   # zero-pads only at EOF
            if cur is not None:           # step k runs once k+1 is shipped
                inflight.append((dispatch(prev, cur[0], dev), cur[1]))
                prev = cur[0]
            cur = (dev, start)
            start += S
            if len(inflight) >= max(depth, 1):
                packed, st = inflight.popleft()
                yield self._emit(packed, st, epoch, stats,
                                 full_scale=full_scale)
        if cur is not None:               # last step: silence to the right
            inflight.append((dispatch(prev, cur[0], zeros), cur[1]))
        while inflight:
            packed, st = inflight.popleft()
            yield self._emit(packed, st, epoch, stats,
                             full_scale=full_scale)


def ici_scaling_model(cfg: DspConfig, device_msps: float,
                      ici_bytes_per_s: float, hop_latency_s: float,
                      planar: bool = True) -> dict:
    """Analytic weak-scaling efficiency of time-sharding (the reference's
    model, under its name). Per step each shard exchanges its halo with
    both ring neighbours: overlap is CONSTANT per device while compute
    scales with the block, so efficiency does not depend on the device
    count:

        eff = t_compute / (t_compute + t_halo)
        t_halo = halo_bytes / link_bandwidth + n_msgs * hop_latency
        n_msgs = 4 planar (I and Q exchange separately, both directions)
                 2 interleaved f32

    The link bandwidth (bytes/s) and the hop latency (s) are required:
    the reference's defaults describe TPU links, and no TPU figure
    applies to a GPU's links. Returns the terms so callers can re-derive
    them with their own hardware numbers."""
    bytes_per_sample = 2 if planar else 8      # I+Q int8 vs (N, 2) f32
    halo_samples = cfg.left_halo + cfg.right_halo
    halo_bytes = halo_samples * bytes_per_sample
    n_msgs = 4 if planar else 2
    t_halo = halo_bytes / ici_bytes_per_s + n_msgs * hop_latency_s
    t_compute = cfg.block_size / (device_msps * 1e6)
    eff = t_compute / (t_compute + t_halo)
    return {"halo_bytes": halo_bytes, "t_halo_s": t_halo,
            "t_compute_s": t_compute, "efficiency": eff,
            "meets_target": eff >= 0.8}


def scaling_report(cfg: DspConfig, meshes: Sequence[Tuple[int, int]],
                   n_steps: int = 4, seed: int = 0,
                   baseline: Optional[dict] = None,
                   device="cuda") -> List[dict]:
    """Samples/s of the f32 step over several mesh shapes on `device`
    (host clock; each step ends in its table's fetch).

    Each entry carries `efficiency` relative to `baseline` (an earlier
    run's entry) or else to the first mesh of this sweep, per shard."""
    import time
    from ..testing import encoder
    out = []
    for n_ch, n_t in meshes:
        pipe = PodPipeline(cfg, n_channel=n_ch, n_time=n_t, planar=False,
                           device=device)
        total = pipe.samples_per_step
        frames = encoder.random_df17_frames(16, seed=seed)
        iq, _ = encoder.make_capture(frames, snr_db=18.0,
                                     spacing=total // 20, seed=seed,
                                     total_samples=total)
        step = np.stack([np.stack([iq.real, iq.imag], -1)] * n_ch
                        ).astype(np.float32)
        pipe.run_step(step, 0)  # warm-up
        t0 = time.time()
        for _ in range(n_steps):
            pipe.run_step(step, 0)
        dt = (time.time() - t0) / n_steps
        n_shards = n_ch * n_t
        rate = n_ch * total / dt
        entry = {"mesh": (n_ch, n_t), "devices": n_shards,
                 "samples_per_s": rate, "per_device": rate / n_shards}
        ref = baseline or (out[0] if out else entry)
        entry["efficiency"] = entry["per_device"] / ref["per_device"]
        out.append(entry)
    return out


if __name__ == "__main__":
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(prog="python -m airmodes_torch.dist."
                                 "multihost")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    torch_dev = resolve_device(args.device)
    meshes = [(1, 1), (1, 2), (1, 4), (1, 8), (2, 4)]
    cfg = DspConfig(block_size=1 << 16, max_detections=64)
    print(json.dumps({"device": str(torch_dev), "name":
                      torch.cuda.get_device_name(torch_dev)
                      if torch_dev.type == "cuda" else "cpu"}))
    for row in scaling_report(cfg, meshes, n_steps=3, device=torch_dev):
        print(json.dumps(row))
    sys.exit(0)
