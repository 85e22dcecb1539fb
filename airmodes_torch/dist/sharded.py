"""Sharded demod over a ("channel", "time") mesh, in PyTorch.

The counterpart of `airmodes/dist/sharded.py`:

  - axis "channel": data parallelism over SDR channels / capture shards;
  - axis "time":    sequence parallelism over time blocks of one stream,
                    with an overlap-save halo exchange between neighbouring
                    time shards.

Each time shard owns `block` samples; it receives the last `left_halo`
samples of its left neighbour and the first `right_halo` samples of its
right neighbour, zeros at the stream edges and at each channel's first and
last shard. Detections are claimed by the shard that owns the preamble
start sample, so the overlap never duplicates or drops a frame.

The mesh has two layers, because a torch rank holds one device where a JAX
process holds several:

  - ownership: shards are numbered row-major over (channel, time), and rank
    r of W owns the contiguous run [r*n/W, (r+1)*n/W), which must form a
    rectangle of C_loc channels by T_loc time shards;
  - transport: halos between shards of one rank are slices of its stacked
    local tensor; halos between ranks go over
    `torch.distributed.batch_isend_irecv` (NCCL on a card, gloo on the CPU).

One process with no group therefore runs the whole mesh on one device, as
the reference's single-process mesh runs on its (virtual) devices; several
processes behave like its multi-process mesh. Every rank passes the same
full host array to `shard_input*` and copies only its own shards to its
device. The step functions return this rank's tables with leading
`mesh.local_shape` dims (the shards `mesh.local_coords` names): in one
process the whole (C, T, ...) table, as the reference returns. Indices are
global within the step.

The planar steps stack every local shard's padded int8 row into one
(C_loc*T_loc, P) batch and make one `demod_batch_planar` call on it, so
kernels B1 and B2 launch once per step, not once per shard. The f32
steps run the full-block `demod_block` per shard, as the reference does.

Each step is the counterpart of the reference's jitted `shard_map`
program: a host front, then a compiled local step (`_f32_local`,
`_planar_local`, `_resample_local`: one captured CUDA graph per key on a
card, `utils.graphs`). The front stays eager: it copies this rank's shards
of a host array to the device (`_place`, `_ctx`), checks them, and runs the
transfers between ranks (`_edge_exchange`; `batch_isend_irecv` is host
code under gloo and has never been captured under NCCL). The local step
takes this rank's tensors and the received edges, and holds the halo
assembly, the step-edge context, the resampler, the quantize, the demod,
the globalized indices and, for `PodPipeline`, the packed table. Its key
is the mesh, the config and the step's other static arguments, so two
factories built on equal arguments share one graph. Where one rank owns
the mesh, as in every one-process run, no transfer runs and the whole
step is one graph; the fused resample step whose channel rows continue on
other ranks runs two graphs, with the demod halos' transfers between
them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DspConfig
from ..dsp.pipeline import (DetectionTable, demod_block, pack_table,
                            resolve_device)
from ..kernels.preamble import LAUNCH_COUNTERS
from ..utils.graphs import graphed

# message tags of the two halo directions and the two step-edge contexts;
# a stream's index is added, so every message between two ranks has its own
_TAG_TAIL, _TAG_HEAD, _TAG_PREV, _TAG_NEXT = 0, 64, 128, 192


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ("channel", "time") mesh of n_channel x n_time shards over the
    ranks of `group` (None: one process that owns every shard)."""

    n_channel: int
    n_time: int
    group: object
    device: torch.device
    rank: int = 0
    world: int = 1

    @property
    def shape(self) -> dict:
        return {"channel": self.n_channel, "time": self.n_time}

    @property
    def per_rank(self) -> int:
        return self.n_channel * self.n_time // self.world

    @property
    def channels(self) -> range:
        """The channels this rank's shards lie on."""
        lo = self.rank * self.per_rank
        if self.per_rank >= self.n_time:
            return range(lo // self.n_time,
                         (lo + self.per_rank) // self.n_time)
        return range(lo // self.n_time, lo // self.n_time + 1)

    @property
    def times(self) -> range:
        """The time shards this rank owns on each of its channels."""
        if self.per_rank >= self.n_time:
            return range(0, self.n_time)
        t0 = self.rank * self.per_rank % self.n_time
        return range(t0, t0 + self.per_rank)

    @property
    def local_shape(self) -> tuple:
        return len(self.channels), len(self.times)

    @property
    def local_coords(self) -> List[tuple]:
        return [(c, t) for c in self.channels for t in self.times]


def make_mesh(n_channel: int = 1, n_time: int = 1, group=None,
              device="cuda") -> Mesh:
    """Build a ("channel", "time") mesh on `device` (default the card;
    without one it raises). With a process group every rank must build the
    same mesh, and its shards must split evenly: the shard count a multiple
    of the group's size (the reference raises when a mesh needs more
    devices than exist), each rank's run of shards whole channel rows or a
    part of one row."""
    dev = resolve_device(device)
    n = n_channel * n_time
    if n_channel < 1 or n_time < 1:
        raise ValueError(f"mesh {n_channel}x{n_time} has no shards")
    rank, world = 0, 1
    if group is not None:
        import torch.distributed as dist
        rank, world = dist.get_rank(group), dist.get_world_size(group)
    if n % world:
        raise ValueError(f"mesh {n_channel}x{n_time} has {n} shards, not a "
                         f"multiple of the group's {world} ranks")
    per = n // world
    if per % n_time and n_time % per:
        raise ValueError(
            f"mesh {n_channel}x{n_time} over {world} ranks gives each rank "
            f"{per} shards, neither whole channel rows nor an even part of "
            f"one row of {n_time}")
    mesh = Mesh(n_channel, n_time, group, dev, rank, world)
    if group is not None:
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        _check_same_mesh(mesh)
    return mesh


def _check_same_mesh(mesh: Mesh) -> None:
    """Every rank of the group must build the same mesh: a rank with
    another shape would post other transfers and hang the step. One
    all-reduce, which is also the group's first collective (NCCL's batched
    point-to-point calls need one that every rank joins)."""
    import torch.distributed as dist
    shape = torch.tensor([mesh.n_channel, mesh.n_time, -mesh.n_channel,
                          -mesh.n_time], dtype=torch.int64,
                         device=mesh.device)
    dist.all_reduce(shape, op=dist.ReduceOp.MAX, group=mesh.group)
    got = shape.tolist()
    if got != [mesh.n_channel, mesh.n_time, -mesh.n_channel, -mesh.n_time]:
        raise ValueError(f"the ranks built different meshes (largest "
                         f"{got[0]}x{got[1]}, smallest {-got[2]}x{-got[3]})")


def _check_shard_block(n_loc, want: int, what: str = "time"):
    """Per-shard owned length must BE the expected block: a mismatch is
    silent corruption downstream (undersized planar shards zero-pad and
    decode the right halo as owned, oversized f32 shards truncate)."""
    if n_loc != want:
        raise ValueError(
            f"{what} shard owns {n_loc} samples but the expected "
            f"per-shard block is {want}: size the global input as "
            f"n_time * block (and the mesh to match)")


def _check_local(x: torch.Tensor, mesh: Mesh, want: int,
                 what: str = "time", dim: int = 1) -> None:
    """Check this rank's stacked input: (C_loc, ..., T_loc*want, ...)."""
    c_loc, t_loc = mesh.local_shape
    if x.shape[0] != c_loc:
        raise ValueError(f"input holds {x.shape[0]} channels; this rank owns "
                         f"{c_loc} of the mesh's {mesh.n_channel}")
    n, rem = divmod(x.shape[dim], t_loc)
    _check_shard_block(x.shape[dim] / t_loc if rem else n, want, what)


def _place(x, mesh: Mesh, time_dim: int = 1) -> torch.Tensor:
    """Host array -> this rank's shards on the mesh's device.

    Every rank passes the SAME full (C, ..., T, ...) array and copies only
    its own channels and time shards (`_place` of the reference, the
    torch.distributed analog of its make_array_from_callback). A tensor is
    taken as this rank's shards already."""
    if isinstance(x, torch.Tensor):
        return x.to(mesh.device)
    x = np.asarray(x)
    if x.shape[0] != mesh.n_channel:
        raise ValueError(f"input has {x.shape[0]} channels; the mesh has "
                         f"{mesh.n_channel}")
    n, rem = divmod(x.shape[time_dim], mesh.n_time)
    if rem:
        _check_shard_block(x.shape[time_dim] / mesh.n_time, n)
    c, t = mesh.channels, mesh.times
    idx = [slice(c.start, c.stop)] + [slice(None)] * (time_dim - 1) \
        + [slice(t.start * n, t.stop * n)]
    part = np.ascontiguousarray(x[tuple(idx)])
    return torch.from_numpy(part).to(mesh.device, non_blocking=True)


def _ctx(x, mesh: Mesh) -> Optional[torch.Tensor]:
    """Stream context: a host (C, halo, ...) array is sliced to this rank's
    channels; a tensor is this rank's already; None stays None."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(mesh.device)
    c = mesh.channels
    part = np.ascontiguousarray(np.asarray(x)[c.start: c.stop])
    return torch.from_numpy(part).to(mesh.device, non_blocking=True)


def shard_input(iq, mesh: Mesh) -> torch.Tensor:
    """This rank's shards of a host (C, T, 2) float32 array."""
    return _place(iq, mesh, 1)


def shard_input_planar(xi, xq, mesh: Mesh):
    """This rank's shards of host (C, T) int8 planar streams."""
    return _place(xi, mesh, 1), _place(xq, mesh, 1)


def shard_input_resample_planar(iqp, mesh: Mesh) -> torch.Tensor:
    """This rank's shards of a host PLANAR (C, 2, T_raw) f32 array, for
    make_sharded_resample_demod(planar=True)."""
    return _place(iqp, mesh, 2)


def _transfer(mesh: Mesh, plan) -> None:
    """Run one batch of point-to-point transfers and wait for it. plan:
    ("send", tensor, peer, tag) and ("recv", buffer, peer, tag) entries,
    built by every rank in the same order, so the transfers between any
    two ranks pair up (NCCL matches them by order, gloo by tag)."""
    if not plan:
        return
    import torch.distributed as dist
    ops = []
    for kind, t, peer, tag in plan:
        op = dist.isend if kind == "send" else dist.irecv
        ops.append(dist.P2POp(op, t, dist.get_global_rank(mesh.group, peer),
                              mesh.group, tag))
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def _views(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each stream (C_loc, T_loc*N, ...) as (C_loc, T_loc, N, ...)."""
    c_loc, t_loc = mesh.local_shape
    return [x.reshape(c_loc, t_loc, x.shape[1] // t_loc, *x.shape[2:])
            for x in xs]


def _edge_exchange(mesh: Mesh, xs: Sequence[torch.Tensor], left: int,
                   right: int):
    """The halo transfers between ranks, run here, outside any graph.

    xs: streams of this rank's owned samples, each (C_loc, T_loc*N, ...).
    Where one channel row is spread over several ranks, the row's inner
    rank edges cross the group: this rank sends its tail to the next rank
    and its head to the previous one (a rank owning whole rows has no
    such edge, so the halo from one channel's last shard never reaches the
    next's). Returns (lefts, rights), one per stream: the (C_loc, left,
    ...) tail received from the previous rank and the (C_loc, right, ...)
    head from the next, None where this rank holds the row's end. Both
    directions are separate transfers, as the reference's two
    ppermutes."""
    t0, t1 = mesh.times.start, mesh.times.stop
    prev_rank = mesh.rank - 1 if t0 > 0 else None
    next_rank = mesh.rank + 1 if t1 < mesh.n_time else None
    plan = []
    lefts, rights = [None] * len(xs), [None] * len(xs)
    for s, x in enumerate(xs):
        n = x.shape[1]
        if next_rank is not None:       # my tail -> their left halo
            plan.append(("send", x[:, n - left:].contiguous(), next_rank,
                         _TAG_TAIL + s))
        if prev_rank is not None:
            lefts[s] = x.new_empty((x.shape[0], left) + x.shape[2:])
            plan.append(("recv", lefts[s], prev_rank, _TAG_TAIL + s))
        if prev_rank is not None:       # my head -> their right halo
            plan.append(("send", x[:, :right].contiguous(), prev_rank,
                         _TAG_HEAD + s))
        if next_rank is not None:
            rights[s] = x.new_empty((x.shape[0], right) + x.shape[2:])
            plan.append(("recv", rights[s], next_rank, _TAG_HEAD + s))
    _transfer(mesh, plan)
    return lefts, rights


def _assemble(mesh: Mesh, xs: Sequence[torch.Tensor], left: int, right: int,
              lefts: Sequence[Optional[torch.Tensor]],
              rights: Sequence[Optional[torch.Tensor]]) -> List[torch.Tensor]:
    """Each stream as (C_loc, T_loc, L+N+R, ...): the left halo from the
    previous time shard, the right halo from the next, the edges other
    ranks sent (`_edge_exchange`) where given, else zeros at a channel's
    first and last shard (the stream edges)."""
    out = []
    for v, lr, rr in zip(_views(mesh, xs), lefts, rights):
        c_loc, t_loc, n = v.shape[:3]
        lh = v.new_zeros((c_loc, t_loc, left) + v.shape[3:])
        rh = v.new_zeros((c_loc, t_loc, right) + v.shape[3:])
        lh[:, 1:] = v[:, :-1, n - left:]
        rh[:, :-1] = v[:, 1:, :right]
        if lr is not None:
            lh[:, 0] = lr
        if rr is not None:
            rh[:, -1] = rr
        out.append(torch.cat([lh, v, rh], dim=2))
    return out


def _exchange_halos(mesh: Mesh, xs: Sequence[torch.Tensor], left: int,
                    right: int) -> List[torch.Tensor]:
    """Ring halo exchange along "time" within each channel: the transfers
    between ranks, then the assembly. Returns each stream (C_loc,
    T_loc*N, ...) as (C_loc, T_loc, L+N+R, ...), zeros at the stream
    edges."""
    return _assemble(mesh, xs, left, right,
                     *_edge_exchange(mesh, xs, left, right))


def _splice_ctx(mesh: Mesh, padded: torch.Tensor, lctx, rctx, left: int,
                right: int) -> torch.Tensor:
    """The first/last time shards take their outer halo from the stream
    context instead of the ring's zeros. padded: (C_loc, T_loc, L+N+R,
    ...); lctx/rctx: this rank's (C_loc, left/right, ...) context, None
    for none (zeros stay)."""
    if mesh.times.start == 0 and lctx is not None:
        padded[:, 0, :left] = lctx
    if mesh.times.stop == mesh.n_time and rctx is not None:
        padded[:, -1, padded.shape[2] - right:] = rctx
    return padded


def _stream_edges(mesh: Mesh, prevs: Sequence[torch.Tensor],
                  nxts: Sequence[torch.Tensor], left: int, right: int):
    """Stream context of a step from the neighbouring steps' local inputs
    (each (C_loc, T_loc*N, ...), already on the device): the tail of the
    previous step's last time shard, for the shard at t = 0, and the head
    of the next step's first, for the shard at t = n_time - 1. Returns
    (lctxs, rctxs), one per stream, None where this rank owns neither
    edge. Where one channel row spans several ranks, the row's last rank
    sends the tail to its first and the first the head to its last."""
    first = mesh.times.start == 0
    last = mesh.times.stop == mesh.n_time
    if first and last:
        return ([p[:, p.shape[1] - left:] for p in prevs],
                [x[:, :right] for x in nxts])
    t_loc = len(mesh.times)
    row_first = mesh.rank - mesh.times.start // t_loc
    row_last = row_first + mesh.n_time // t_loc - 1
    lctxs, rctxs = [None] * len(prevs), [None] * len(nxts)
    plan = []
    for s, (pv, nx) in enumerate(zip(prevs, nxts)):
        if last:
            plan.append(("send", pv[:, pv.shape[1] - left:].contiguous(),
                         row_first, _TAG_PREV + s))
        if first:
            lctxs[s] = pv.new_empty((pv.shape[0], left) + pv.shape[2:])
            plan.append(("recv", lctxs[s], row_last, _TAG_PREV + s))
            plan.append(("send", nx[:, :right].contiguous(), row_last,
                         _TAG_NEXT + s))
        if last:
            rctxs[s] = nx.new_empty((nx.shape[0], right) + nx.shape[2:])
            plan.append(("recv", rctxs[s], row_first, _TAG_NEXT + s))
    _transfer(mesh, plan)
    return lctxs, rctxs


def _unflatten(table: DetectionTable, shape) -> DetectionTable:
    return DetectionTable(*(f.reshape(*shape, *f.shape[1:]) for f in table))


def _globalize(table: DetectionTable, mesh: Mesh, block: int
               ) -> DetectionTable:
    """Local detection indices -> global sample offsets within the step:
    index + time coordinate x block; -1 stays -1. table: leading
    (C_loc, T_loc)."""
    t = torch.arange(mesh.times.start, mesh.times.stop, dtype=torch.int32,
                     device=table.index.device)
    offset = (t * block)[None, :, None]
    index = torch.where(table.index >= 0, table.index + offset, -1)
    return table._replace(index=index.to(torch.int32))


def _demod_f32(padded: torch.Tensor, mesh: Mesh, cfg: DspConfig
               ) -> DetectionTable:
    """demod_block over every local shard of (C_loc, T_loc, L+N+R, 2)."""
    table = demod_block(padded.reshape(-1, *padded.shape[2:]), cfg)
    return _globalize(_unflatten(table, mesh.local_shape), mesh,
                      cfg.block_size)


def _demod_planar(streams: Sequence[torch.Tensor], mesh: Mesh,
                  cfg: DspConfig, tile: int) -> DetectionTable:
    """One demod_batch_planar call over every local shard: each stream
    (C_loc, T_loc, L+N+R) int8 is zero-padded to the planar length and
    stacked into (C_loc*T_loc, P)."""
    from ..kernels.preamble import demod_batch_planar, planar_length
    p = planar_length(cfg, tile)
    xi, xq = (F.pad(s, (0, p - s.shape[2])).reshape(-1, p) for s in streams)
    table = demod_batch_planar(xi, xq, cfg, tile=tile)
    return _globalize(_unflatten(table, mesh.local_shape), mesh,
                      cfg.block_size)


# --- the local steps: compiled, one captured graph per key on a card ---------

@graphed(static_argnames=("mesh", "cfg", "ablate_halos", "pack"),
         counters=LAUNCH_COUNTERS)
def _f32_local(x, lctx, rctx, lrecv, rrecv, mesh: Mesh, cfg: DspConfig,
               ablate_halos: bool = False, pack: bool = False,
               device="cuda"):
    """This rank's f32 step on its own tensors: x (C_loc, T_loc*N, 2) on
    the mesh's device, the stream context lctx/rctx (C_loc, left/right,
    2) or None (zeros), the edges received from other ranks or None
    (`_edge_exchange`). The halo assembly (or, with ablate_halos, local
    zeros), the context, `demod_block` per shard, the global indices, and
    with pack the packed (C_loc, T_loc, K+1, 9) table."""
    left, right = cfg.left_halo, cfg.right_halo
    if ablate_halos:
        v, = _views(mesh, [x])
        padded = F.pad(v, (0, 0, left, right))
    else:
        padded, = _assemble(mesh, [x], left, right, [lrecv], [rrecv])
    padded = _splice_ctx(mesh, padded, lctx, rctx, left, right)
    table = _demod_f32(padded, mesh, cfg)
    return pack_table(table) if pack else table


@graphed(static_argnames=("mesh", "cfg", "tile", "pack"),
         counters=LAUNCH_COUNTERS)
def _planar_local(xi, xq, li, lq, ri, rq, lhi, lhq, rhi, rhq, mesh: Mesh,
                  cfg: DspConfig, tile: int, pack: bool = False,
                  device="cuda"):
    """This rank's planar int8 step on its own tensors: xi/xq (C_loc,
    T_loc*N), the stream context li/lq, ri/rq (C_loc, left/right) or None,
    the edges received from other ranks lhi/lhq, rhi/rhq or None. The
    halo assembly, the context, one `demod_batch_planar` call (B1 and B2
    on a card), the global indices, and with pack the packed table."""
    left, right = cfg.left_halo, cfg.right_halo
    padded = _assemble(mesh, [xi, xq], left, right, [lhi, lhq], [rhi, rhq])
    streams = [_splice_ctx(mesh, p, lc, rc, left, right)
               for p, lc, rc in zip(padded, (li, lq), (ri, rq))]
    table = _demod_planar(streams, mesh, cfg, tile)
    return pack_table(table) if pack else table


@graphed(static_argnames=("mesh", "cfg", "p", "q", "taps_per_phase",
                          "planar", "tile", "demod"),
         counters=LAUNCH_COUNTERS)
def _resample_local(x, gain, l0, l1, r0, r1, mesh: Mesh, cfg: DspConfig,
                    p: int, q: int, taps_per_phase: int, planar: bool,
                    tile: Optional[int], demod: bool = True, device="cuda"):
    """This rank's fused resample step on its own tensors: the raw-rate
    shards x (C_loc, T_loc*raw_block, 2) f32, or planar (C_loc, 2,
    T_loc*raw_block) with this rank's gain (a scalar or (C_loc,)); the
    128q-sample edges received from other ranks l0/l1, r0/r1 (one per
    stream; None where none). The resample halos, the group matmuls, the
    int8 quantize (planar), then the demod (`_planar_local`,
    `_f32_local`). demod=False stops at the channel-rate streams, (xi,
    xq) int8 or y (C_loc, T_loc*block, 2): the front of a step whose
    rows continue on other ranks, whose demod halos cross ranks between
    two graphs."""
    from ..resample.fused import quantize_i8
    from ..resample.polyphase import resample_groups_halo
    gi = 128 * q
    c_loc, t_loc = mesh.local_shape
    n_loc = c_loc * t_loc
    if planar:
        ri, rq = _assemble(mesh, [x[:, 0], x[:, 1]], gi, gi, [l0, l1],
                           [r0, r1])
        xc = torch.stack([ri, rq], dim=2).reshape(2 * n_loc, -1)
        yc = resample_groups_halo(xc, p, q, taps_per_phase)
        g = torch.as_tensor(gain, dtype=torch.float32, device=x.device)
        gain_c = g.expand(c_loc) if g.ndim == 0 else g
        y8 = quantize_i8(yc.reshape(c_loc, t_loc, 2, -1),
                         gain_c[:, None, None, None])
        xs = tuple(y8[:, :, k].reshape(c_loc, -1) for k in (0, 1))
        if not demod:
            return xs
        return _planar_local(*xs, *(None,) * 8, mesh=mesh, cfg=cfg,
                             tile=tile, device=device)
    padded, = _assemble(mesh, [x], gi, gi, [l0], [r0])    # resample halos
    xc = padded.reshape(n_loc, -1, 2).transpose(1, 2)
    yc = resample_groups_halo(xc.reshape(2 * n_loc, -1), p, q,
                              taps_per_phase)
    y = yc.reshape(n_loc, 2, -1).transpose(1, 2)
    y = y.reshape(c_loc, t_loc * cfg.block_size, 2)
    if not demod:
        return y
    return _f32_local(y, *(None,) * 4, mesh=mesh, cfg=cfg, device=device)


# --- the host fronts and the step factories ---------------------------------

def _f32_front(mesh: Mesh, cfg: DspConfig, iq, lctx=None, rctx=None,
               ablate_halos: bool = False) -> tuple:
    """The host front of an f32 step: this rank's shards (a host array is
    sharded here) and context on the device, checked, and the transfers
    between ranks. Returns `_f32_local`'s tensor arguments."""
    x = _place(iq, mesh, 1)
    _check_local(x, mesh, cfg.block_size)
    lh, rh = ([None], [None]) if ablate_halos else _edge_exchange(
        mesh, [x], cfg.left_halo, cfg.right_halo)
    return x, _ctx(lctx, mesh), _ctx(rctx, mesh), lh[0], rh[0]


def _planar_front(mesh: Mesh, cfg: DspConfig, xi, xq, lctx=(None, None),
                  rctx=(None, None)) -> tuple:
    """The host front of a planar step (as `_f32_front`): returns
    `_planar_local`'s tensor arguments."""
    xs = [_place(xi, mesh, 1), _place(xq, mesh, 1)]
    for x in xs:
        _check_local(x, mesh, cfg.block_size)
    lh, rh = _edge_exchange(mesh, xs, cfg.left_halo, cfg.right_halo)
    return (*xs, *(_ctx(c, mesh) for c in lctx),
            *(_ctx(c, mesh) for c in rctx), *lh, *rh)


def _local_gain(gain, mesh: Mesh):
    """This rank's quantization gain: a scalar as given, a (C,) vector
    checked against the mesh and sliced to this rank's channels."""
    g = gain if isinstance(gain, torch.Tensor) else np.asarray(gain,
                                                               np.float32)
    if g.ndim == 0:
        return g
    if g.shape[0] != mesh.n_channel:
        # a wrong-length vector must fail, not reuse other channels'
        # gains (wrong full_scale and dBFS)
        raise ValueError(f"gain vector has {g.shape[0]} entries for "
                         f"{mesh.n_channel} channels")
    return g[mesh.channels.start: mesh.channels.stop]


def make_sharded_demod(mesh: Mesh, cfg: DspConfig, *,
                       ablate_halos: bool = False):
    """The multi-shard demod step.

    Returns fn(iq): iq is this rank's shards of the global float32
    (n_channels, n_time_shards * block_size, 2) array (`shard_input`; a
    host array is sharded here). The DetectionTable has leading
    mesh.local_shape dims, indices global within the step.

    ablate_halos=True replaces the halo exchange with local zeros:
    identical compute shape, no communication. MEASUREMENT ONLY (frames
    straddling shard edges are lost)."""
    def fn(iq):
        return _f32_local(*_f32_front(mesh, cfg, iq,
                                      ablate_halos=ablate_halos),
                          mesh=mesh, cfg=cfg, ablate_halos=ablate_halos,
                          device=mesh.device)

    return fn


def make_sharded_demod_ctx(mesh: Mesh, cfg: DspConfig):
    """Sharded demod step with STREAM context at the step edges.

    fn(iq, lctx, rctx): iq as in make_sharded_demod; lctx (C, left_halo,
    2) is the stream immediately BEFORE this step and rctx (C, right_halo,
    2) immediately AFTER it (zeros at the true stream start/end); a host
    array holds every channel, a tensor this rank's. Interior shards still
    exchange halos; the first/last time shards take their outer halo from
    the context, so a frame straddling two consecutive steps decodes once.
    Used by dist.multihost.PodPipeline."""
    def fn(iq, lctx, rctx):
        return _f32_local(*_f32_front(mesh, cfg, iq, lctx, rctx), mesh=mesh,
                          cfg=cfg, device=mesh.device)

    return fn


def make_sharded_demod_planar(mesh: Mesh, cfg: DspConfig, tile: int = None):
    """The planar int8 demod over the mesh: kernels B1 and B2 on a card,
    once per step over every local shard.

    Returns fn(xi, xq): this rank's shards of two global int8 arrays of
    shape (n_channels, n_time_shards * block_size) (`shard_input_planar`).
    The halos carry 1 byte per sample and stream, 8x less than the f32
    (N, 2) layout."""
    from ..kernels.preamble import default_tile
    tile = default_tile(cfg) if tile is None else tile

    def fn(xi, xq):
        return _planar_local(*_planar_front(mesh, cfg, xi, xq), mesh=mesh,
                             cfg=cfg, tile=tile, device=mesh.device)

    return fn


def make_sharded_demod_planar_ctx(mesh: Mesh, cfg: DspConfig,
                                  tile: int = None):
    """Planar int8 sharded demod with STREAM context at the step edges.

    fn(xi, xq, li, lq, ri, rq): xi/xq as in make_sharded_demod_planar;
    li/lq are the (C, left_halo) int8 context immediately BEFORE this step
    and ri/rq (C, right_halo) immediately AFTER it (zeros at the true
    stream start/end). Interior shards exchange halos; the first/last time
    shards take their outer halo from the context, so a frame straddling
    two consecutive steps of a long stream decodes exactly once. Used by
    dist.multihost.PodPipeline(planar=True)."""
    from ..kernels.preamble import default_tile
    tile = default_tile(cfg) if tile is None else tile

    def fn(xi, xq, li, lq, ri, rq):
        return _planar_local(*_planar_front(mesh, cfg, xi, xq, (li, lq),
                                            (ri, rq)),
                             mesh=mesh, cfg=cfg, tile=tile,
                             device=mesh.device)

    return fn


def make_sharded_resample_demod(mesh: Mesh, cfg: DspConfig, p: int, q: int,
                                taps_per_phase: int = 12,
                                planar: bool = False, tile: int = None):
    """Fused resample + demod in one sharded step.

      raw-rate shard --128q-sample halos--> group-matmul resample
        --int8 quantize--> demod halos (int8 planar) --> planar demod

    planar=False keeps the f32 path (demod_block per shard): fn(iq) with iq
    interleaved (n_channels, n_time * raw_block, 2). planar=True: fn(iqp,
    gain), iqp PLANAR float32 (n_channels, 2, n_time * raw_block)
    (`shard_input_resample_planar`) and gain the REQUIRED int8 quantization
    gain, a scalar or a (C,) per-channel vector of which each channel
    shard takes its own (report dBFS with full_scale = gain/127; a device
    AGC per shard would mint a different full scale per time shard).
    ONE-SHOT semantics: both stream edges read zeros. raw_block =
    cfg.block_size * q / p (cfg.block_size a multiple of 128p). Detection
    indices are global in the resampled (channel-rate) domain."""
    from ..resample.fused import raw_geometry

    gi = 128 * q
    raw_geometry(cfg, p, q)        # validates block alignment + pq cap
    raw_block = cfg.block_size * q // p
    if planar:
        from ..kernels.preamble import default_tile
        tile = default_tile(cfg) if tile is None else tile
    else:
        tile = None
    static = dict(mesh=mesh, cfg=cfg, p=p, q=q,
                  taps_per_phase=taps_per_phase, planar=planar, tile=tile,
                  device=mesh.device)
    # this rank's channel rows continue on other ranks: the demod halos
    # cross ranks after the resample
    split = mesh.times.start > 0 or mesh.times.stop < mesh.n_time

    if not planar:
        def fn(iq):
            x = _place(iq, mesh, 1)
            _check_local(x, mesh, raw_block, "raw-rate time")
            (l0,), (r0,) = _edge_exchange(mesh, [x], gi, gi)
            if not split:
                return _resample_local(x, None, l0, None, r0, None, **static)
            y = _resample_local(x, None, l0, None, r0, None, demod=False,
                                **static)
            return _f32_local(*_f32_front(mesh, cfg, y), mesh=mesh, cfg=cfg,
                              device=mesh.device)

        return fn

    def fn_planar(iqp, gain):
        x = _place(iqp, mesh, 2)
        _check_local(x, mesh, raw_block, "raw-rate time", dim=2)
        g = _local_gain(gain, mesh)
        (l0, l1), (r0, r1) = _edge_exchange(mesh, [x[:, 0], x[:, 1]], gi, gi)
        if not split:
            return _resample_local(x, g, l0, l1, r0, r1, **static)
        xi, xq = _resample_local(x, g, l0, l1, r0, r1, demod=False, **static)
        return _planar_local(*_planar_front(mesh, cfg, xi, xq), mesh=mesh,
                             cfg=cfg, tile=tile, device=mesh.device)

    return fn_planar
