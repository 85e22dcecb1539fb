"""The system under test: the port's served path, driven in process.

One channel: `airmodes_torch.apps.modes_rx.build_msg_iter` with the
arguments `modes_rx` parses for the configuration (`--int8` on a card
selects `io/native_stream.run_native_pipelined`, with `-r 10e6` the fused
`io/stream.run_resampled_fused`). Several channels:
`io/native_stream.run_native_channels`, as `modes_rx._run_multichannel`
calls it. Every block's wire messages go through the port's `parse` into
its SQLite output (`outputs/sql`, as `modes_rx -d <db>` wires it, on a
`local_pubsub` bus), with the product's own statements and batched commits.
The configuration's `sqlite_db` says where the database lives: ":memory:",
or "file", a database file made new under TMPDIR each run, with SQLite's
default journal and syncs.

This module imports the port; nothing of the reference does.
"""

from __future__ import annotations

import time
from typing import Iterator, List, Optional, Tuple


def modes_rx_args(config: dict, sources: List[str], device: str, db: str):
    """The namespace `modes_rx` parses for this configuration, its SQLite
    output `db` (a path, or ":memory:")."""
    from airmodes_torch.apps.modes_rx import build_argparser
    argv = list(config["modes_rx"])
    for s in sources:
        argv += ["-s", s]
    argv += ["-n", "-d", db, "--stats-interval", "0", "--device", device]
    return build_argparser().parse_args(argv)


def dsp_config(args):
    """The DspConfig `modes_rx.main` builds from its arguments."""
    from airmodes_torch.config import DspConfig
    return DspConfig(channel_rate=args.channel_rate,
                     threshold_db=args.threshold,
                     block_size=args.block_size,
                     max_detections=args.max_detections)


def check_config(config: dict, cfg) -> None:
    """The configuration file's `dsp` must be what modes_rx builds from
    its `modes_rx` arguments (the reference reads the former)."""
    for k, v in config["dsp"].items():
        if getattr(cfg, k) != v:
            raise ValueError(f"configuration: dsp.{k} = {v!r}, but modes_rx "
                             f"{config['modes_rx']} builds {getattr(cfg, k)!r}")


def stream_geometry(config: dict, cfg) -> Tuple[int, int]:
    """(block, right) in source samples: the samples that end a stream on
    whole blocks are M * block + right."""
    q = round(config["source_rate"] / cfg.channel_rate)
    if q == 1:
        return cfg.block_size, cfg.right_halo
    from airmodes_torch.resample.fused import raw_geometry
    _, raw_block, raw_right, _ = raw_geometry(cfg, 1, q)
    return raw_block, raw_right


def warm_step(config: dict, cfg, channels: int, batch: int, device) -> None:
    """Capture the device step's graph for the shapes the stream will use,
    on zero rows, before the stream starts."""
    import numpy as np
    import torch
    q = round(config["source_rate"] / cfg.channel_rate)
    if q == 1:
        from airmodes_torch.io.native_stream import _planar_step
        step, P = _planar_step(cfg, device)
        rows = channels if channels > 1 else batch
        z = torch.zeros((rows, P), dtype=torch.int8,
                        pin_memory=torch.device(device).type == "cuda")
        step(z, z).cpu()
    else:
        from airmodes_torch.resample.fused import (
            raw_geometry, resample_demod_packed_planar_jit)
        left, block, right, _ = raw_geometry(cfg, 1, q)
        x = np.zeros((batch, 2, left + block + right), np.float32)
        out, gains = resample_demod_packed_planar_jit(x, None, cfg, 1, q,
                                                      device=device)
        out.cpu()


def open_stream(config: dict, args, cfg, stats) -> Iterator[
        List[Tuple[int, Optional[List[str]]]]]:
    """Per step of the served path, [(channel, messages or None)]: one
    entry per block on one channel, one per channel on several."""
    sources = args.source
    if len(sources) == 1:
        from airmodes_torch.apps.modes_rx import build_msg_iter
        args.source = sources[0]
        for msgs in build_msg_iter(args, cfg, epoch=0.0, stats=stats):
            yield [(0, msgs)]
        return
    from airmodes_torch.io.native_stream import run_native_channels
    for step in run_native_channels(
            list(sources), cfg, fmt=args.file_format,
            start_sample=args.start_sample, epoch=0.0, stats=stats,
            depth=args.depth, max_blocks=args.max_blocks,
            scale=args.i8_scale, device=args.device):
        yield list(enumerate(step))


class Sink:
    """The output side of `modes_rx -d <db>`: each message published on
    the bus, parsed by the port's parser, inserted into SQLite. `take`
    times one block's messages (the harness's span around parse and
    SQLite) and, when asked, keeps each message's report."""

    def __init__(self, db: str):
        from airmodes_torch.decode.parse import parse
        from airmodes_torch.exceptions import ADSBError
        from airmodes_torch.io.relay import local_pubsub
        from airmodes_torch.outputs.sql import output_sql
        self._err = ADSBError
        self.parser = parse(None)
        self.db = db
        self.sql = output_sql(db, self.parser)
        self.bus = local_pubsub()
        self.bus.subscribe("dl_data", self._on)
        self._keep = None
        self.spans = []                 # (start, end, messages), monotonic

    def _on(self, msg: str) -> None:
        try:
            rep = self.parser.parse(msg)
        except self._err:
            rep = None
        if rep is not None:
            self.sql.insert(rep)
        if self._keep is not None:
            self._keep.append((msg, rep))

    def take(self, msgs: List[str], keep: bool):
        """Publish one block's messages; returns [(message, report)] when
        `keep`, else None."""
        self._keep = [] if keep else None
        t0 = time.monotonic()
        for m in msgs:
            self.bus.publish("dl_data", m)
        self.spans.append((t0, time.monotonic(), len(msgs)))
        kept, self._keep = self._keep, None
        return kept

    def close(self) -> None:
        self.sql.close()
