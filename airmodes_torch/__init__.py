"""airmodes_torch — the Mode S / ADS-B receiver in PyTorch and CUDA for
NVIDIA Hopper: the demod paths on the card, the decode stack and the
output plugins on the host.

A port of the `airmodes` JAX package, which stays beside it as the
reference. This package imports torch, numpy and the standard library
(and, optionally, pyzmq for the relay and Qt for the GUI, as the
reference does), never JAX and nothing of `airmodes`; it keeps its own
copies of the constants, the config, the CRC tables, the host-side table
decoder, the C++ framer, the decoders, the output plugins and the capture
encoder. Entry
points run on the card (`device="cuda"`) unless the caller asks for the
CPU, where the kernels' plain PyTorch versions stand in. The compiled
steps (`demod_block_jit`, `demod_batch_jit` and the `*_jit` steps the
runners call) replay one captured CUDA graph per call on a card
(`utils.graphs`), as the reference runs one jitted program.
"""

from . import constants, exceptions
from .config import Config, DspConfig, OutputConfig, SourceConfig
from .crc import crc24, parity
from .decode.altitude import decode_alt
from .decode.cpr import cpr_decoder
from .decode.parse import AircraftReport, parse
from .dsp.pipeline import (DetectionTable, demod_batch, demod_batch_jit,
                           demod_batch_packed, demod_block, demod_block_jit,
                           demod_block_packed, iq_to_device_layout,
                           pack_table, unpack_table)
from .io.native_stream import run_native_channels, run_native_pipelined
from .io.stream import run_channels, run_pipelined
from .kernels.preamble import (demod_batch_packed_fast,
                               demod_batch_packed_planar, demod_batch_planar,
                               demod_block_packed_fast, planar_length,
                               supported_2d_tile, to_planar_i8)

__version__ = "0.1.0"

__all__ = [
    "AircraftReport", "Config", "DetectionTable", "DspConfig",
    "OutputConfig", "SourceConfig", "constants", "cpr_decoder", "crc24",
    "decode_alt", "demod_batch", "demod_batch_jit", "demod_batch_packed",
    "demod_batch_packed_fast", "demod_batch_packed_planar",
    "demod_batch_planar", "demod_block", "demod_block_jit",
    "demod_block_packed",
    "demod_block_packed_fast", "exceptions", "iq_to_device_layout",
    "pack_table", "parity", "parse", "planar_length", "run_channels",
    "run_native_channels", "run_native_pipelined", "run_pipelined",
    "supported_2d_tile", "to_planar_i8", "unpack_table",
]
