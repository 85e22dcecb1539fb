# Frozen copy of airmodes_torch/config.py at commit 8b1fb463eba6: part of
# the benchmark's yardstick, which later changes to the program leave as
# it is. Only its imports were changed.
"""Configuration dataclasses: a copy of `airmodes.config`.

The port imports nothing of the JAX package, so it keeps its own frozen
`DspConfig`, `SourceConfig`, `OutputConfig`, `MeshConfig` and `Config`
with the same fields, defaults and derived properties. Each has a
`from_dict`: `Config.from_dict(dataclasses.asdict(reference_cfg))` builds
the port's config from the reference's, so both packages run the
identical settings.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .constants import CHIP_RATE, MAX_EVENT_CHIPS


@dataclasses.dataclass(frozen=True)
class DspConfig:
    """Static parameters of the demod pipeline."""

    channel_rate: float = 2e6          # samples/s after any resampling
    threshold_db: float = 5.0          # preamble detection threshold over noise floor
    block_size: int = 1 << 20          # owned samples per device block
    max_detections: int = 128          # fixed-capacity detection table per block
    noise_window: int = 128            # trailing moving-average window (samples)
    pulse_tolerance: float = 0.25      # pulse power >= tol * reference level (~6 dB)
    quiet_tolerance: float = 0.5       # quiet chip power < tol * reference level (~3 dB)
    max_lowconf_bits: int = 5          # ECC attempted only if #low-confidence <= this
    confidence_level: float = 0.5      # chip "on" if power > level * reference
    nms_chips: int = 2                 # non-max suppression half-window (chips)

    # Reference fields with no meaning here. mxu_window_sum picks how the
    # reference's TPU kernel takes the noise-window sum (two matmuls or the
    # shifted-add fold), a choice its config calls decision-equivalent; the
    # port always folds (kernels/preamble.py).
    _REFERENCE_ONLY = ("mxu_window_sum",)

    @classmethod
    def from_dict(cls, d: dict) -> "DspConfig":
        """Build from `dataclasses.asdict` of the reference config. The
        reference-only fields are dropped; any other key this config does
        not know is an error."""
        names = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k not in cls._REFERENCE_ONLY}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"unknown DspConfig fields: {sorted(unknown)}")
        return cls(**d)

    @property
    def sps(self) -> int:
        """Integer samples per chip (channel_rate must be a multiple of 2 Msps)."""
        sps = int(round(self.channel_rate / CHIP_RATE))
        if sps < 1 or abs(sps * CHIP_RATE - self.channel_rate) > 1e-3:
            raise ValueError(
                f"channel_rate {self.channel_rate} is not an integer multiple of "
                f"{CHIP_RATE}; resample first")
        return sps

    @property
    def threshold(self) -> float:
        """Linear power ratio for the dB threshold (ref: powf(10, db/10))."""
        return 10.0 ** (self.threshold_db / 10.0)

    @property
    def left_halo(self) -> int:
        """Samples of left context a block needs: the noise window plus one
        extra 128-sample row of peak/NMS lookback."""
        if self.noise_window <= 0:
            raise ValueError(f"noise_window must be > 0, got "
                             f"{self.noise_window}")
        return self.noise_window + 128

    @property
    def right_halo(self) -> int:
        """Samples of right context (preamble + longest frame + peak lookahead)."""
        return (MAX_EVENT_CHIPS + 2) * self.sps


def _from_dict(cls, d: dict):
    """Build a flat config dataclass from a dict (`dataclasses.asdict` or
    JSON); a key the class does not know is an error, and lists become
    the tuples the frozen (hashable) classes hold."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in d.items()})


@dataclasses.dataclass(frozen=True)
class SourceConfig:
    """Where IQ samples come from (ref: modes_rx -s / radio.py _setup_source)."""

    kind: str = "file"                 # file | udp | synthetic | uhd | osmocom
    path: Optional[str] = None         # for file sources (complex64 interleaved)
    udp_host: str = "0.0.0.0"
    udp_port: int = 10000
    udp_timeout_s: float = 0.0         # 0 = survive feeder restarts
    sample_rate: float = 2e6           # raw source rate (resampled to channel_rate)
    center_freq: float = 1090e6
    gain: Optional[float] = None
    antenna: Optional[str] = None
    freq_corr_ppm: float = 0.0
    throttle: bool = False             # real-time throttle for file replay
    pps_sync: bool = False             # mlat-grade time sync (hardware sources)

    from_dict = classmethod(_from_dict)


@dataclasses.dataclass(frozen=True)
class OutputConfig:
    """Which output plugins are enabled (ref: modes_rx -P/-K/-d/-w/-m/-n/-l)."""

    print_console: bool = True
    sbs1_port: Optional[int] = None       # 30003 typical
    kml_file: Optional[str] = None
    sqlite_db: Optional[str] = None
    raw_port: Optional[int] = None        # raw hex TCP feed
    flightgear: Optional[str] = None      # host:port
    location: Optional[Tuple[float, float, float]] = None  # lat, lon, alt_m

    from_dict = classmethod(_from_dict)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device layout for the sharded pipeline (SURVEY.md §2.7)."""

    channel_axis: int = 1              # data parallel over SDR channels
    time_axis: int = 1                 # sequence parallel over time blocks
    axis_names: Tuple[str, str] = ("channel", "time")

    from_dict = classmethod(_from_dict)


@dataclasses.dataclass(frozen=True)
class Config:
    dsp: DspConfig = dataclasses.field(default_factory=DspConfig)
    source: SourceConfig = dataclasses.field(default_factory=SourceConfig)
    output: OutputConfig = dataclasses.field(default_factory=OutputConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    _PARTS = {"dsp": DspConfig, "source": SourceConfig,
              "output": OutputConfig, "mesh": MeshConfig}

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        """Build from `dataclasses.asdict` of the reference `Config`: each
        part through its own `from_dict`; a missing part takes its
        defaults, an unknown one is an error."""
        unknown = set(d) - set(cls._PARTS)
        if unknown:
            raise ValueError(f"unknown Config fields: {sorted(unknown)}")
        return cls(**{k: cls._PARTS[k].from_dict(v) for k, v in d.items()})
