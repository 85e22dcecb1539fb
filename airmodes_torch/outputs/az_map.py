"""Azimuth/range coverage model (ref: gr-air-modes python/az_map.py).

Headless core of the reference's PyQt polar coverage widget: per-bearing
maximum observed range buckets (the coverage diagram). The Qt painting lives
in apps/modes_gui.py when PyQt is available; this model is fully testable
without a display.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..decode.parse import parse
from ..exceptions import ADSBError


class az_map_model:
    """Max range seen per bearing bucket, with optional altitude rings."""

    def __init__(self, n_buckets: int = 72, n_alt_rings: int = 4,
                 max_alt_ft: float = 48000.0):
        self.n_buckets = n_buckets
        self.n_alt_rings = n_alt_rings
        self.max_alt_ft = max_alt_ft
        # [alt_ring][bearing_bucket] -> max range (NM)
        self.ranges: List[List[float]] = [
            [0.0] * n_buckets for _ in range(n_alt_rings)]

    def _ring(self, alt_ft: Optional[float]) -> int:
        if alt_ft is None:
            return 0
        frac = min(max(alt_ft, 0.0), self.max_alt_ft - 1) / self.max_alt_ft
        return int(frac * self.n_alt_rings)

    def add(self, bearing_deg: float, range_nm: float,
            alt_ft: Optional[float] = None) -> None:
        b = int((bearing_deg % 360.0) / 360.0 * self.n_buckets) % self.n_buckets
        r = self._ring(alt_ft)
        if range_nm > self.ranges[r][b]:
            self.ranges[r][b] = range_nm

    def polygon(self, ring: int = 0) -> List[Tuple[float, float]]:
        """Coverage outline as (bearing_deg, range_nm) vertices."""
        step = 360.0 / self.n_buckets
        return [(i * step + step / 2, rng)
                for i, rng in enumerate(self.ranges[ring])]

    def envelope(self) -> List[Tuple[float, float]]:
        """Per-bearing max range across ALL altitude rings — the outline a
        coverage display draws (ring 0 alone holds only sub-
        max_alt/n_rings traffic and misses everything at cruise)."""
        step = 360.0 / self.n_buckets
        return [(i * step + step / 2, max(r[i] for r in self.ranges))
                for i in range(self.n_buckets)]

    def max_range(self) -> float:
        return max(max(ring) for ring in self.ranges)


def render_ascii(model: az_map_model, width: int = 61,
                 height: int = 31,
                 aircraft: Optional[List[Tuple[float, float, str]]] = None
                 ) -> List[str]:
    """Coverage envelope as ASCII art (polar plot, receiver at center).

    Pure renderer so the curses dashboard (and tests) can draw the same
    coverage diagram the Qt az_map paints — '#' marks covered bearings up
    to their max range, '+' the receiver, ring labels on the east axis.
    Cells are 2:1 (terminal glyphs are ~twice as tall as wide), handled by
    halving the y scale. `aircraft` overlays live targets as
    (bearing_deg, range_nm, label) — an '@' mark followed by the label.
    """
    import math
    width, height = max(width, 3), max(height, 3)  # tiny-terminal floor
    grid = [[" "] * width for _ in range(height)]
    cx, cy = width // 2, height // 2
    max_rng = model.max_range()
    if max_rng <= 0.0:
        grid[cy][cx] = "+"
        return ["".join(row) for row in grid]
    env = model.envelope()
    step = 360.0 / len(env)
    scale_x = (width // 2 - 1) / max_rng
    scale_y = (height // 2 - 1) / max_rng
    for brg, rng in env:
        if rng <= 0.0:
            continue
        # fill along the radial so the plot reads as area, not an outline
        th = math.radians(brg)
        n = max(2, int(rng * scale_x))
        for k in range(1, n + 1):
            r = rng * k / n
            x = cx + int(round(math.sin(th) * r * scale_x))
            y = cy - int(round(math.cos(th) * r * scale_y))
            if 0 <= x < width and 0 <= y < height:
                grid[y][x] = "#" if k == n else "."
        # half-bearing neighbors fill gaps between adjacent buckets
        for db in (-step / 2, step / 2):
            th2 = math.radians(brg + db)
            x = cx + int(round(math.sin(th2) * rng * scale_x))
            y = cy - int(round(math.cos(th2) * rng * scale_y))
            if 0 <= x < width and 0 <= y < height and grid[y][x] == " ":
                grid[y][x] = "#"
    grid[cy][cx] = "+"
    label = f"{max_rng:.0f} NM"
    # right-aligned toward the east edge, but never left of the receiver
    # marker: on narrow grids the unclamped start index goes NEGATIVE,
    # wrapping the label to the row end and overwriting the '+' marker
    start = max(cx + 1, min(width - 1, cx + (width // 2 - 1)) - len(label) + 1)
    for i, ch in enumerate(label):
        if start + i < width:
            grid[cy][start + i] = ch
    for brg, rng, name in aircraft or ():
        if rng is None or brg is None or rng > max_rng * 1.05:
            continue
        th = math.radians(brg)
        x = cx + int(round(math.sin(th) * rng * scale_x))
        y = cy - int(round(math.cos(th) * rng * scale_y))
        if 0 <= x < width and 0 <= y < height:
            grid[y][x] = "@"
            for i, ch in enumerate(name[:6]):
                if x + 1 + i < width:
                    grid[y][x + 1 + i] = ch
    return ["".join(row) for row in grid]


class output_az_map:
    """Plugin adapter feeding the coverage model from decoded positions."""

    def __init__(self, model: Optional[az_map_model] = None,
                 parser: Optional[parse] = None, my_position=None):
        self.model = model or az_map_model()
        self._parser = parser or parse(my_position)

    def output(self, msg: str) -> None:
        try:
            rep = self._parser.parse(msg)
        except ADSBError:
            return
        self.update(rep)

    def update(self, rep) -> None:
        """Feed an already-parsed report (callers sharing one parser must
        not re-parse the same wire string through shared CPR/ELM state)."""
        if rep.bearing_deg is not None and rep.range_nm is not None:
            self.model.add(rep.bearing_deg, rep.range_nm, rep.altitude_ft)
