"""Output plugins (ref: gr-air-modes L4). Each exposes output(msg) and
subscribes to the dl_data wire-message feed.

A copy of `airmodes.outputs`, over the port's own `decode/`; the port
imports nothing of the JAX package."""

from .az_map import az_map_model, output_az_map
from .flightgear import output_flightgear
from .gui_model import AircraftState, dashboard, output_dashboard
from .kml import output_kml, render_kml
from .msprint import output_print
from .raw_server import output_raw
from .sbs1 import format_sbs1, output_sbs1
from .sql import output_sql

__all__ = [
    "AircraftState", "az_map_model", "dashboard", "format_sbs1",
    "output_az_map", "output_dashboard", "output_flightgear", "output_kml",
    "output_print", "output_raw", "output_sbs1", "output_sql", "render_kml",
]
