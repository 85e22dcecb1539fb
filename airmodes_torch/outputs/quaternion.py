"""Minimal quaternion/orientation helpers for the FlightGear feeder.

Role equivalent of the reference's vendored python/Quaternion.py: build the
ECEF orientation quaternion of an aircraft from lat/lon + heading so it
renders correctly in the FlightGear multiplayer view.
"""

from __future__ import annotations

import math
from typing import Tuple

Quat = Tuple[float, float, float, float]  # (w, x, y, z)


def from_axis_angle(ax: Tuple[float, float, float], angle_rad: float) -> Quat:
    s = math.sin(angle_rad / 2)
    return (math.cos(angle_rad / 2), ax[0] * s, ax[1] * s, ax[2] * s)


def multiply(a: Quat, b: Quat) -> Quat:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    )


def from_euler(roll: float, pitch: float, yaw: float) -> Quat:
    """Body orientation from euler angles (radians, ZYX convention)."""
    qz = from_axis_angle((0, 0, 1), yaw)
    qy = from_axis_angle((0, 1, 0), pitch)
    qx = from_axis_angle((1, 0, 0), roll)
    return multiply(multiply(qz, qy), qx)


def from_lat_lon(lat_deg: float, lon_deg: float) -> Quat:
    """Quaternion rotating ECEF into the local NED frame at lat/lon."""
    zd2 = 0.5 * math.radians(lon_deg)
    yd2 = -0.25 * math.pi - 0.5 * math.radians(lat_deg)
    szd2, czd2 = math.sin(zd2), math.cos(zd2)
    syd2, cyd2 = math.sin(yd2), math.cos(yd2)
    return (czd2 * cyd2, -szd2 * syd2, czd2 * syd2, szd2 * cyd2)


def ecef_orientation(lat_deg: float, lon_deg: float, heading_deg: float,
                     pitch_deg: float = 0.0, roll_deg: float = 0.0) -> Quat:
    """Full ECEF orientation: local frame x body attitude."""
    local = from_lat_lon(lat_deg, lon_deg)
    body = from_euler(math.radians(roll_deg), math.radians(pitch_deg),
                      math.radians(heading_deg))
    return multiply(local, body)


def to_angle_axis(q: Quat) -> Tuple[float, float, float]:
    """Quaternion -> scaled angle-axis (what the FG MP wire format carries)."""
    w, x, y, z = q
    norm = math.sqrt(x * x + y * y + z * z)
    if norm < 1e-12:
        return (0.0, 0.0, 0.0)
    angle = 2.0 * math.atan2(norm, w)
    s = angle / norm
    return (x * s, y * s, z * s)
