"""Decode stack (ref: gr-air-modes python decode layer, SURVEY.md §2.3).

A copy of `airmodes.decode`: host-side numpy and the standard library,
run on the messages the port's demod paths emit. The port imports nothing
of the JAX package."""

from . import acas, altitude, commb, cpr, fields, mlat, parse  # noqa: F401
