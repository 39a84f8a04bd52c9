"""Seconds a pass of the manifold-exploration stages, from the program's
timing laps of the traced window."""

from . import phase_s


def read(rec):
    return phase_s(rec, "surface_me", "volume_me")
