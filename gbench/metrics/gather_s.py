"""Seconds a pass of the photon gathers and sweeps (kernels and their host code), from the program's
timing laps of the traced window."""

from . import phase_s


def read(rec):
    return phase_s(rec, "surface_gather", "volume_gather")
