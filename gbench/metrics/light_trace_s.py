"""Seconds a pass of the light pass (photon shooting), from the program's
timing laps of the traced window."""

from . import phase_s


def read(rec):
    return phase_s(rec, "light_trace")
