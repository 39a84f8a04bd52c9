"""Seconds a pass of the cell grids and photon row tables, from the program's
timing laps of the traced window."""

from . import phase_s


def read(rec):
    return phase_s(rec, "surface_grid", "volume_grid")
