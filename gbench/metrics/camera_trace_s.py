"""Seconds a pass of the camera pass (base and four offset paths), from the program's
timing laps of the traced window."""

from . import phase_s


def read(rec):
    return phase_s(rec, "camera_trace")
