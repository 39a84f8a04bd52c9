"""Seconds a pass: the measured window over the passes completed in it
(the reconstructions every dump_every passes inside it)."""


def read(rec):
    return rec["window_s"] / rec["passes"]
