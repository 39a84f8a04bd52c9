"""Peak device memory allocated during the window, fullest rank, GiB."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30
