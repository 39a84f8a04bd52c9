"""Device kernels a pass, copies and fills left out (the host's launch
rate bounds a pass of many small kernels)."""


def read(rec):
    prof = rec.get("profile")
    if not prof:
        return None
    return prof["n_kernels"] / prof["passes"]
