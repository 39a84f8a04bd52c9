"""Process start to the first timed pass: imports, scene, kernel builds
or loads, a cold and a warm pass and one reconstruction."""


def read(rec):
    return rec["setup_s"]
