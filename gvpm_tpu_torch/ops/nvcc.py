"""Build the port's CUDA kernels: nvcc compiles one source of csrc/ into
a shared library with a plain C interface (loaded with ctypes by its
wrapper, ops/fused_gather.py or ops/beam_sweep.py) under
gvpm_tpu_torch/_build/<hash of the flags and sources>/, once, and keeps
ptxas's report (`-Xptxas -v`) beside it."""

from __future__ import annotations

import hashlib
import os
import re
import subprocess


def library_dir(csrc, sources, build_dir, flags):
    """The directory of a build: keyed by the flags and the sources."""
    h = hashlib.sha256(" ".join(flags).encode())
    for name in sources:
        with open(os.path.join(csrc, name), "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir, h.hexdigest()[:16])


def build_library(csrc, sources, build_dir, flags, name):
    """Compile csrc/<name>.cu (which includes the other `sources`) into
    lib<name>.so, unless that build exists; returns its path."""
    out_dir = library_dir(csrc, sources, build_dir, flags)
    so = os.path.join(out_dir, f"lib{name}.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        tmp = so + f".{os.getpid()}.tmp"
        res = subprocess.run([nvcc, *flags, "-o", tmp,
                              os.path.join(csrc, f"{name}.cu")],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + res.stderr)
        with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
            f.write(res.stderr)
        os.replace(tmp, so)
    return so


def ptxas_entries(text):
    """`nvcc -Xptxas -v` output -> {entry function's mangled name:
    dict(registers, spill_stores, spill_loads, stack, smem)}, bytes but
    for the registers per thread."""
    report = {}
    entry = re.compile(r"Compiling entry function '(\w+)'(.*?)"
                       r"(?=Compiling entry function|\Z)", re.S)
    for name, block in entry.findall(text):
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", block)
        regs = re.search(r"Used (\d+) registers", block)
        if frame is None or regs is None:
            continue
        stack, st, ld = map(int, frame.groups())
        smem = re.search(r"(\d+) bytes smem", block)
        report[name] = dict(registers=int(regs.group(1)), spill_stores=st,
                            spill_loads=ld, stack=stack,
                            smem=int(smem.group(1)) if smem else 0)
    return report


def build_report(csrc, sources, build_dir, flags):
    """ptxas_entries of an existing build."""
    with open(os.path.join(library_dir(csrc, sources, build_dir, flags),
                           "ptxas.txt")) as f:
        return ptxas_entries(f.read())
