"""Start N ranks from one process and collect rank 0's result.

`launch(n, fn, *args, ...)` spawns n processes (the `spawn` method: a
process that has started CUDA cannot fork), joins them into a process
group on a free localhost port, and calls fn(mesh, *args, **kwargs) in
each (SPMD, as the JAX package's shard_map body runs on every device).
A Scene among the arguments travels on the CPU and is moved to each
rank's device; tensors in rank 0's result come back as CPU tensors. A
rank that raises or dies makes `launch` kill every rank and raise
RankError with its traceback; so does a `timeout`.
"""

from __future__ import annotations

import io
import multiprocessing
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from ..core.device import resolve_device
from ..scene.types import Scene
from . import mesh as meshmod

# seconds the ranks get to exit after rank 0 has sent its result
JOIN_TIMEOUT = 60.0


class RankError(RuntimeError):
    """A rank failed, died, or the ranks ran past their time."""


def free_port():
    """A TCP port of localhost that no socket holds now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _on(x, device):
    return x.to(device) if isinstance(x, Scene) else x


def _rank_main(rank, n, port, backend, device, threads, fn, args, kwargs,
               results):
    try:
        # the launcher's ranks are the ranks of this machine
        os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
        torch.set_num_threads(threads)
        dev = meshmod.rank_device(device, backend, rank, n)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend,
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=n,
                                timeout=meshmod.TIMEOUT)
        try:
            mesh = meshmod.make_mesh(n, dev, backend)
            args = [_on(a, dev) for a in args]
            kwargs = {k: _on(v, dev) for k, v in kwargs.items()}
            out = fn(mesh, *args, **kwargs)
            buf = io.BytesIO()
            if rank == 0:
                # as bytes: the queue's own pickler would hand the tensors
                # over in shared memory, which this process's exit frees
                torch.save(out, buf)
            results.put((rank, True, buf.getvalue()))
        finally:
            dist.destroy_process_group()
    except BaseException:                   # noqa: BLE001 -- sent, exit 1
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def launch(n, fn, *args, device=None, backend=None, timeout=None,
           **kwargs):
    """fn(mesh, *args, **kwargs) on `n` ranks; returns rank 0's result.
    `device`: None the CUDA card, "cpu" the CPU. `backend`: None means
    nccl on CUDA (a card for every rank; fewer cards raise) and gloo on
    the CPU; gloo on CUDA lets ranks share a card. Each rank runs
    PyTorch on as many intra-op threads as the caller does (a spawned
    process would not inherit the setting). `timeout`: seconds for the
    whole run, None for no bound (a rank that waits on a hung peer still
    raises after mesh.TIMEOUT)."""
    if n < 1:
        raise ValueError(f"launch: {n} ranks; start one or more")
    device = resolve_device(device)
    backend = backend or meshmod.default_backend(device)
    meshmod.check_backend(n, device, backend)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(r, n, port, backend, str(device), torch.get_num_threads(), fn,
              [_on(a, "cpu") for a in args],
              {k: _on(v, "cpu") for k, v in kwargs.items()}, results))
        for r in range(n)]
    for p in procs:
        p.start()
    t_end = None if timeout is None else time.monotonic() + timeout
    done = {}
    try:
        while len(done) < n:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                if t_end is not None and time.monotonic() > t_end:
                    raise RankError(f"{n} ranks of {fn.__name__} ran past "
                                    f"{timeout} s") from None
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in done and p.exitcode is not None]
                if dead:
                    # a rank that died without a word (a signal)
                    time.sleep(1.0)
                    if results.empty():
                        raise RankError(f"rank {dead[0][0]} of "
                                        f"{fn.__name__} exited with code "
                                        f"{dead[0][1]}") from None
                continue
            if not ok:
                raise RankError(f"rank {rank} of {n} failed in "
                                f"{fn.__name__}:\n{payload}")
            done[rank] = payload
        for p in procs:
            p.join(JOIN_TIMEOUT)
        late = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if late:
            raise RankError(f"ranks {late} of {fn.__name__} did not exit "
                            f"cleanly within {JOIN_TIMEOUT} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return torch.load(io.BytesIO(done[0]), map_location="cpu",
                      weights_only=False)
