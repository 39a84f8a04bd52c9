"""A rank's view of the process group, and the collectives over dicts of
tensors (mirrors gvpm_tpu/parallel/mesh.py).

The JAX package runs one program over a `jax.sharding.Mesh` of devices
(shard_map). The port runs one process a rank, each the same host loop,
joined by a torch.distributed process group: `Mesh` is that rank's rank,
world size, device and group. The backend is the caller's choice:
`nccl` with a card of its own for every rank (rank r on cuda:r), `gloo`
on the CPU, where ranks may also share a card and the collectives go
through host memory. Asking for more nccl ranks than there are cards
raises; no rank ever moves to another device or backend by itself.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from ..core.device import resolve_device

# How long a collective waits for the other ranks before it raises: a
# rank that hangs fails its peers instead of hanging them.
TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank of the render: `rank` of `size`, computing on `device`,
    its collectives over `group` on `backend`."""
    rank: int
    size: int
    device: torch.device
    backend: str
    group: object


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(n_local, device, backend):
    """Raise unless `n_local` ranks of one machine can run `backend` on
    `device`: nccl needs CUDA and a card for every rank."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: use 'nccl' or 'gloo'")
    if backend != "nccl":
        return
    if torch.device(device).type != "cuda":
        raise ValueError("the nccl backend runs on CUDA cards; use gloo "
                         "on the CPU")
    cards = torch.cuda.device_count()
    if n_local > cards:
        raise ValueError(f"{n_local} nccl ranks need a CUDA card each and "
                         f"this machine has {cards}; start fewer ranks, or "
                         f"gloo ranks, which may share a card")


def rank_device(device, backend, rank, size) -> torch.device:
    """The device of `rank`: the CPU as asked; on CUDA an nccl rank takes
    the card of its local rank, a gloo rank the card it names or else
    its local rank's card modulo the cards there are."""
    device = resolve_device(device)
    check_backend(int(os.environ.get("LOCAL_WORLD_SIZE", size)), device,
                  backend)
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", rank))
    if backend == "nccl":
        if device.index not in (None, local):
            raise ValueError(f"nccl rank {rank} runs on cuda:{local}, not "
                             f"on {device}")
        return torch.device("cuda", local)
    if device.index is not None:
        return device
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n=None, device=None, backend=None) -> Mesh:
    """This rank's Mesh over the process group it joined (parallel.launch
    or maybe_init_distributed): `n` ranks (None: the group's), computing
    on `device` (None: the CUDA card; "cpu" for the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; start the ranks "
                           "with parallel.launch.launch, or under torchrun "
                           "and call maybe_init_distributed first")
    size, rank, have = dist.get_world_size(), dist.get_rank(), \
        dist.get_backend()
    if n is not None and n != size:
        raise ValueError(f"make_mesh({n}): the process group has {size} "
                         f"ranks")
    if backend is not None and backend != have:
        raise ValueError(f"make_mesh: the process group runs {have}, not "
                         f"{backend}")
    return Mesh(rank, size, rank_device(device, have, rank, size), have,
                dist.group.WORLD)


def maybe_init_distributed(device=None) -> bool:
    """Join the process group that torchrun's variables describe (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT), as the JAX package calls
    jax.distributed.initialize under JAX_COORDINATOR_ADDRESS. Returns
    whether this process is in a group: False outside a launcher. The
    backend follows `device`: nccl on the card, gloo on the CPU."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR")):
        return False
    device = resolve_device(device)
    backend = default_backend(device)
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = rank_device(device, backend, rank, size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=size, timeout=TIMEOUT)
    return True


# ---- the collectives. gloo takes CPU tensors here: _wire stages a CUDA
# tensor through host memory for it; nccl takes the card's tensors ----

def _wire(mesh, t):
    return t.cpu() if mesh.backend == "gloo" and t.is_cuda else t


def _pack(fields):
    """{name: [n, ...]} -> ({dtype: [n, K] buffer}, layout): the fields of
    one dtype side by side in one buffer (bool as uint8), so that a dict
    of ~20 fields travels in a few collectives."""
    groups = {}
    for name, a in fields.items():
        w = a.to(torch.uint8) if a.dtype == torch.bool else a
        groups.setdefault(w.dtype, []).append(
            (name, a.dtype, a.shape[1:], w.reshape(a.shape[0], -1)))
    bufs = {dt: torch.cat([c[3] for c in cols], dim=1)
            for dt, cols in groups.items()}
    layout = {dt: [c[:3] + (c[3].shape[1],) for c in cols]
              for dt, cols in groups.items()}
    return bufs, layout


def _unpack(bufs, layout, order, n_rows):
    out = dict.fromkeys(order)
    for dt, cols in layout.items():
        off = 0
        for name, dtype, shape, k in cols:
            a = bufs[dt][:, off:off + k].reshape((n_rows,) + shape)
            out[name] = (a.to(torch.bool) if dtype == torch.bool
                         else a.contiguous())
            off += k
    return out


def all_gather_rows(mesh: Mesh, fields):
    """Every rank's rows of a dict of [n, ...] tensors (n the same on
    every rank), rank-major: [size * n, ...], rank d's rows at
    [d * n, (d + 1) * n)."""
    bufs, layout = _pack(fields)
    n = next(iter(fields.values())).shape[0]
    out = {}
    for dt, buf in bufs.items():
        src = _wire(mesh, buf)
        dst = torch.empty((mesh.size * n, buf.shape[1]), dtype=dt,
                          device=src.device)
        dist.all_gather_into_tensor(dst, src, group=mesh.group)
        out[dt] = dst.to(mesh.device)
    return _unpack(out, layout, fields, mesh.size * n)


def rotate(mesh: Mesh, fields):
    """One hop around the ring: send this rank's dict of tensors to rank
    + 1 and return rank - 1's (the same shapes on every rank)."""
    if mesh.size == 1:
        return fields
    bufs, layout = _pack(fields)
    ops, got = [], {}
    for dt, buf in bufs.items():
        src = _wire(mesh, buf)
        got[dt] = torch.empty_like(src)
        ops += [dist.P2POp(dist.isend, src, (mesh.rank + 1) % mesh.size,
                           mesh.group),
                dist.P2POp(dist.irecv, got[dt], (mesh.rank - 1) % mesh.size,
                           mesh.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    n = next(iter(fields.values())).shape[0]
    return _unpack({dt: b.to(mesh.device) for dt, b in got.items()},
                   layout, fields, n)


def all_reduce_sum(mesh: Mesh, stats):
    """A dict of integer scalars summed over the ranks (int64 tensors)."""
    names = list(stats)
    v = torch.stack([torch.as_tensor(stats[k], device=mesh.device)
                     .to(torch.int64) for k in names])
    w = _wire(mesh, v)
    dist.all_reduce(w, group=mesh.group)
    w = w.to(mesh.device)
    return {k: w[i] for i, k in enumerate(names)}
