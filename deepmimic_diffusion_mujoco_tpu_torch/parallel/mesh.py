"""Process groups, the device mesh and a data-parallel rank's share of a batch.

Counterpart of ``deepmimic_diffusion_mujoco_tpu/parallel/mesh.py`` on
``torch.distributed``. JAX's SPMD step sees one global batch that XLA
shards; here each process (a rank) holds its own rows, so the contract is
written out:

- ``initialize_multihost`` starts the process group on the backend that
  ``default_backend`` names (NCCL where each rank on this host has a card
  of its own; gloo on the CPU and where ranks share cards, which NCCL
  refuses), or on the backend it is given;
- ``make_mesh`` is the ("data", "seq") ``DeviceMesh`` over the group;
- ``shard_batch`` cuts this rank's equal rows out of the global batch that
  every rank builds the same way (JAX's multi-host feeding contract);
- ``all_gather_rows`` puts every rank's rows together in rank order,
  exactly, on gloo with CUDA tensors too (gloo has no CUDA all_gather);
- ``all_reduce_mean`` averages tensors over the ranks in one all_reduce.

Random draws shaped by the batch are ``utils.rng``'s (``draw_rows``): each
rank draws at the global batch and keeps its rows.

``seq_sharding`` (the horizon over the mesh's "seq" axis) raises: the
port's conv blocks compute GroupNorm over the whole horizon inside one
kernel (B1), so a horizon split needs partial statistics out of the kernel
and an all_reduce between two launches.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from ..device import resolve_device


def default_backend(device: torch.device, local_ranks: int) -> str:
    """The backend for ``local_ranks`` ranks on this host on ``device``'s
    type: NCCL when each has a CUDA card of its own, gloo on the CPU and
    when they outnumber the cards (rank r takes card r modulo the cards, and
    NCCL refuses two ranks on one device). Nothing falls back from one to
    the other once a group is up."""
    if device.type != "cuda" or local_ranks > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def initialize_multihost(coordinator: str | None = None, num_processes: int | None = None,
                         process_id: int | None = None, backend: str | None = None,
                         device: str | torch.device = "cuda") -> bool:
    """Join this process to the group of ``num_processes`` ranks, as rank
    ``process_id``, rendezvousing at ``coordinator`` (``host:port``, or any
    ``torch.distributed`` init method: ``tcp://``, ``file://``, ``env://``).
    ``backend`` defaults to ``default_backend`` of the ranks on this host:
    ``LOCAL_WORLD_SIZE`` where the launcher sets it (``torchrun`` does),
    else all ``num_processes``. A CUDA ``device`` with an index becomes
    this process's current device first; a CUDA ``device`` without a card
    raises. Returns whether it started the group: False when one exists
    already, or when neither a coordinator nor a process count is given
    (one process, as JAX's)."""
    if dist.is_initialized() or (coordinator is None and num_processes is None):
        return False
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    init = coordinator or "env://"
    if "://" not in init:
        init = f"tcp://{init}"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes or 1))
    dist.init_process_group(backend or default_backend(dev, local),
                            init_method=init, world_size=num_processes, rank=process_id)
    return True


def rank_and_world(group=None) -> tuple[int, int]:
    """(this rank, ranks) in ``group``, a process group or a mesh's "data"
    dimension; (0, 1) for None."""
    group = data_group(group)
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def data_group(group_or_mesh):
    """The process group of ``group_or_mesh``: a ``DeviceMesh``'s "data"
    dimension, or the group itself (None stays None)."""
    get_group = getattr(group_or_mesh, "get_group", None)
    if get_group is None:
        return group_or_mesh
    names = group_or_mesh.mesh_dim_names or ()
    return get_group("data") if "data" in names else get_group()


def make_mesh(data: int | None = None, seq: int = 1, device_type: str = "cuda"):
    """The ("data", "seq") ``DeviceMesh`` over every rank of the initialised
    group, all of them on ``data`` by default."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_multihost first")
    world = dist.get_world_size()
    if data is None:
        data = world // seq
    if data * seq != world:
        raise ValueError(f"mesh {data}x{seq} != {world} ranks")
    return init_device_mesh(device_type, (data, seq), mesh_dim_names=("data", "seq"))


def batch_sharding(mesh):
    """DTensor placements of a batch whose leading axis is split over "data"."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate()) if mesh.ndim == 2 else (Shard(0),)


def replicated(mesh):
    """DTensor placements of a tensor every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def seq_sharding(mesh):
    raise NotImplementedError(
        "seq_sharding (the horizon over the mesh's seq axis) is not ported: ROADMAP.md "
        "Queue A, seq-sharded sampling (B1 computes GroupNorm over the whole horizon in one "
        "launch; a split needs its partial statistics and an all_reduce between launches)")


def shard_batch(group, batch):
    """This rank's equal share of the rows of ``batch``, a pytree (a
    ``Batch``, tuple, dict) of arrays or tensors with the GLOBAL batch's
    rows, which every rank builds the same way: rank r of R keeps rows
    [r·n/R, (r+1)·n/R). ``group`` None keeps every row."""
    rank, world = rank_and_world(group)

    def rows(a):
        n = a.shape[0]
        if n % world:
            raise ValueError(f"a batch of {n} rows does not split over {world} ranks")
        k = n // world
        return a[rank * k:(rank + 1) * k]

    return batch if world == 1 else tree_map(rows, batch)


def all_gather_rows(parts, group):
    """Every rank's ``parts`` (tensors on one device whose leading axis is
    this rank's rows, the same shapes on every rank) concatenated in rank
    order, on every rank. Each rank writes its rows into a zero buffer of
    the global shape and one all_reduce(SUM) adds the buffers: adding zeros
    is exact, and float64 holds every float32 and every integer below 2**53
    exactly, so the result is the rows' own values (a -0.0 comes back as
    0.0). Gloo reduces CUDA tensors but does not all_gather them."""
    rank, world = rank_and_world(group)
    flat = [p.reshape(p.shape[0], -1) for p in parts]
    widths = [f.shape[1] for f in flat]
    n = flat[0].shape[0]
    buf = torch.zeros((world * n, sum(widths)), dtype=torch.float64, device=flat[0].device)
    buf[rank * n:(rank + 1) * n] = torch.cat([f.to(torch.float64) for f in flat], dim=1)
    dist.all_reduce(buf, group=data_group(group))
    return [b.to(p.dtype).reshape(world * n, *p.shape[1:])
            for b, p in zip(buf.split(widths, dim=1), parts)]


def all_reduce_mean(tensors, group):
    """Replace each of ``tensors`` (one dtype, one device) in place by its
    mean over the ranks: one all_reduce of their concatenation. Every rank
    gets the same bits."""
    _, world = rank_and_world(group)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=data_group(group))
    flat /= world
    torch._foreach_copy_(list(tensors), [f.view_as(t) for f, t in
                                         zip(flat.split([t.numel() for t in tensors]), tensors)])
