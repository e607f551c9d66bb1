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

The horizon over the mesh's "seq" dimension (sequence-sharded sampling):

- ``seq_sharding(mesh)`` is the layout of a (B, H, D) trajectory, rows over
  "data" and frames over "seq" (JAX's ``P("data", "seq", None)``), and the
  shard object the models exchange their halos through
  (``utils.seq``); ``sample_loop(..., x_sharding=...)`` takes it;
- ``seq_group`` is a mesh's seq group, ``shard_horizon`` this rank's frames
  ``[r·H/R, (r+1)·H/R)``, ``gather_horizon`` the whole horizon back, exactly;
- ``exchange_halo`` brings the rows each rank needs from its neighbours,
  zero rows at the trajectory's ends, with flags for the real edges.

Like ``all_gather_rows`` these move data through one float64 all_reduce of a
zero buffer, which is exact and runs on gloo with CUDA tensors.
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


def seq_group(mesh):
    """The process group of a ``DeviceMesh``'s "seq" dimension; a process
    group passes through (None stays None)."""
    get_group = getattr(mesh, "get_group", None)
    return mesh if get_group is None else get_group("seq")


def _seq_rank_world(group) -> tuple[int, int]:
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _all_gather_exact(t, group, rank: int, world: int):
    """(world, *t.shape): every rank's ``t`` (one shape on every rank) in
    rank order, on every rank, in ``t``'s dtype. Each rank writes its ``t``
    into its slot of a float64 zero buffer and one all_reduce(SUM) adds the
    buffers: adding zeros is exact, and float64 holds every float32 and
    every integer below 2**53 exactly, so the result is the ranks' own
    values (a -0.0 comes back as 0.0). Gloo reduces CUDA tensors but does
    not all_gather them."""
    buf = torch.zeros((world, *t.shape), dtype=torch.float64, device=t.device)
    buf[rank] = t.to(torch.float64)
    dist.all_reduce(buf, group=group)
    return buf.to(t.dtype)


def shard_horizon(x, group):
    """This rank's frames ``[r·H/R, (r+1)·H/R)`` of ``x`` (dim 1 the horizon)
    over the seq ``group`` (a process group or a mesh)."""
    rank, world = _seq_rank_world(seq_group(group))
    H = x.shape[1]
    if H % world:
        raise ValueError(f"a horizon of {H} frames does not split over {world} ranks")
    n = H // world
    return x[:, rank * n:(rank + 1) * n]


def gather_horizon(x, group):
    """Every rank's frames (dim 1; equal counts) concatenated in rank order,
    on every rank, exactly (a -0.0 comes back as 0.0)."""
    group = seq_group(group)
    rank, world = _seq_rank_world(group)
    if world == 1:
        return x
    return torch.cat(_all_gather_exact(x, group, rank, world).unbind(0), dim=1)


def exchange_halo(x, before: int, after: int, group):
    """The rows each rank needs from its neighbours along dim 1: the last
    ``before`` frames of rank r - 1 and the first ``after`` frames of rank
    r + 1. -> ``(x_before, x_after, (real_before, real_after))``, zero rows
    where the neighbour would lie past the trajectory's ends, whose flags
    are False. One exact all_reduce of every rank's two edges."""
    group = seq_group(group)
    rank, world = _seq_rank_world(group)
    n = x.shape[1]
    if before > n or after > n:
        raise ValueError(f"a halo of {before} + {after} rows needs more than one neighbour's "
                         f"{n} frames (multi-hop halos are not taken)")
    B, rest = x.shape[0], x.shape[2:]
    zeros = (x.new_zeros((B, before, *rest)), x.new_zeros((B, after, *rest)))
    if world == 1:
        return zeros[0], zeros[1], (False, False)
    edges = _all_gather_exact(torch.cat([x[:, n - before:], x[:, :after]], dim=1), group, rank,
                              world)
    x_before = edges[rank - 1, :, :before] if rank > 0 else zeros[0]
    x_after = edges[rank + 1, :, before:] if rank < world - 1 else zeros[1]
    return x_before, x_after, (rank > 0, rank < world - 1)


class SeqSharding:
    """The layout of a (B, H, D) trajectory over a ("data", "seq") mesh, or
    over a process group taken as the seq group: rows over "data", frames
    over "seq". It is also the shard object of ``utils.seq``: the
    collectives of the seq group that the models call."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.group = seq_group(mesh)
        self.rank, self.world = _seq_rank_world(self.group)
        has_data = "data" in (getattr(mesh, "mesh_dim_names", None) or ())
        self.data_rank, self.data_world = rank_and_world(mesh) if has_data else (0, 1)

    @property
    def placements(self):
        """DTensor placements of the trajectory over the mesh's dimensions."""
        from torch.distributed.tensor import Shard

        return (Shard(0), Shard(1)) if getattr(self.mesh, "ndim", 1) == 2 else (Shard(1),)

    def local_shape(self, shape) -> tuple:
        """This rank's share of a global ``shape`` (B, H, ...)."""
        B, H = shape[0], shape[1]
        if B % self.data_world or H % self.world:
            raise ValueError(f"shape {tuple(shape)} does not split {self.data_world} x "
                             f"{self.world} ways (rows over data, frames over seq)")
        return (B // self.data_world, H // self.world, *shape[2:])

    def frames(self, horizon: int) -> tuple[int, int]:
        """[lo, hi): this rank's frames of a ``horizon``-frame trajectory."""
        n = horizon // self.world
        return self.rank * n, (self.rank + 1) * n

    def rows(self, x):
        """This rank's rows of a tensor whose dim 0 is the global batch."""
        n = x.shape[0] // self.data_world
        return x[self.data_rank * n:(self.data_rank + 1) * n]

    def shard(self, x):
        """This rank's rows and frames of a global (B, H, ...) tensor."""
        return shard_horizon(self.rows(x), self.group)

    def gather(self, x):
        """The global (B, H, ...) tensor from every rank's share, exactly."""
        whole = gather_horizon(x, self.group)
        if self.data_world == 1:
            return whole
        return all_gather_rows([whole], self.mesh)[0]

    def exchange_halo(self, x, before: int, after: int):
        return exchange_halo(x, before, after, self.group)

    def gather_horizon(self, x):
        return gather_horizon(x, self.group)

    def all_gather(self, t):
        """(world, *t.shape): every rank's ``t``, exactly."""
        return _all_gather_exact(t, self.group, self.rank, self.world)

    def all_reduce(self, t, op: str = "sum"):
        """``t`` replaced in place by its sum (in float64, in rank order) or
        max over the ranks: every rank gets the same bits."""
        parts = self.all_gather(t).to(torch.float64)
        if op == "sum":
            total = parts.sum(dim=0)
        elif op == "max":
            total = parts.amax(dim=0)
        else:
            raise ValueError(f"all_reduce op {op!r}: 'sum' or 'max'")
        t.copy_(total.to(t.dtype))
        return t


def seq_sharding(mesh) -> SeqSharding:
    """(B, H, D) with the batch over the mesh's "data" dimension and the
    horizon over its "seq" dimension (JAX's ``seq_sharding``):
    ``sample_loop(..., x_sharding=seq_sharding(mesh))`` runs the chain with
    each rank holding its H / seq frames."""
    return SeqSharding(mesh)


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
    order, on every rank, exactly: one all_reduce of a float64 zero buffer
    (``_all_gather_exact``)."""
    rank, world = rank_and_world(group)
    flat = [p.reshape(p.shape[0], -1).to(torch.float64) for p in parts]
    widths = [f.shape[1] for f in flat]
    n = flat[0].shape[0]
    whole = _all_gather_exact(torch.cat(flat, dim=1), data_group(group), rank, world)
    return [b.to(p.dtype).reshape(world * n, *p.shape[1:])
            for b, p in zip(whole.reshape(world * n, -1).split(widths, dim=1), parts)]


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
