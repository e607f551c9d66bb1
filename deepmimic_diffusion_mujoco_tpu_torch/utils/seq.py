"""The horizon split of sequence-sharded sampling, as the models see it.

JAX shards the horizon by a layout constraint (``x_sharding``) and XLA's
partitioner inserts the halo exchanges and cross-shard sums. Here each rank
of a "seq" group holds frames ``[offset, offset + frames)`` of an ``H``-frame
trajectory and the models exchange what they need themselves. They do it
through a shard object (``parallel.mesh.SeqSharding``) with

- ``rank``, ``world``: this rank and the ranks of the seq group;
- ``exchange_halo(x, before, after)``: ``(x_before, x_after, (real_before,
  real_after))``, the neighbours' rows along dim 1, zero rows at the
  trajectory's ends, and which of the two edges are real;
- ``all_gather(t)``: ``(world, *t.shape)``, every rank's ``t`` exactly;
- ``all_reduce(t, op)``: ``t`` summed (``"sum"``) or maxed (``"max"``) over
  the ranks, in place;
- ``gather_horizon(x)``: the whole horizon from every rank's frames.

``sample_loop(..., x_sharding=...)`` makes its shard the active one around
the chain (``sharded``); ``TemporalUnet`` and ``LocalTransformer`` read it
(``active``) at the top of their forward. The models and kernels' wrappers
import nothing of ``torch.distributed``: the shard carries the collectives.
"""
from __future__ import annotations

import contextlib
import contextvars

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("seq_shard", default=None)


def active():
    """The active shard of a horizon split over more than one rank, else None."""
    shard = _ACTIVE.get()
    return shard if shard is not None and shard.world > 1 else None


@contextlib.contextmanager
def sharded(shard):
    """Make ``shard`` the active one inside the block (None: no split)."""
    token = _ACTIVE.set(shard)
    try:
        yield shard
    finally:
        _ACTIVE.reset(token)


def refuse_split(model: str):
    """Raise under an active horizon split: ``model`` has no sharded forward."""
    if active() is not None:
        raise NotImplementedError(
            f"sequence-sharded sampling of {model} is not ported (ROADMAP.md Queue A, seq "
            "sharding of the MDM transformer and the decoder: attention over K/V gathered "
            "along the horizon)")
