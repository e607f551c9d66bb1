"""Batch-shaped random draws that a data-parallel rank shares with one process.

JAX's SPMD step draws each random tensor at the global batch and XLA
partitions it; here each rank holds only its rows, so a rank draws the way
one process drawing the whole batch does and keeps its share:

- ``ShardGenerator`` is a ``torch.Generator`` that knows its rank and the
  number of ranks; every rank seeds it alike;
- ``draw_rows`` draws a tensor whose leading axis is the batch at the
  global batch and cuts out this rank's rows.

Every batch-shaped draw of the trainer (t, noise, the label drop, dropout's
keep masks) goes through ``draw_rows``: a draw that does not makes the
ranks' generators, and then their rows, part from one process's. A plain
``torch.Generator`` is one rank of one. The cost: each rank draws R times
its own rows and keeps one R-th of them.

``draw_frames`` is the horizon's counterpart, for sequence-sharded
sampling: rank r of R along the horizon draws the (B, R·H, ...) tensor one
process draws and keeps frames [r·H, (r+1)·H), so the noise of a sharded
chain is the one-process chain's noise.
"""
from __future__ import annotations

import torch


class ShardGenerator(torch.Generator):
    """A ``torch.Generator`` of rank ``rank`` of ``world`` data-parallel ranks.
    Every rank seeds it alike; ``draw_rows`` then draws each batch-shaped
    tensor at the global batch and keeps this rank's rows."""

    def __new__(cls, device="cpu", rank: int = 0, world: int = 1):
        return super().__new__(cls, device=device)

    def __init__(self, device="cpu", rank: int = 0, world: int = 1):
        self.rank, self.world = rank, world


def draw_rows(generator: torch.Generator, shape, draw):
    """``draw(shape)``, a draw from ``generator`` whose leading axis is the
    batch. With a ``ShardGenerator`` of R ranks it is drawn at R x the rows
    and cut to this rank's share, so the generator advances as one process
    drawing the global batch advances it and the rows are that process's."""
    world = getattr(generator, "world", 1)
    if world == 1:
        return draw(tuple(shape))
    n = shape[0]
    rank = generator.rank
    return draw((n * world, *shape[1:]))[rank * n:(rank + 1) * n]


def draw_frames(generator: torch.Generator, shape, draw, rank: int, world: int):
    """``draw(shape)`` for rank ``rank`` of ``world`` ranks along the horizon
    (dim 1): drawn at the global horizon, ``world`` x ``shape[1]`` frames
    (through ``draw_rows``, so a ``ShardGenerator``'s rows are cut too), and
    cut to this rank's frames. The generator advances as one process's."""
    if world == 1:
        return draw_rows(generator, shape, draw)
    n = shape[1]
    whole = draw_rows(generator, (shape[0], n * world, *shape[2:]), draw)
    return whole[:, rank * n:(rank + 1) * n]
