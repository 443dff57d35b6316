"""The data x pipe rank layout (the counterpart of
``repro/launch/mesh.py::make_local_mesh(model, pipe)``).

The reference orders its mesh axes ``("data", "pipe", "model")``, so the
pipe index varies fastest: here rank ``r = d * S + p`` is pipeline stage
``p`` of data replica ``d``, for ``S`` stages and ``dp = W / S`` replicas of
a world of ``W`` ranks. Stage ``p``'s ranks form its data group (ZeRO runs
over it); replica ``d``'s ranks form its pipe group (activations and
cotangents move between them). A world of one process runs every stage
itself: it has no pipe group, and its data group is the world. The model
axis (tensor parallelism) is ROADMAP item 16 and is refused.
"""
from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.distributed import COLLECTIVE_TIMEOUT_S, World


@dataclass(frozen=True)
class Layout:
    """This rank's place in the data x pipe layout.

    data    the World ZeRO and the batch rows run over (this stage's data
            group; the whole world without a pipe)
    pipe    the World of this replica's pipeline stages (this rank's
            stage is its rank there), or None when this process runs
            every stage
    """
    data: World
    pipe: Optional[World]


def make_layout(world: World, pipe: int = 1, model: int = 1, *,
                timeout_s: float = COLLECTIVE_TIMEOUT_S) -> Layout:
    """The layout of ``world`` for ``pipe`` stages. Every rank calls it
    (``dist.new_group`` is collective). ``pipe`` 1 keeps the world as the
    data group; a world of one runs every stage itself; a larger world must
    be a multiple of ``pipe``."""
    if model != 1:
        raise ValueError(f"model axis {model}: tensor parallelism is not "
                         f"yet ported to repro_torch (ROADMAP item 16)")
    if pipe < 1:
        raise ValueError(f"pipe must be >= 1: {pipe}")
    if pipe == 1 or world.size == 1:
        return Layout(data=world, pipe=None)
    if world.size % pipe:
        raise ValueError(f"a world of {world.size} ranks is not a multiple "
                         f"of {pipe} pipeline stages")
    dp = world.size // pipe
    timeout = datetime.timedelta(seconds=timeout_s)
    d, p = divmod(world.rank, pipe)
    mine = {}
    # every rank makes every group, in the same order
    for dd in range(dp):
        ranks = [dd * pipe + q for q in range(pipe)]
        g = dist.new_group(ranks, timeout=timeout)
        if dd == d:
            mine["pipe"] = (g, ranks)
    for q in range(pipe):
        ranks = [dd * pipe + q for dd in range(dp)]
        g = dist.new_group(ranks, timeout=timeout)
        if q == p:
            mine["data"] = (g, ranks)
    data = world.subgroup(*mine["data"])
    pipe_world = world.subgroup(*mine["pipe"])
    # one collective on each group, with all its members, before any
    # point-to-point call (NCCL's rule for a group's first call)
    for w in (data, pipe_world):
        w.all_reduce(torch.zeros(1, device=world.device), "sum")
    return Layout(data=data, pipe=pipe_world)
