"""The data x pipe x model rank layout (the counterpart of
``repro/launch/mesh.py::make_local_mesh(model, pipe)``).

The reference orders its mesh axes ``("data", "pipe", "model")``, so the
model index varies fastest, then the pipe index: here rank ``r = (d * S +
p) * M + m`` is model rank ``m`` of pipeline stage ``p`` of data replica
``d``, for ``S`` stages, ``M`` model ranks and ``dp = W / (S * M)``
replicas of a world of ``W`` ranks. The ranks with the same ``(p, m)``
form a data group (ZeRO and the batch rows run over it); those with the
same ``(d, m)`` a pipe group (activations and cotangents move between
them); those with the same ``(d, p)`` a model group (tensor parallelism:
the Megatron column/row split of each layer, ``models/shardctx.py``). A
world of one process runs every stage itself and M = 1 only: it has no
pipe or model group, and its data group is the world. With both a pipe
and a model axis (Megatron-DeepSpeed's 3D layout) model rank m of stage p
hands its activations to model rank m of stage p + 1 over its pipe group.
"""
from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.distributed import COLLECTIVE_TIMEOUT_S, World


@dataclass(frozen=True)
class ProductionLayout:
    """The reference's production mesh: ``data`` x ``pipe`` x ``model``
    ranks (the pod axis folded into data, which it precedes in the
    reference's axis order ``("pod", "data", "pipe", "model")``)."""
    data: int
    pipe: int
    model: int

    @property
    def size(self) -> int:
        return self.data * self.pipe * self.model


def production_layout(multi_pod: bool = False, pipe: int = 1
                      ) -> ProductionLayout:
    """16 x 16 = 256 ranks (data 16, model 16), the pipe axis carved out of
    the data axis, or with ``multi_pod`` two pods: data 32 x model 16 =
    512 (``make_production_mesh``)."""
    if pipe < 1 or 16 % pipe:
        raise ValueError(f"pipe {pipe} does not divide the data axis 16")
    return ProductionLayout(data=16 // pipe * (2 if multi_pod else 1),
                            pipe=pipe, model=16)


def group_ranks(size: int, pipe: int = 1, model: int = 1) -> dict:
    """``{"pipe": [...], "data": [...], "model": [...]}``: the global ranks
    of every group of a world of ``size`` laid out data x ``pipe`` x
    ``model`` (rank ``(d * pipe + p) * model + m``), in the order every
    rank makes them; no pipe (model) groups for ``pipe`` (``model``) 1."""
    dp = size // (pipe * model)

    def rank(dd, pp, mm):
        return (dd * pipe + pp) * model + mm
    return {
        "pipe": [[rank(dd, q, mm) for q in range(pipe)]
                 for dd in range(dp) for mm in range(model)]
        if pipe > 1 else [],
        "data": [[rank(dd, q, mm) for dd in range(dp)]
                 for q in range(pipe) for mm in range(model)],
        "model": [[rank(dd, q, mm) for mm in range(model)]
                  for dd in range(dp) for q in range(pipe)]
        if model > 1 else [],
    }


def layout_ranks(size: int, rank: int, pipe: int = 1, model: int = 1
                 ) -> dict:
    """``{"data": ranks, "pipe": ranks or None, "model": ranks or None}``:
    the global ranks of rank ``rank``'s groups (see :func:`group_ranks`)."""
    return {name: next((g for g in groups if rank in g), None)
            for name, groups in group_ranks(size, pipe, model).items()}


@dataclass(frozen=True)
class Layout:
    """This rank's place in the data x pipe x model layout.

    data    the World ZeRO and the batch rows run over (the ranks of this
            rank's stage and model rank; the whole world without a pipe
            or a model axis)
    pipe    the World of this replica's pipeline stages (this rank's
            stage is its rank there), or None when this process runs
            every stage
    model   the World of the M ranks that split this replica's layers
            (tensor parallelism), or None for M = 1
    """
    data: World
    pipe: Optional[World]
    model: Optional[World] = None


def make_layout(world: World, pipe: int = 1, model: int = 1, *,
                timeout_s: float = COLLECTIVE_TIMEOUT_S) -> Layout:
    """The layout of ``world`` for ``pipe`` stages and ``model`` model
    ranks. Every rank calls it (``dist.new_group`` is collective).
    ``pipe`` and ``model`` 1 keep the world as the data group; a world of
    one runs every stage itself and needs ``model`` 1; a larger world must
    be a multiple of ``pipe * model``."""
    if pipe < 1 or model < 1:
        raise ValueError(f"pipe and model must be >= 1: {pipe}, {model}")
    if world.size == 1:
        if model != 1:
            raise ValueError(f"model axis {model} on a world of one rank: "
                             f"tensor parallelism needs {model} ranks")
        return Layout(data=world, pipe=None)
    if pipe == 1 and model == 1:
        return Layout(data=world, pipe=None)
    if world.size % (pipe * model):
        raise ValueError(
            f"a world of {world.size} ranks is not a multiple of {pipe} "
            f"pipeline stages" + (f" x {model} model ranks (tensor "
                                  f"parallelism, ROADMAP item 16.1)"
                                  if model > 1 else ""))
    me = world.global_rank(world.rank)
    if world.recording:
        groups = {name: world.subgroup(None, ranks) for name, ranks in
                  layout_ranks(world.size, me, pipe, model).items()
                  if ranks is not None}
    else:
        timeout = datetime.timedelta(seconds=timeout_s)
        # every rank makes every group, in the same order: pipe, data,
        # model
        groups = {}
        for name, ranks_list in group_ranks(world.size, pipe,
                                            model).items():
            for ranks in ranks_list:
                g = dist.new_group(ranks, timeout=timeout)
                if me in ranks:
                    groups[name] = world.subgroup(g, ranks)
    # one collective on each group, with all its members, before any
    # point-to-point call (NCCL's rule for a group's first call)
    for w in groups.values():
        w.all_reduce(torch.zeros(1, device=world.device), "sum")
    return Layout(data=groups["data"], pipe=groups.get("pipe"),
                  model=groups.get("model"))
