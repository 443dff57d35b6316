"""The model axis of the forward (the counterpart of
``repro/models/shardctx.py``).

The reference installs PartitionSpec hints here and lets GSPMD place the
collectives of its Megatron column/row split. The port splits explicitly:
the engine installs the model group (a ``core.distributed.World`` of the M
ranks that share a replica's layers) around a forward with :func:`use`,
and the layers call the three operators below, each a
``torch.autograd.Function`` over that group's collectives. With no group
installed (the default), or a group of one, every operator is the
identity, so a model runs unchanged on one rank.

  copy_to_model       the input of a column-parallel product: identity in
                      the forward, the gradient summed over the group in
                      the backward
  reduce_from_model   the output of a row-parallel product (a partial
                      sum on each rank): summed over the group in the
                      forward, identity in the backward
  gather_from_model   the last dimension's slices gathered whole in the
                      forward, this rank's slice of the gradient in the
                      backward

:func:`vocab_parallel_nll` is the cross-entropy of logits whose vocabulary
is split over the group (Megatron's vocab-parallel loss, in fp32).

Models never import ``repro_torch.core``, so this lives under models/ and
reads the group's ``rank``, ``size``, ``all_reduce`` and
``all_gather_many`` by duck typing.
"""
from __future__ import annotations

import contextlib

import torch

_GROUP = None


def active():
    """The installed model group if it has more than one rank, else
    None: where the operators below are not the identity."""
    return _GROUP if _GROUP is not None and _GROUP.size > 1 else None


@contextlib.contextmanager
def use(group):
    """Install ``group`` (a World, or None) for the forwards (and the
    backwards' recomputes) run inside."""
    global _GROUP
    prev, _GROUP = _GROUP, group
    try:
        yield
    finally:
        _GROUP = prev


def _sum(x, group):
    """A copy of ``x`` summed over ``group``."""
    return group.all_reduce(x.contiguous().clone(), "sum")


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_gather_many([x.contiguous()], [x.ndim - 1])[0]

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.group.size, -1)[ctx.group.rank].contiguous(), \
            None


def copy_to_model(x):
    group = active()
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x):
    group = active()
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_from_model(x):
    group = active()
    return x if group is None else _GatherFromModel.apply(x, group)


class _VocabParallelNLL(torch.autograd.Function):
    """``-log softmax(logits)[label]`` per row, the logits' last dimension
    this rank's vocabulary ``[lo, lo + V/M)``: the max over the group, the
    sum of ``exp`` all-reduced, the gold logit from the rank that holds it
    all-reduced. The backward is ``softmax - onehot`` on the local slice,
    times the incoming gradient."""

    @staticmethod
    def forward(ctx, logits, labels, group):
        x = logits.to(torch.float32)
        n = x.shape[-1]
        lo = group.rank * n
        m = group.all_reduce(x.amax(dim=-1), "max")
        e = torch.exp(x - m[..., None])
        se = group.all_reduce(e.sum(dim=-1), "sum")
        local = labels.long() - lo
        mine = (local >= 0) & (local < n)
        idx = torch.where(mine, local, 0)
        gold = torch.where(mine, x.gather(-1, idx[..., None])[..., 0], 0.0)
        gold = group.all_reduce(gold, "sum")
        ctx.save_for_backward(e, se, idx, mine)
        ctx.dtype = logits.dtype
        return m + torch.log(se) - gold

    @staticmethod
    def backward(ctx, g):
        e, se, idx, mine = ctx.saved_tensors
        grad = e / se[..., None]
        grad.scatter_add_(-1, idx[..., None],
                          -mine.to(grad.dtype)[..., None])
        return (grad * g[..., None]).to(ctx.dtype), None, None


def vocab_parallel_nll(logits, labels):
    """Per-row fp32 NLL of ``labels`` (global ids) under ``logits`` whose
    last dimension is this rank's chunk of the vocabulary, over the
    installed model group."""
    return _VocabParallelNLL.apply(logits, labels, active())
