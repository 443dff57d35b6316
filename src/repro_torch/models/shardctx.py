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

The serving cache's latents split on the sequence (MLA,
``core/sharding.py::latents_split``): the server installs the group with
``use(group, latents=True)``, :func:`latent_group` gives it to
``mla_block``, whose decode is a distributed flash-decoding over two plain
collectives (decode takes no gradient, so neither is an autograd
Function; each refuses a call under grad):

  gather_heads        this rank's heads of the absorbed query, gathered
                      to every head (an all-gather on the head dimension)
  combine_softmax     each rank's partial softmax over its rows (max,
                      sum of exponentials, weighted sum of values) merged
                      over the group and scattered to each rank's heads

The sequence group (DeepSpeed-Ulysses, ``core/ulysses.py``): the engine
installs the same M ranks with :func:`use_sequence` instead, and the TP
operators above stay the identity (the weights are whole on every rank).
:func:`split_sequence` gives a forward's :class:`SeqSplit`, rank m's
contiguous rows of S (``torch.tensor_split``'s sizes: the first S mod M
ranks take one row more), and three operators move rows:

  seq_to_heads        (B, S_m, H, hd) -> (B, S, H/M, hd): every rank's
                      rows of this rank's heads (an all-to-all); its
                      backward is heads_to_seq
  heads_to_seq        the inverse; its backward is seq_to_heads
  gather_seq          (B, S_m, ...) -> (B, S, ...), every rank's rows; the
                      backward takes this rank's rows of the gradient, with
                      no collective (for what every rank then computes
                      whole and alike: the ViT's final norm and head)
  all_gather_seq      the same forward; its backward sums the ranks'
                      gradients of the whole rows and keeps this rank's (a
                      reduce-scatter), for rows each rank uses for its own
                      part of the work (the MoE's experts)
  reduce_scatter_seq  (B, S, ...) partial sums -> (B, S_m, ...), the sum
                      over the group of this rank's rows; its backward is
                      all_gather_seq's forward

Models never import ``repro_torch.core``, so this lives under models/ and
reads the group's ``rank``, ``size``, ``all_reduce``, ``all_gather_many``,
``reduce_scatter_many`` and ``all_to_all`` by duck typing.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

_GROUP = None
_SEQ = None
_LATENTS = False


def active():
    """The installed model group if it has more than one rank, else
    None: where the operators below are not the identity."""
    return _GROUP if _GROUP is not None and _GROUP.size > 1 else None


@contextlib.contextmanager
def use(group, latents: bool = False):
    """Install ``group`` (a World, or None) for the forwards (and the
    backwards' recomputes) run inside; ``latents``: the serving cache's
    MLA latents are split on the sequence over it (:func:`latent_group`)."""
    global _GROUP, _LATENTS
    prev, _GROUP, _LATENTS = (_GROUP, _LATENTS), group, latents
    try:
        yield
    finally:
        _GROUP, _LATENTS = prev


def latent_group():
    """The installed model group where the serving cache's latents are
    split on the sequence over it, else None (no group, a group of one, a
    whole cache, or a block run whole with the group lifted)."""
    return active() if _LATENTS else None


def _no_grad(what):
    if torch.is_grad_enabled():
        raise RuntimeError(f"{what} is decode-only and takes no gradient: "
                           f"run it under torch.inference_mode()")


def gather_heads(xs, group):
    """Each of ``xs`` (B, S, H/M, ...), this rank's heads, gathered to
    (B, S, H, ...) over ``group`` in one all-gather (one per dtype)."""
    _no_grad("gather_heads")
    return group.all_gather_many([x.contiguous() for x in xs],
                                 [2] * len(xs))


def combine_softmax(mx, den, ctx, group):
    """Merge each rank's partial softmax over its own key rows into this
    rank's heads' whole one: ``mx`` (B, S, H) the rank's fp32 row maxima,
    ``den`` (B, S, H) its Σ exp(s − mx), ``ctx`` (B, S, H, R) its
    Σ exp(s − mx)·value. One all-reduce of the maxima (``mx_all =
    max_m mx_m``), then one reduce-scatter on the head dimension of
    ``ctx·e^{mx − mx_all}`` and ``den·e^{mx − mx_all}``: the sums over
    the ranks of this rank's H/M heads, (B, S, H/M, R) and (B, S, H/M).
    The reduce-scatter moves each rank only its heads' sums, where an
    all-reduce and a slice would move every head's. A rank whose rows are
    all masked (scores at the finite ``NEG_INF``) has ``mx`` = NEG_INF, so
    its factor e^{NEG_INF − mx_all} is exactly 0 and its share vanishes."""
    _no_grad("combine_softmax")
    f = torch.exp(mx - group.all_reduce(mx.clone(), "max"))
    return group.reduce_scatter_many([ctx * f[..., None], den * f], [2, 2])


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


# --- the sequence group (Ulysses) -----------------------------------------


def sequence():
    """The installed sequence group if it has more than one rank, else
    None."""
    return _SEQ if _SEQ is not None and _SEQ.size > 1 else None


@contextlib.contextmanager
def use_sequence(group):
    """Install ``group`` (a World, or None) as the sequence group for the
    forwards (and the backwards' recomputes) run inside."""
    global _SEQ
    prev, _SEQ = _SEQ, group
    try:
        yield
    finally:
        _SEQ = prev


def seq_split(s: int, m: int) -> list:
    """The rows of each of ``m`` ranks of a sequence of ``s``: contiguous,
    the first ``s % m`` ranks one row more (``torch.tensor_split``)."""
    return [s // m + (r < s % m) for r in range(m)]


class SeqSplit(NamedTuple):
    """A forward's split of its S rows over the sequence group."""
    group: object
    sizes: list

    @property
    def rows(self) -> slice:
        """This rank's rows."""
        lo = sum(self.sizes[:self.group.rank])
        return slice(lo, lo + self.sizes[self.group.rank])


def split_sequence(s: int):
    """The :class:`SeqSplit` of ``s`` rows over the installed sequence
    group, or None without one."""
    group = sequence()
    return None if group is None else SeqSplit(group,
                                               seq_split(s, group.size))


def _seq_to_heads(x, split):
    g, m = split.group, split.group.size
    b, n, h, d = x.shape
    blocks = x.reshape(b, n, m, h // m, d).movedim(2, 0).unbind(0)
    return torch.cat(g.all_to_all(list(blocks), [(b, s, h // m, d)
                                                 for s in split.sizes]), 1)


def _heads_to_seq(y, split):
    g, m = split.group, split.group.size
    b, _, hm, d = y.shape
    n = split.sizes[g.rank]
    recv = g.all_to_all(list(y.split(split.sizes, 1)), [(b, n, hm, d)] * m)
    return torch.stack(recv, 2).reshape(b, n, m * hm, d)


def _gather_rows(x, split):
    """Every rank's rows (B, S_m, ...) joined in rank order: one
    all-to-all that sends each rank this rank's rows."""
    rest = tuple(x.shape[2:])
    recv = split.group.all_to_all(
        [x] * split.group.size,
        [(x.shape[0], s) + rest for s in split.sizes])
    return torch.cat(recv, 1)


def _scatter_rows(y, split):
    """The sum over the group of this rank's rows of every rank's (B, S,
    ...): one all-to-all of each rank's block of rows to its owner, then
    the blocks summed in rank order."""
    g = split.group
    b, n, rest = y.shape[0], split.sizes[g.rank], tuple(y.shape[2:])
    recv = g.all_to_all(list(y.split(split.sizes, 1)),
                        [(b, n) + rest] * g.size)
    return torch.stack(recv).sum(0)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return _seq_to_heads(x, split)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.split), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, split):
        ctx.split = split
        return _heads_to_seq(y, split)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.split), None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return _gather_rows(x, split)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.split.rows].contiguous(), None


class _AllGatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return _gather_rows(x, split)

    @staticmethod
    def backward(ctx, g):
        return _scatter_rows(g, ctx.split), None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, split):
        ctx.split = split
        return _scatter_rows(y, split)

    @staticmethod
    def backward(ctx, g):
        return _gather_rows(g.contiguous(), ctx.split), None


def seq_to_heads(x, split):
    """(B, S_m, H, hd), this rank's rows of every head -> (B, S, H/M, hd),
    every row of this rank's heads ``[m·H/M, (m+1)·H/M)``."""
    return _SeqToHeads.apply(x, split)


def heads_to_seq(y, split):
    """(B, S, H/M, hd) -> (B, S_m, H, hd): :func:`seq_to_heads` undone."""
    return _HeadsToSeq.apply(y, split)


def gather_seq(x, split):
    """(B, S_m, ...) -> (B, S, ...): every rank's rows, in rank order."""
    return _GatherSeq.apply(x, split)


def all_gather_seq(x, split):
    """(B, S_m, ...) -> (B, S, ...): every rank's rows, as
    :func:`gather_seq`; the backward is a reduce-scatter (each rank's
    gradient of the whole rows is its own part, summed over the group)."""
    return _AllGatherSeq.apply(x, split)


def reduce_scatter_seq(y, split):
    """(B, S, ...) -> (B, S_m, ...): this rank's rows of ``y`` summed over
    the group (each rank's ``y`` a partial sum); the backward gathers the
    gradient's rows from every rank."""
    return _ReduceScatterSeq.apply(y, split)
