"""Mixture-of-Experts (``repro.models.moe``): a token-choice top-k router,
GShard-style einsum dispatch and combine, the gather-based dispatch,
shared experts and the switch-style load-balance aux loss.

The reference's MoE is plain XLA (no Pallas kernel), so its einsums and
gathers stay ``torch.einsum`` and indexing here. The router runs in fp32;
dispatch and combine are cast to the compute dtype before the expert
products. Top-k takes the first k of a stable descending sort, so tied
probabilities go to the lower expert index, as ``lax.top_k`` does; the
gates are the softmax over all experts, not renormalised.

``reduce``, when given, maps the router's fraction of tokens per expert
(``me``, an fp32 E-vector without gradient) to its mean over the
data-parallel ranks. Each rank then computes ``E·Σ me_global·ce_local``,
whose mean over the ranks, and whose averaged gradient, are the
reference's aux over the global batch (GSPMD takes ``jnp.mean`` over the
sharded batch axis there).

Expert parallelism (``models/shardctx.py``): under a model group of M
ranks each rank holds E/M experts (the reference's ``"model"`` on the
experts' E axis) and the shared experts' column/row chunks. The ranks of
a group see the same tokens, so no all-to-all is needed: every rank
routes all of them with the whole router, takes its experts' part of the
dispatch (GShard's (B,S,E,C), or the gather's (E,C) slot table) at the
capacity one rank would count, runs them, combines only their outputs
and sums the partial outputs over the group (``reduce_from_model``). The
router's gradient is then each rank's share (summed by the engine), and
the load-balance aux, the same value on every rank, keeps its gradient on
model rank 0 only, so the sum counts it once. Collectives a layer: the
copy's all-reduce of the input's gradient (backward) and the sum of the
outputs (forward), B·S·d elements of the compute dtype each.

Under the Ulysses layout (a ``shardctx.SeqSplit`` as ``seq``,
``core/ulysses.py``) each rank holds its rows of the sequence and E/M
experts (every expert where M does not divide E), the rest whole. The
MoE gathers the rows over the sequence group (``all_gather_seq``: every
rank then sees the data rank's whole (B, S, d)), routes every token with
the whole fp32 router at the capacity one process counts, runs this
rank's experts, combines only their outputs and reduce-scatters the
partial sums onto the rank's rows (``reduce_scatter_seq``; with every
expert on every rank, the output's rows are the rank's own and need no
collective); shared experts run on the rank's rows. The routings are one
process's. Collectives a layer: the gather and the reduce-scatter in the
forward and each the other's in the backward, B·S·d elements of the
compute dtype received by each rank for each (all-to-alls, as the rows
split unevenly). The router's gradient is each rank's share (the engine
sums it over the group), and the aux enters the loss, value and
gradient, on model rank 0 only (the engine sums a rank's loss and
metrics over the group).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import shardctx
from repro_torch.models.params import dense_init


def init_moe(cfg, layers, **kw):
    """The MoE params of ``layers`` layers, stacked on a leading L axis,
    keyed as the reference's ``init_moe`` (``moe.py:16-35``): the router
    (d, E) at scale 0.02, the experts (E, d, f) and (E, f, d), and with
    ``num_shared_experts`` the shared SwiGLU of width f·ns."""
    m, d, L = cfg.moe, cfg.d_model, layers
    e, f = m.num_experts, m.d_ff_expert
    p = {
        "router": dense_init((L, d, e), scale=0.02, **kw),
        "experts.w_gate": dense_init((L, e, d, f), **kw),
        "experts.w_up": dense_init((L, e, d, f), **kw),
        "experts.w_out": dense_init((L, e, f, d), **kw),
    }
    if m.num_shared_experts > 0:
        fs = f * m.num_shared_experts
        p["shared.w_gate"] = dense_init((L, d, fs), **kw)
        p["shared.w_up"] = dense_init((L, d, fs), **kw)
        p["shared.w_out"] = dense_init((L, fs, d), **kw)
    return p


def top_k(probs, k):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (``lax.top_k``'s order)."""
    s = probs.sort(dim=-1, descending=True, stable=True)
    return s.values[..., :k], s.indices[..., :k]


def capacity(tokens, cfg):
    """Slots per expert for ``tokens`` routed tokens, in Python float as
    the reference computes it."""
    m = cfg.moe
    return max(1, int(math.ceil(tokens * m.top_k / m.num_experts
                                * m.capacity_factor)))


def _aux(expert_idx, probs, e, reduce):
    """Switch aux ``E·Σ me·ce`` over every leading axis: ``me`` the routed
    fraction per expert (one-hot counts, no gradient), ``ce`` the mean
    router probability."""
    k = expert_idx.shape[-1]
    lead = tuple(range(expert_idx.ndim - 1))
    me = F.one_hot(expert_idx, e).sum(-2).to(torch.float32).mean(lead) / k
    if reduce is not None:
        me = reduce(me)
    ce = probs.mean(lead)
    return e * (me * ce).sum()


def top_k_routing(logits, k, capacity, reduce=None):
    """GShard dense dispatch (``moe.py:38-70``).

    logits (B, S, E) fp32 -> (dispatch (B,S,E,C) 0/1 fp32, combine
    (B,S,E,C) fp32, aux scalar). Capacity positions run choice-major, then
    in sequence order, within each batch row."""
    b, s, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, k)                   # (B,S,k)
    onehot = F.one_hot(expert_idx, e)                         # (B,S,k,E)
    flat = onehot.transpose(1, 2).reshape(b, k * s, e)
    pos = (flat.cumsum(1) - flat).reshape(b, k, s, e).transpose(1, 2)
    pos = (pos * onehot).sum(-1)                              # (B,S,k)
    keep = pos < capacity
    # an out-of-range position one-hots to zeros in the reference
    cap_onehot = F.one_hot(pos.clamp(max=capacity - 1), capacity).to(
        torch.float32) * keep[..., None]
    onehot = onehot.to(torch.float32)
    dispatch = torch.einsum("bske,bskc->bsec", onehot, cap_onehot)
    combine = torch.einsum("bske,bskc->bsec", gate_vals[..., None] * onehot,
                           cap_onehot)
    return dispatch, combine, _aux(expert_idx, probs, e, reduce)


def expert_ffn(we, expert_in):
    """Every expert's SwiGLU on its slots: expert_in (E, ..., d) ->
    (E, ..., d), batched over E (``bmm``)."""
    e, d = expert_in.shape[0], expert_in.shape[-1]
    x = expert_in.reshape(e, -1, d)
    dt = x.dtype
    h = F.silu(torch.bmm(x, we["experts.w_gate"].to(dt))) * \
        torch.bmm(x, we["experts.w_up"].to(dt))
    return torch.bmm(h, we["experts.w_out"].to(dt)).reshape(expert_in.shape)


def _expert_part(p, cfg, seq=None):
    """The ``[lo, hi)`` of the experts this rank holds: its E/M under a
    model group (the tensor-parallel one, or ``seq``'s group where the
    experts are split), else all of them."""
    group = seq.group if seq is not None else shardctx.active()
    n = p["experts.w_gate"].shape[0]
    lo = 0 if group is None or n == cfg.moe.num_experts else group.rank * n
    return lo, lo + n


def _aux_once(aux, seq=None):
    """The aux term counted once over the model group: under tensor
    parallelism its gradient on model rank 0 only (every rank reports its
    value); under a sequence split its value and gradient on model rank 0
    only (the engine sums the ranks' losses and metrics)."""
    if seq is not None:
        return aux if seq.group.rank == 0 else torch.zeros_like(aux)
    tp = shardctx.active()
    return aux if tp is None or tp.rank == 0 else aux.detach()


def _rows_in(x, seq):
    """The rows the MoE routes: under a sequence split every rank's
    (gathered, the backward reduce-scattered), else ``x`` (the model
    group's copy under tensor parallelism)."""
    return shardctx.copy_to_model(x) if seq is None else \
        shardctx.all_gather_seq(x, seq)


def _rows_out(p, cfg, rows, x, out, seq):
    """The layer's output from ``out``, this rank's experts' partial sums
    over the routed rows ``x``: under tensor parallelism, with the shared
    experts' split part, summed over the model group; under a sequence
    split, reduce-scattered onto this rank's ``rows`` (sliced where every
    rank holds every expert), then the shared experts on ``rows``."""
    if seq is None:
        return shardctx.reduce_from_model(_shared(p, x, out))
    split = p["experts.w_gate"].shape[0] < cfg.moe.num_experts
    out = shardctx.reduce_scatter_seq(out, seq) if split else \
        out[:, seq.rows]
    return _shared(p, rows, out)


def _shared(p, x, out):
    if "shared.w_gate" not in p:
        return out
    dt = x.dtype
    hs = F.silu(x @ p["shared.w_gate"].to(dt)) * (x @ p["shared.w_up"].to(dt))
    return out + hs @ p["shared.w_out"].to(dt)


def moe_ffn(p, x, cfg, reduce=None, seq=None):
    """GShard MoE (``moe.py:73-109``): x (B, S, D) -> (out (B, S, D),
    ``router_aux_coef``·aux). ``p``: one layer's {router, experts.*,
    shared.*}; ``seq``: the Ulysses split (``x`` this rank's rows)."""
    m = cfg.moe
    rows, x = x, _rows_in(x, seq)
    b, s, d = x.shape
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    dispatch, combine, aux = top_k_routing(logits, m.top_k, capacity(s, cfg),
                                           reduce)
    lo, hi = _expert_part(p, cfg, seq)
    dispatch, combine = (t[:, :, lo:hi].to(x.dtype)
                         for t in (dispatch, combine))
    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch, x)
    expert_out = expert_ffn(p, expert_in)
    out = torch.einsum("bsec,ebcd->bsd", combine, expert_out)
    return _rows_out(p, cfg, rows, x, out, seq), \
        m.router_aux_coef * _aux_once(aux, seq)


def gather_slots(expert_idx, e, capacity):
    """The gather path's slot table over T·k flat (token, choice) entries,
    token-major: (slot -> token (E, C), slot valid (E, C), each entry's
    slot (T·k,) with dropped entries at C-1, kept (T·k,)).

    The reference writes kept and dropped entries alike into
    ``(expert, slot)`` with the dropped ones at slot C-1, and XLA's
    in-order scatter on the CPU lets the last writer, a dropped entry,
    win there: an expert that overflows loses the token it kept in slot
    C-1 as well (ROADMAP caveat R4). Here only the kept entries are
    written (their slots are unique), then slot C-1 of each overflowing
    expert is cleared, which gives the same table deterministically."""
    t, k = expert_idx.shape
    ek = expert_idx.reshape(t * k)
    oh = F.one_hot(ek, e)                                     # (T*k, E)
    pos = (oh.cumsum(0) - oh).gather(1, ek[:, None])[:, 0]
    keep = pos < capacity
    safe_pos = torch.where(keep, pos, capacity - 1)
    tok = torch.arange(t * k, device=ek.device) // k
    slot_tok = torch.zeros((e, capacity), dtype=torch.int64, device=ek.device)
    valid = torch.zeros((e, capacity), dtype=torch.bool, device=ek.device)
    slot_tok[ek[keep], pos[keep]] = tok[keep]
    valid[ek[keep], pos[keep]] = True
    valid[:, capacity - 1] &= oh.sum(0) <= capacity
    return slot_tok, valid, safe_pos, keep


def moe_ffn_gather(p, x, cfg, reduce=None, seq=None):
    """Gather-based MoE (``moe.py:116-184``): an (E, C) slot -> token table
    instead of the (B,S,E,C) einsums, capacity counted over the flattened
    T = B·S tokens, token-major; the combine gathers each (token, choice)'s
    slot back and scales it by its gate. Same signature and aux statistic
    as ``moe_ffn``."""
    m = cfg.moe
    rows, x = x, _rows_in(x, seq)
    b, s, d = x.shape
    t, e, k = b * s, m.num_experts, m.top_k
    x_flat = x.reshape(t, d)
    logits = x_flat.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, k)                   # (T, k)
    slot_tok, valid, safe_pos, keep = gather_slots(expert_idx, e,
                                                   capacity(t, cfg))
    lo, hi = _expert_part(p, cfg, seq)
    expert_in = x_flat[slot_tok[lo:hi]] * \
        valid[lo:hi, :, None].to(x.dtype)                   # (E/M,C,D)
    expert_out = expert_ffn(p, expert_in)
    ek = expert_idx.reshape(t * k)
    # the (token, choice) entries this rank's experts serve
    mine = (ek >= lo) & (ek < hi)
    gates = gate_vals.reshape(t * k).to(x.dtype) * (keep & mine).to(x.dtype)
    out = (expert_out[torch.where(mine, ek - lo, 0), safe_pos]
           * gates[:, None]).reshape(t, k, d).sum(1)
    aux = _aux(expert_idx, probs, e, reduce)
    return _rows_out(p, cfg, rows, x, out.reshape(b, s, d), seq), \
        m.router_aux_coef * _aux_once(aux, seq)
