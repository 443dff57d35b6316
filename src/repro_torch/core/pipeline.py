"""Pipeline parallelism (DeepSpeed's ``PipelineEngine``): the memory-bounded
1F1B schedule, flat and interleaved, and the staged executor that walks it
(``repro/core/pipeline.py``).

1. **Schedule** (``one_f_one_b`` and its accounting): the reference's
   pure-Python simulator, copied as it is. ``interleave=v`` cuts the layer
   stack into ``V = v * S`` chunks, chunk ``c`` on stage ``c % S``
   (Megatron's interleaved schedule). The executor walks its slot list
   verbatim and reports the slots it ran (``schedule_out``), which the
   tests hold equal to ``schedule_accounting``.

2. **Execution** (``pipelined_value_and_grad``, ``pipelined_loss``): the
   stack is cut into contiguous chunks (the embed pinned to chunk 0, the
   head and the loss to chunk V-1) and the schedule runs tick by tick.
   A forward slot runs its chunk under ``torch.no_grad()`` and keeps one
   residual: the chunk's input. A backward slot runs the chunk again from
   that input with grad on and calls ``torch.autograd.backward`` with the
   incoming cotangent (the last chunk seeds it through the head and the
   loss, with cotangent 1; chunk 0 pulls it back through the embed), after
   which the residual is dead: live activations are O(in-flight) per
   stage, flat in M. Each slot takes its chunk's layers as one slice per
   stacked leaf (``leaf[lo:hi]``, detached with grad), whose gradient is
   added into that slice of an fp32 accumulator: every cotangent is cast
   to fp32 before the ``+= ct / M``, so bf16 compute params keep fp32
   master gradients. The microbatches' seeds reach ``microbatch_fn``
   wherever a microbatch is materialised (the stage-0 inject, the head's
   loss, the embed's backward), so a pipelined step replays the
   data-parallel step's augmentation.

   Two transports run the same slot list. With ``pipe=None`` one process
   holds every chunk (the reference's ``pipe_axis=None``): each tick runs
   each stage's task in turn, and a Python dict hands activations and
   cotangents on. With ``pipe`` (a ``core.distributed.World`` of the S
   ranks of one pipeline), rank p holds the chunks ``c % S == p`` and,
   after each tick, sends that tick's outputs to its neighbours in one
   ``batch_isend_irecv``: the activation to chunk c+1's rank (S-1 wraps to
   0 when interleaved), the cotangent to chunk c-1's. Both sides read the
   lists off the schedule; a receive that never arrives raises at the
   group's timeout.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from repro_torch.core.grad_accum import split_microbatches
from repro_torch.core.sharding import is_stacked
from repro_torch.models import transformer as model


# ---------------------------------------------------------------------------
# stage partitioning and the 1F1B schedule (the reference's, as it is)
# ---------------------------------------------------------------------------

def stage_partition(num_layers: int, stages: int) -> List[tuple]:
    """Contiguous [lo, hi) layer ranges per (virtual) stage; embed is pinned
    to chunk 0 and the head to the last chunk by construction."""
    if stages < 1:
        raise ValueError(f"stages must be >= 1, got {stages}")
    if num_layers % stages:
        raise ValueError(
            f"num_layers={num_layers} not divisible by pipeline "
            f"stages={stages}")
    lps = num_layers // stages
    return [(s * lps, (s + 1) * lps) for s in range(stages)]


def check_supported(cfg) -> None:
    """Pipeline path covers the scan-stacked attn/mla block stack (the
    paper's ViT + dense LMs). Branching stacks need per-stage routing."""
    if cfg.block_kind not in ("attn", "mla"):
        raise ValueError(
            f"pipeline_stages > 1 unsupported for block_kind="
            f"{cfg.block_kind!r} (only attn/mla stacks)")
    if cfg.has_moe:
        raise ValueError("pipeline_stages > 1 unsupported for MoE stacks "
                         "(dense/moe split breaks contiguous staging)")
    if cfg.mtp_depth > 0:
        raise ValueError("pipeline_stages > 1 unsupported with MTP heads")
    if cfg.hybrid_group > 0:
        raise ValueError("pipeline_stages > 1 unsupported for hybrid stacks")
    if cfg.rope_style == "mrope" or cfg.arch_type == "vlm":
        # M-RoPE positions are batch-supplied per microbatch; the pipelined
        # loop computes positions once from microbatch 0 (valid only for
        # shape-derived arange/None positions), so vlm would silently train
        # with microbatch-0's position grid
        raise ValueError("pipeline_stages > 1 unsupported for vlm/M-RoPE "
                         "(batch-dependent rope positions)")


# ---------------------------------------------------------------------------
# 1F1B schedule (flat + interleaved)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PipeTask:
    kind: str       # "F" | "B"
    micro: int      # microbatch index
    chunk: int = 0  # virtual stage index in [0, stages * interleave)


def one_f_one_b(num_micro: int, num_stages: int, interleave: int = 1
                ) -> List[List[Optional[PipeTask]]]:
    """Simulate the 1F1B schedule with unit F/B slots.

    Returns ``sched[device][tick] -> PipeTask | None`` (None = bubble).
    ``interleave=1`` is the flat schedule: chunk == stage == device, warmup
    forwards, steady-state F/B alternation, cooldown backwards, per-stage
    in-flight cap ``num_stages - stage`` (DeepSpeed/PipeDream-flush).

    ``interleave=v > 1`` is the Megatron interleaved schedule over
    ``V = v * num_stages`` virtual stages, chunk ``c`` on device ``c % S``:
    each device issues forwards in groups of S microbatches cycling through
    its chunks shallow-to-deep (backwards deep-to-shallow), with warmup
    ``min(2*(S-d-1) + (v-1)*S, v*M)`` and strict 1F1B alternation after —
    falling back to the other slot kind only when the scheduled kind's
    dependency is not yet satisfied. In-flight residuals per device never
    exceed ``warmup_d + 1`` — flat in M (asserted here; the reference's
    hypothesis suite in tests/test_pipeline.py re-checks it, and the
    flat schedule keeps the strict ``<= S - d <= S`` cap).
    """
    S, M, v = num_stages, num_micro, interleave
    if v < 1:
        raise ValueError(f"interleave must be >= 1, got {v}")
    if M < S:
        raise ValueError(
            f"1F1B needs microbatches >= stages: {M} < {S}")
    if v == 1:
        return _flat_one_f_one_b(M, S)
    if M % S:
        raise ValueError(
            f"interleaved 1F1B needs num_micro divisible by stages "
            f"(Megatron grouping): {M} % {S} != 0")
    V = S * v
    total = v * M

    def orders(dev):
        chunks = [k * S + dev for k in range(v)]
        groups = [range(g * S, (g + 1) * S) for g in range(M // S)]
        fwd = [(c, m) for g in groups for c in chunks for m in g]
        bwd = [(c, m) for g in groups for c in reversed(chunks) for m in g]
        return fwd, bwd

    forder, border = zip(*(orders(d) for d in range(S)))
    warmup = [min(2 * (S - d - 1) + (v - 1) * S, total) for d in range(S)]
    fwd_done, bwd_done = {}, {}
    nf, nb = [0] * S, [0] * S
    sched: List[List[Optional[PipeTask]]] = [[] for _ in range(S)]
    t = 0
    while min(nb) < total:
        if t > 8 * (total + V):         # simulator safety net
            raise RuntimeError("interleaved 1F1B schedule did not converge")
        for d in range(S):
            def try_fwd():
                if nf[d] >= total:
                    return None
                c, m = forder[d][nf[d]]
                if c > 0 and not fwd_done.get((c - 1, m), t) < t:
                    return None
                fwd_done[(c, m)] = t
                nf[d] += 1
                # the memory invariant the executor's residual store
                # relies on: per-device in-flight chunk inputs stay under
                # the warmup depth + 1 — flat in M
                assert nf[d] - nb[d] <= warmup[d] + 1, (d, m, t)
                return PipeTask("F", m, c)

            def try_bwd():
                if nb[d] >= total:
                    return None
                c, m = border[d][nb[d]]
                ready = (fwd_done.get((c, m), t) < t if c == V - 1
                         else bwd_done.get((c + 1, m), t) < t)
                if not ready or not fwd_done.get((c, m), t) < t:
                    return None
                bwd_done[(c, m)] = t
                nb[d] += 1
                return PipeTask("B", m, c)

            want_fwd = nf[d] < warmup[d] or (
                nf[d] < total and nf[d] - warmup[d] == nb[d])
            task = (try_fwd() or try_bwd()) if want_fwd \
                else (try_bwd() or try_fwd())
            sched[d].append(task)
        t += 1
    return sched


def _flat_one_f_one_b(M: int, S: int) -> List[List[Optional[PipeTask]]]:
    fwd_done = [[None] * M for _ in range(S)]   # tick stage s forwarded m
    bwd_done = [[None] * M for _ in range(S)]
    nf = [0] * S                                # forwards issued per stage
    nb = [0] * S                                # backwards issued per stage
    sched: List[List[Optional[PipeTask]]] = [[] for _ in range(S)]
    t = 0
    while min(nb) < M:
        if t > 4 * (M + S):                     # simulator safety net
            raise RuntimeError("1F1B schedule did not converge")
        for s in range(S):
            can_fwd = nf[s] < M and (
                s == 0 or fwd_done[s - 1][nf[s]] is not None
                and fwd_done[s - 1][nf[s]] < t)
            can_bwd = nb[s] < nf[s] and (
                s == S - 1 or bwd_done[s + 1][nb[s]] is not None
                and bwd_done[s + 1][nb[s]] < t)
            in_flight = nf[s] - nb[s]
            # the 1F1B memory cap: at most S - s activations live on stage
            # s; past the cap the stage waits for a backward, never piles
            # up more forwards (what distinguishes 1F1B from GPipe)
            if can_bwd and (in_flight >= S - s or nf[s] == M):
                bwd_done[s][nb[s]] = t
                sched[s].append(PipeTask("B", nb[s], s))
                nb[s] += 1
            elif can_fwd and in_flight < S - s:
                fwd_done[s][nf[s]] = t
                sched[s].append(PipeTask("F", nf[s], s))
                nf[s] += 1
            elif can_bwd:
                bwd_done[s][nb[s]] = t
                sched[s].append(PipeTask("B", nb[s], s))
                nb[s] += 1
            else:
                sched[s].append(None)
        t += 1
    return sched


def idle_slots(sched: List[List[Optional[PipeTask]]], dev: int) -> int:
    """Raw idle slot count of ``dev`` over the whole schedule."""
    return sum(1 for task in sched[dev] if task is None)


def bubble_count(sched: List[List[Optional[PipeTask]]], stage: int) -> int:
    """Idle slots of ``stage`` in F+B pair units — ``stages - 1`` for the
    flat 1F1B (the warmup/cooldown ramp each stage pays once)."""
    return idle_slots(sched, stage) // 2


def makespan(sched: List[List[Optional[PipeTask]]]) -> int:
    """Schedule length in unit slots (all device rows are equal length).
    One interleaved slot is 1/interleave of a flat slot — normalize by
    ``interleave`` when comparing across v."""
    return len(sched[0])


def bubble_fraction(num_micro: int, num_stages: int) -> float:
    """Analytic flat-1F1B pipeline-bubble fraction (S-1)/(M+S-1)."""
    return (num_stages - 1) / (num_micro + num_stages - 1)


def simulated_bubble_fraction(num_micro: int, num_stages: int,
                              interleave: int = 1) -> float:
    """Worst-device bubble fraction read off the simulated schedule — the
    number `scaling_sweep.py`/`scaling_bench.py` record for interleaved
    layouts. Equals `bubble_fraction` at interleave=1 and approaches
    (S-1)/(v*M+S-1) for the interleaved schedule."""
    sched = one_f_one_b(num_micro, num_stages, interleave)
    return max(idle_slots(sched, d) for d in range(num_stages)) \
        / makespan(sched)


def schedule_accounting(num_micro: int, num_stages: int,
                        interleave: int = 1) -> dict:
    """Per-device slot counts of the simulated schedule — the reference the
    executed-schedule accounting is asserted against."""
    sched = one_f_one_b(num_micro, num_stages, interleave)
    return {
        "ticks": makespan(sched),
        "F": [sum(1 for x in sched[d] if x and x.kind == "F")
              for d in range(num_stages)],
        "B": [sum(1 for x in sched[d] if x and x.kind == "B")
              for d in range(num_stages)],
        "idle": [idle_slots(sched, d) for d in range(num_stages)],
    }


# ---------------------------------------------------------------------------
# staged execution
# ---------------------------------------------------------------------------

def _staged_pipeline(cfg, params, batch, *, stages, num_micro, interleave,
                     rngs, microbatch_fn, want_grads, schedule_out, pipe,
                     gather, reduce):
    """The executor both entry points share. ``want_grads=False`` runs
    the forward slots only; ``want_grads=True`` adds the backward slots and
    returns the fp32 mean gradients beside (loss, metrics)."""
    check_supported(cfg)
    S, M, v = stages, num_micro, interleave
    V = S * v
    stage_partition(cfg.num_layers, V)          # validates divisibility
    sched = one_f_one_b(M, S, v)                # validates M vs S, M % S
    lpc = cfg.num_layers // V
    if pipe is not None and pipe.size != S:
        raise ValueError(f"a pipe group of {pipe.size} ranks for {S} "
                         f"stages")
    if rngs is not None and len(rngs) != M:
        raise ValueError(f"{len(rngs)} rngs for {M} microbatches")
    mine = range(S) if pipe is None else (pipe.rank,)
    stacked = {k: t for k, t in params.items() if is_stacked(k)}
    rest = {k: t for k, t in params.items() if k not in stacked}
    local_layers = cfg.num_layers if pipe is None else v * lpc
    for k, t in stacked.items():
        if t.shape[0] != local_layers:
            raise ValueError(f"{k}: {t.shape[0]} layers here, the stage "
                             f"holds {local_layers}")
    windows = cfg.layer_windows()

    def rows(c):
        """Chunk ``c``'s rows of this process's stacked leaves."""
        k = c if pipe is None else c // S
        return slice(k * lpc, (k + 1) * lpc)

    def run_chunk(c, stack, x):
        return model.stack_forward(cfg, stack, x, positions,
                                   windows[c * lpc:(c + 1) * lpc], gather)

    mbs = split_microbatches(batch, M)

    def micro_batch(m):
        mb = mbs[m]
        if microbatch_fn is not None:
            mb = microbatch_fn(mb, None if rngs is None else rngs[m])
        return mb

    def head_loss(p, h, mb):
        logits = model.apply_head(cfg, p, h)
        return model.loss_from_logits(cfg, logits, mb, None, reduce)

    def leaves(tree):
        return {k: t.detach().requires_grad_() for k, t in tree.items()}

    # the handoff's shape and dtype, and the rope positions every chunk
    # takes, from microbatch 0 (the reference's ``inject0``)
    with torch.no_grad():
        x0, positions = model.embed(cfg, rest, micro_batch(0))
    lane = (x0.shape, x0.dtype)
    device = x0.device
    del x0

    inv_m = 1.0 / M
    loss_sum = torch.zeros((), dtype=torch.float32, device=device)
    metric_sum = {k: torch.zeros((), dtype=torch.float32, device=device)
                  for k in model.metric_names(cfg)}
    grads = None
    if want_grads:
        grads = {k: torch.zeros(t.shape, dtype=torch.float32, device=device)
                 for k, t in params.items()}

    def accumulate(tree, at=None):
        # the fp32 policy of accumulate_gradients: each cotangent cast up
        # before the += ct / M
        for k, t in tree.items():
            if t.grad is not None:
                acc = grads[k] if at is None else grads[k][at]
                acc.add_(t.grad.to(torch.float32) * inv_m)

    act = {}    # (chunk, m) -> chunk output, for chunk + 1
    xin = {}    # (chunk, m) -> chunk input (the residual)
    gst = {}    # (chunk, m) -> dL/d(chunk input), for chunk - 1
    counts = {"F": [0] * S, "B": [0] * S, "idle": [0] * S}
    live, peak = [0] * S, [0] * S
    if pipe is not None:
        for kind in counts:
            counts[kind] = [n if d in mine else None
                            for d, n in enumerate(counts[kind])]
        peak = [n if d in mine else None for d, n in enumerate(peak)]

    for t in range(makespan(sched)):
        for d in mine:
            task = sched[d][t]
            if task is None:
                counts["idle"][d] += 1
                continue
            assert task.chunk % S == d, (d, task)
            counts[task.kind][d] += 1
            c, m = task.chunk, task.micro
            if task.kind == "F":
                with torch.no_grad():
                    x = model.embed(cfg, rest, micro_batch(m))[0] \
                        if c == 0 else act.pop((c - 1, m))
                    y = run_chunk(c, {k: w[rows(c)]
                                      for k, w in stacked.items()}, x)
                    if want_grads:
                        xin[(c, m)] = x
                        live[d] += 1
                        peak[d] = max(peak[d], live[d])
                    if c < V - 1:
                        act[(c, m)] = y
                        continue
                    # the microbatch leaves the pipe: its loss and metrics
                    loss_m, metrics_m = head_loss(rest, y, micro_batch(m))
                    loss_sum += loss_m
                    for k in metric_sum:
                        metric_sum[k] += metrics_m[k]
                continue
            if not want_grads:
                continue
            # the backward slot: the chunk again from its stored input,
            # with grad, then the incoming cotangent pulled through it
            xg = xin.pop((c, m)).detach().requires_grad_()
            live[d] -= 1
            sl = leaves({k: w[rows(c)] for k, w in stacked.items()})
            with torch.enable_grad():
                y = run_chunk(c, sl, xg)
                if c == V - 1:
                    hp = leaves(rest)
                    loss_m, _ = head_loss(hp, y, micro_batch(m))
                    torch.autograd.backward(
                        loss_m, inputs=[xg, *sl.values(), *hp.values()])
                    accumulate(hp)
                else:
                    torch.autograd.backward(
                        y, gst.pop((c + 1, m)),
                        inputs=[xg, *sl.values()])
            del y
            accumulate(sl, rows(c))
            if c > 0:
                gst[(c, m)] = xg.grad
                continue
            # the cotangent reaches the inject: the embed's backward
            ep = leaves(rest)
            with torch.enable_grad():
                e = model.embed(cfg, ep, micro_batch(m))[0]
                torch.autograd.backward(e, xg.grad, inputs=list(ep.values()))
            accumulate(ep)
        if pipe is not None:
            _exchange(pipe, sched, t, V, lane, act, gst, want_grads)

    loss = loss_sum * inv_m
    metrics = {k: s_ * inv_m for k, s_ in metric_sum.items()}
    metrics["loss"] = loss
    if schedule_out is not None:
        schedule_out.update(schedule=sched, executed=counts,
                            ticks=makespan(sched), in_flight=peak)
    assert not act and not xin and not gst, (act.keys(), xin.keys(),
                                             gst.keys())
    if not want_grads:
        return loss, metrics
    return (loss, metrics), grads


def _exchange(pipe, sched, t, V, lane, act, gst, want_grads):
    """Tick ``t``'s handoff over the pipe group: this rank sends its
    slot's output (a forward's activation to chunk c+1's rank, a
    backward's cotangent to chunk c-1's) and receives what the other
    ranks' slots send it, all in one ``batch_isend_irecv``."""
    S, p = pipe.size, pipe.rank
    sends, recvs, into = [], [], []
    for q in range(S):
        task = sched[q][t]
        if task is None:
            continue
        c, m = task.chunk, task.micro
        if task.kind == "F" and c < V - 1:
            store, key, dst = act, (c, m), (c + 1) % S
        elif task.kind == "B" and c > 0 and want_grads:
            store, key, dst = gst, (c, m), (c - 1) % S
        else:
            continue
        if q == p:
            sends.append((store.pop(key), dst))
        elif dst == p:
            recvs.append(lane + (q,))
            into.append((store, key))
    for (store, key), got in zip(into, pipe.exchange(sends, recvs)):
        store[key] = got


def pipelined_loss(cfg, params, batch, *, stages: int, num_micro: int,
                   interleave: int = 1, rngs=None, microbatch_fn=None,
                   schedule_out=None, pipe=None, gather=None, reduce=None):
    """1F1B-scheduled pipeline loss: ``(loss, metrics)``, the means over
    the microbatches, each taken as it leaves the last chunk (so the value
    is ``pipelined_value_and_grad``'s, and the data-parallel path's over
    the same ``split_microbatches``). Forward slots only.

    ``params``: flat ``{key: tensor}``; with ``pipe`` (the ranks of one
    pipeline) each stacked leaf holds this rank's chunks, ``c % S ==
    pipe.rank`` in the order of ``c``, else the whole leaf. ``rngs``: one
    seed per microbatch, handed to ``microbatch_fn(mb, rng)`` wherever a
    microbatch is materialised. ``gather``: ZeRO-3's hook for the stacked
    leaves (``transformer.forward``'s); the non-stacked ones come whole.
    ``reduce``: the loss's data-parallel hook (the audio encoder's
    masked-frame count). ``schedule_out`` gets the schedule, the executed
    F/B/idle counts and the largest number of live residuals per stage
    (None for the stages another rank runs). Without the last chunk a rank
    returns zeros, which its caller sums over the pipe group."""
    return _staged_pipeline(
        cfg, params, batch, stages=stages, num_micro=num_micro,
        interleave=interleave, rngs=rngs, microbatch_fn=microbatch_fn,
        want_grads=False, schedule_out=schedule_out, pipe=pipe,
        gather=gather, reduce=reduce)


def pipelined_value_and_grad(cfg, params, batch, *, stages: int,
                             num_micro: int, interleave: int = 1, rngs=None,
                             microbatch_fn=None, schedule_out=None,
                             pipe=None, gather=None, reduce=None):
    """``((loss, metrics), grads)`` through per-chunk backward slots on the
    1F1B schedule, interchangeable with ``accumulate_gradients``: the
    grads are the fp32 mean of the microbatches' gradients with respect
    to ``params`` (each leaf's shape: this rank's chunks of a stacked leaf,
    a ZeRO-3 shard's gradient already averaged over the data group by
    ``gather``'s backward), the loss and metrics the microbatch means.
    Only the stages with the embed (chunk 0) and the head (chunk V-1) give
    the non-stacked leaves a gradient; elsewhere theirs are zeros, which
    the caller sums over the pipe group. Arguments as
    :func:`pipelined_loss`'s."""
    return _staged_pipeline(
        cfg, params, batch, stages=stages, num_micro=num_micro,
        interleave=interleave, rngs=rngs, microbatch_fn=microbatch_fn,
        want_grads=True, schedule_out=schedule_out, pipe=pipe,
        gather=gather, reduce=reduce)
