"""Gradient accumulation: DeepSpeed's gradient_accumulation_steps semantics
(``repro/core/grad_accum.py``) as a Python loop over microbatches with fp32
accumulators."""
from __future__ import annotations

import torch


def split_microbatches(batch: dict, accum: int) -> list:
    """(B, ...) leaves -> ``accum`` microbatches of (B/accum, ...)."""
    def split(x):
        b = x.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by accum {accum}")
        return x.reshape((accum, b // accum) + tuple(x.shape[1:]))
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(accum)]


def accumulate_gradients(loss_fn, params: dict, batch: dict, accum: int,
                         rngs=None, reduce=None):
    """``loss_fn(params, microbatch) -> (loss, metrics)``; ``params`` are
    leaves that require grad.

    Returns (mean grads in fp32, mean metrics): one forward and backward
    per microbatch, and ``acc += g.float() / accum`` in that order, as the
    reference's scan body does.

    ``rngs``: one entry of randomness per microbatch (``accum`` of them);
    when given, ``loss_fn`` is called as ``loss_fn(params, mb, rng)`` with
    its microbatch's entry (the reference's ``rngs`` argument).
    ``reduce``: ``{key: grad} -> {key: grad}``, applied to each
    microbatch's grads before they are accumulated (ZeRO-2's reduce-scatter
    into the shard, ``engine.py:308-310``); the accumulator takes the
    shapes it returns."""
    keys = list(params)
    leaves = [params[k] for k in keys]
    if rngs is not None and len(rngs) != accum:
        raise ValueError(f"{len(rngs)} rngs for {accum} microbatches")

    def grads_of(mb, i):
        loss, metrics = loss_fn(params, mb) if rngs is None else \
            loss_fn(params, mb, rngs[i])
        grads = dict(zip(keys, torch.autograd.grad(loss, leaves)))
        if reduce is not None:
            grads = reduce(grads)
        return grads, {k: v.detach() for k, v in metrics.items()}

    if accum == 1:
        grads, metrics = grads_of(batch, 0)
        return {k: g.to(torch.float32) for k, g in grads.items()}, metrics

    acc = None
    history = []
    for i, mb in enumerate(split_microbatches(batch, accum)):
        grads, metrics = grads_of(mb, i)
        if acc is None:
            acc = {k: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device) for k, g in grads.items()}
        for k, g in grads.items():
            acc[k] += g.to(torch.float32) / accum
        history.append(metrics)
    return acc, {k: torch.stack([m[k] for m in history]).mean(0)
                 for k in history[0]}
