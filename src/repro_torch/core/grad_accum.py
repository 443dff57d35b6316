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


def accumulate_gradients(loss_fn, params: dict, batch: dict, accum: int):
    """``loss_fn(params, microbatch) -> (loss, metrics)``; ``params`` are
    leaves that require grad.

    Returns (mean grads in fp32, mean metrics): one forward and backward
    per microbatch, and ``acc += g.float() / accum`` in that order, as the
    reference's scan body does."""
    keys = list(params)
    leaves = [params[k] for k in keys]

    def grads_of(mb):
        loss, metrics = loss_fn(params, mb)
        grads = torch.autograd.grad(loss, leaves)
        return grads, {k: v.detach() for k, v in metrics.items()}

    if accum == 1:
        grads, metrics = grads_of(batch)
        return {k: g.to(torch.float32) for k, g in zip(keys, grads)}, metrics

    acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()}
    history = []
    for mb in split_microbatches(batch, accum):
        grads, metrics = grads_of(mb)
        for k, g in zip(keys, grads):
            acc[k] += g.to(torch.float32) / accum
        history.append(metrics)
    return acc, {k: torch.stack([m[k] for m in history]).mean(0)
                 for k in history[0]}
