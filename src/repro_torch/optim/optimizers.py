"""AdamW (the paper's default), SGD with momentum and LAMB, written out by
hand after ``repro/optim/optimizers.py``.

Params, grads and moments are flat ``{key: tensor}`` dicts; the moments are
fp32. ``update`` is functional: it returns new tensors and leaves its
inputs untouched, so a caller can still drop the result (the engine's
anomaly guard does). ``torch.optim.AdamW`` is not used: it orders the
weight decay and the bias corrections differently and so rounds
differently from the reference.

The update is elementwise but for two sums of squares: the global grad
norm (clip and anomaly guard) and LAMB's per-leaf trust ratio. Under ZeRO
each rank updates only its chunk of a sharded leaf, so ``update`` takes
``reduce``, ``{key: this rank's sum of squares} -> {key: the whole
leaf's}``; the data-parallel engine sums over the ranks there and counts a
replicated leaf once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch


class OptState(NamedTuple):
    step: int         # updates taken
    mu: dict          # first moment (adamw/lamb) or momentum (sgd)
    nu: dict | tuple  # second moment (adamw/lamb); () for sgd


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable   # (grads, state, params, lr, reduce=None)
    #                    -> (new_p, state, gnorm)
    name: str = ""


def _zeros_like_f32(params):
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def sum_squares(tree: dict, reduce=None) -> dict:
    """``{key: sum(x**2)}`` in fp32, passed through ``reduce`` if given."""
    sq = {k: torch.sum(torch.square(x.to(torch.float32)))
          for k, x in tree.items()}
    return sq if reduce is None else reduce(sq)


def global_norm(tree: dict, reduce=None):
    return torch.sqrt(sum(sum_squares(tree, reduce).values()))


def clip_by_global_norm(grads: dict, max_norm: float, reduce=None):
    """``(grads * min(1, max_norm / (norm + 1e-9)), norm)``."""
    norm = global_norm(grads, reduce)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm


def make_optimizer(name: str, *, weight_decay=0.01, b1=0.9, b2=0.95,
                   eps=1e-8, momentum=0.9, grad_clip=1.0) -> Optimizer:
    name = name.lower()
    if name not in ("adamw", "sgd", "lamb"):
        raise ValueError(f"unknown optimizer {name}")

    def init(params):
        mu = _zeros_like_f32(params)
        return OptState(0, mu, () if name == "sgd" else
                        _zeros_like_f32(params))

    def update(grads, state, params, lr, reduce=None):
        if grad_clip > 0:
            grads, gnorm = clip_by_global_norm(grads, grad_clip, reduce)
        else:
            gnorm = global_norm(grads, reduce)
        step = state.step + 1
        f32 = torch.float32

        if name == "sgd":
            mu = {k: momentum * state.mu[k] + g.to(f32)
                  for k, g in grads.items()}
            new_p = {k: (p.to(f32) - lr * (mu[k] + weight_decay * p.to(f32))
                         ).to(p.dtype) for k, p in params.items()}
            return new_p, OptState(step, mu, ()), gnorm

        mu = {k: b1 * state.mu[k] + (1 - b1) * g.to(f32)
              for k, g in grads.items()}
        nu = {k: b2 * state.nu[k] + (1 - b2) * torch.square(g.to(f32))
              for k, g in grads.items()}
        stepf = torch.tensor(float(step), dtype=f32)
        bc1 = float(1 - torch.tensor(b1, dtype=f32) ** stepf)
        bc2 = float(1 - torch.tensor(b2, dtype=f32) ** stepf)

        def adam_dir(k, p):
            return mu[k] / bc1 / (torch.sqrt(nu[k] / bc2) + eps) \
                + weight_decay * p.to(f32)

        if name == "lamb":
            # layer-wise trust ratio [You et al.; DeepSpeed LAMB]; the
            # direction is computed again below, so only one leaf's is
            # alive at a time
            pn2 = sum_squares(params, reduce)
            un2 = {k: torch.sum(torch.square(adam_dir(k, p)))
                   for k, p in params.items()}
            un2 = un2 if reduce is None else reduce(un2)
        new_p = {}
        for k, p in params.items():
            u = adam_dir(k, p)
            if name == "lamb":
                pn, un = torch.sqrt(pn2[k]), torch.sqrt(un2[k])
                u = torch.where((pn > 0) & (un > 0), pn / un, 1.0) * u
            new_p[k] = (p.to(f32) - lr * u).to(p.dtype)
        return new_p, OptState(step, mu, nu), gnorm

    return Optimizer(init=init, update=update, name=name)
