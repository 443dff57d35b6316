"""AdamW (the paper's default), SGD with momentum and LAMB, written out by
hand after ``repro/optim/optimizers.py``.

Params, grads and moments are flat ``{key: tensor}`` dicts; the moments are
fp32. ``apply`` updates the params and the moments in place, a leaf at a
time, from the pre-clip global grad norm its caller has already taken (the
engine's anomaly guard decides on that norm before anything changes), so a
step holds no second copy of the params or the moments. ``update`` is the
functional form, the same arithmetic on copies: it leaves its inputs
untouched and returns new tensors. ``torch.optim.AdamW`` is not used: it
orders the weight decay and the bias corrections differently and so
rounds differently from the reference.

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
    apply: Callable    # (grads, state, params, lr, gnorm, reduce=None)
    #                    -> state; params and moments in place
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


def make_optimizer(name: str, *, weight_decay=0.01, b1=0.9, b2=0.95,
                   eps=1e-8, momentum=0.9, grad_clip=1.0) -> Optimizer:
    name = name.lower()
    if name not in ("adamw", "sgd", "lamb"):
        raise ValueError(f"unknown optimizer {name}")

    def init(params):
        mu = _zeros_like_f32(params)
        return OptState(0, mu, () if name == "sgd" else
                        _zeros_like_f32(params))

    @torch.no_grad()
    def apply(grads, state, params, lr, gnorm, reduce=None):
        """Update ``params`` and ``state``'s moments in place and return
        the new state. ``gnorm`` is the global norm of ``grads`` before the
        clip; ``grads`` are clipped in place. Each expression keeps the
        reference's operand order, so the result is ``update``'s bit for
        bit."""
        f32 = torch.float32
        if grad_clip > 0:
            scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
            for g in grads.values():
                g.mul_(scale)
        step = state.step + 1

        def write(p, u):
            """p <- p - lr * u, u consumed."""
            u.mul_(lr)
            if p.dtype == f32:
                p.sub_(u)
            else:
                p.copy_(p.to(f32) - u)

        if name == "sgd":
            for k, g in grads.items():
                mu = state.mu[k].mul_(momentum).add_(g.to(f32))
                p = params[k]
                write(p, (weight_decay * p.to(f32)).add_(mu))
            return OptState(step, state.mu, ())

        for k, g in grads.items():
            g = g.to(f32)
            state.mu[k].mul_(b1).add_((1 - b1) * g)
            state.nu[k].mul_(b2).add_(torch.square(g).mul_(1 - b2))
        stepf = torch.tensor(float(step), dtype=f32)
        bc1 = float(1 - torch.tensor(b1, dtype=f32) ** stepf)
        bc2 = float(1 - torch.tensor(b2, dtype=f32) ** stepf)

        def adam_dir(k, p):
            u = state.mu[k] / bc1
            u.div_((state.nu[k] / bc2).sqrt_().add_(eps))
            return u.add_(weight_decay * p.to(f32))

        if name == "lamb":
            # layer-wise trust ratio [You et al.; DeepSpeed LAMB], from the
            # params before the update; the direction is computed again
            # below, so only one leaf's is alive at a time
            pn2 = sum_squares(params, reduce)
            un2 = {k: torch.sum(torch.square(adam_dir(k, p)))
                   for k, p in params.items()}
            un2 = un2 if reduce is None else reduce(un2)
        for k, p in params.items():
            u = adam_dir(k, p)
            if name == "lamb":
                pn, un = torch.sqrt(pn2[k]), torch.sqrt(un2[k])
                u.mul_(torch.where((pn > 0) & (un > 0), pn / un, 1.0))
            write(p, u)
        return OptState(step, state.mu, state.nu)

    @torch.no_grad()
    def update(grads, state, params, lr, reduce=None):
        """``apply`` on copies: returns (new params, new state, the
        pre-clip global grad norm) and leaves every input as it was."""
        gnorm = global_norm(grads, reduce)
        new_p = {k: p.detach().clone() for k, p in params.items()}
        copy = OptState(state.step, {k: m.clone() for k, m in
                                     state.mu.items()},
                        {k: v.clone() for k, v in state.nu.items()}
                        if name != "sgd" else ())
        new_state = apply({k: g.detach().clone() for k, g in grads.items()},
                          copy, new_p, lr, gnorm, reduce)
        return new_p, new_state, gnorm

    return Optimizer(init=init, update=update, apply=apply, name=name)
