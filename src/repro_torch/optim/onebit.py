"""1-bit compressed-gradient optimizers with error feedback (the
counterpart of ``repro/optim/onebit.py``; the paper's §V cites DeepSpeed's
1-bit LAMB as a follow-up):

  v_t    = g_t + e_{t-1}            (error feedback)
  q_t    = sign(v_t) · mean|v_t|    (1 bit and one fp32 scale a tensor)
  e_t    = v_t - q_t                (the compression error carried over)
  update = base_optimizer(q_t)

As in the reference, the compression applies to the gradient the engine
has already reduced, so it is the numerics-visible part of the scheme
(sign, scale and error feedback), not a compressed collective: no CLI
flag or ``Trainer`` path reaches it. ``compressed_bytes`` is the one wire
count carried over.

The wrapper keeps the port's ``Optimizer`` interface: ``update`` is the
functional form (the reference's), ``apply`` the in-place one (the
params, the error buffer and the inner moments). The scale is
the mean over the whole tensor: where ``apply`` or ``update`` is handed a
rank's chunks, its ``reduce`` (``{key: this rank's sum} -> {key: the whole
leaf's}``, as for the sums of squares) supplies the sums of |v| and the
element counts over them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim.optimizers import Optimizer, global_norm, \
    make_optimizer


class OneBitState(NamedTuple):
    error: dict         # fp32 error-feedback buffer, one per param
    inner: object       # the wrapped optimizer's OptState


def _compress(v, scale):
    q = torch.sign(v) * scale
    return q, v - q


def compress_ef(g, err):
    """(g, err) -> (q, new err): sign and scale with error feedback, in
    fp32."""
    v = g.to(torch.float32) + err
    return _compress(v, torch.mean(torch.abs(v)))


def compressed_bytes(nbytes_f32: float) -> float:
    """Wire bytes after 1-bit compression (the fp32 scale a tensor
    amortised away)."""
    return nbytes_f32 / 32.0


def _scales(v: dict, reduce):
    """``{key: mean|v| over the whole leaf}``; with ``reduce`` the sums and
    the counts of chunks ``v`` summed through it."""
    if reduce is None:
        return {k: torch.mean(torch.abs(x)) for k, x in v.items()}
    sums = reduce({k: torch.sum(torch.abs(x)) for k, x in v.items()})
    counts = reduce({k: torch.tensor(float(x.numel()), device=x.device)
                     for k, x in v.items()})
    return {k: sums[k] / counts[k] for k in v}


def make_onebit_optimizer(base: str = "lamb", **kw) -> Optimizer:
    """``base`` (adamw, sgd or lamb, with ``make_optimizer``'s keywords)
    fed the compressed gradients; named ``onebit_{base}``. The grad norm
    it clips by and returns is that of q, as the reference's inner
    ``update`` sees it."""
    inner = make_optimizer(base, **kw)

    def init(params):
        err = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()}
        return OneBitState(error=err, inner=inner.init(params))

    def compress(grads, error, reduce):
        v = {k: g.to(torch.float32) + error[k] for k, g in grads.items()}
        scales = _scales(v, reduce)
        out = {k: _compress(x, scales[k]) for k, x in v.items()}
        return {k: t[0] for k, t in out.items()}, \
            {k: t[1] for k, t in out.items()}

    @torch.no_grad()
    def update(grads, state, params, lr, reduce=None):
        """-> (new params, new state, q's global norm); the inputs stay
        as they were."""
        q, err = compress(grads, state.error, reduce)
        new_p, inner_state, gnorm = inner.update(q, state.inner, params, lr,
                                                 reduce)
        return new_p, OneBitState(error=err, inner=inner_state), gnorm

    @torch.no_grad()
    def apply(grads, state, params, lr, gnorm=None, reduce=None):
        """``update`` in place: the params, the error buffer and the inner
        moments. ``gnorm`` (the raw gradients' norm, which the engine's
        guard reads) is not used: the inner optimizer clips by q's."""
        del gnorm
        q, err = compress(grads, state.error, reduce)
        for k, e in err.items():
            state.error[k].copy_(e)
        inner_state = inner.apply(q, state.inner, params, lr,
                                  global_norm(q, reduce), reduce=reduce)
        return OneBitState(error=state.error, inner=inner_state)

    return Optimizer(init=init, update=update, apply=apply,
                     name=f"onebit_{base}")
