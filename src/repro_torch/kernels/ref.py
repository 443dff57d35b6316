"""Plain PyTorch versions of the hand-written kernels.

``ref_attention`` is the plain version of K1 (``csrc/flash_fwd.cu``): the
CPU path of ``flash_attention_fwd`` and the oracle ``chip_smoke.py``
holds the kernel against on the card. It follows
``repro/kernels/ref.py::ref_attention`` and also returns the fp32 lse.
``ref_attention_bwd`` is the plain version of K2 and K3
(``csrc/flash_bwd.cu``), in the same two roles for the backward.
``ref_rmsnorm_fwd`` and ``ref_rmsnorm_bwd`` are the plain versions of K4
and K5 (``csrc/rmsnorm.cu``), ``ref_rmsnorm_sumsq``/``ref_rmsnorm_apply``
and ``ref_rmsnorm_bwd_dot``/``ref_rmsnorm_bwd_apply`` those of their
split-row routes (a row whose columns are spread over ranks);
``ref_rmsnorm`` is the JAX package's oracle
``repro/kernels/ref.py::ref_rmsnorm``. ``ref_wkv6_fwd`` and
``ref_wkv6_bwd`` are the plain versions of K6 and K7 (``csrc/wkv6.cu``);
``ref_wkv6`` is the JAX package's sequential oracle
``repro/kernels/ref.py::ref_wkv6``.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30
LSE_BIG = 2.0 ** 30     # lse of a fully-masked row


def _live_mask(s, t, *, causal, window, device):
    """(S, T) bool mask of the live (query, key) pairs."""
    qp = torch.arange(s, device=device)[:, None]
    kp = torch.arange(t, device=device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= (qp - kp) < window
    return ok


def ref_attention(q, k, v, *, causal=True, window=0, scale=None):
    """Exact softmax attention. q (B,H,S,D), k/v (B,KH,T,D|Dv), GQA
    internal (``kv_head = h // (H // KH)``). window: 0 = full, > 0 keeps
    ``q_pos - k_pos < window``. ``scale``: the scores' factor, D ** -0.5
    by default (a head dim padded with zeros passes its true width's).

    Returns ``(out (B,H,S,Dv) in v's dtype, lse (B,H,S) fp32)``: lse is
    the logsumexp of the masked, scaled fp32 scores. A row with no live key
    (only possible with a window and S > T) gets out 0 and lse ``2**30``,
    as the kernel and the reference's pruned Pallas grid give it."""
    b, h, s, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, kh, g, s, d)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg.to(torch.float32),
                          k.to(torch.float32)) * \
        (d ** -0.5 if scale is None else scale)
    ok = _live_mask(s, t, causal=causal, window=window, device=q.device)
    scores = torch.where(ok, scores, NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", w.to(v.dtype), v)
    live = ok.any(dim=-1)                                   # (S,)
    lse = torch.where(live, lse, LSE_BIG)
    out = torch.where(live[:, None], out, 0)
    return out.reshape(b, h, s, v.shape[-1]), lse.reshape(b, h, s)


def ref_attention_bwd(q, k, v, out, lse, do, *, causal=True, window=0,
                      delta=None, scale=None):
    """The attention backward from the forward's saved fp32 ``lse``, by
    the formulas of the Pallas ``_dq_kernel``/``_dkv_kernel``, all in fp32:
    Δ = rowsum(dO∘O), P = exp(S·scale − lse), dS = P∘(dO·Vᵀ − Δ)·scale,
    dq = dS·K, dk = dSᵀ·Q and dv = Pᵀ·dO summed over each GQA group.
    Masked pairs give P = dS = 0, so a fully-masked row (lse ``2**30``)
    contributes nothing.

    Returns ``(dq, dk, dv, delta)``: each gradient in its primal's dtype,
    delta (B,H,S) fp32. A given ``delta`` (K2's, for the plain K3) is used
    as it is, and ``out`` is then not read. ``scale`` as in
    :func:`ref_attention`."""
    b, h, s, d = q.shape
    kh, t, dv_dim = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kh
    f32 = torch.float32
    scale = d ** -0.5 if scale is None else scale
    qf = q.to(f32).reshape(b, kh, g, s, d)
    dof = do.to(f32).reshape(b, kh, g, s, dv_dim)
    kf, vf = k.to(f32), v.to(f32)
    if delta is None:
        delta = (dof * out.to(f32).reshape(b, kh, g, s, dv_dim)).sum(-1)
    else:
        delta = delta.to(f32).reshape(b, kh, g, s)
    ok = _live_mask(s, t, causal=causal, window=window, device=q.device)
    scores = torch.einsum("bkgsd,bktd->bkgst", qf, kf) * scale
    lse = lse.to(f32).reshape(b, kh, g, s, 1)
    p = torch.where(ok, torch.exp(scores - lse), 0.0)
    dp = torch.einsum("bkgsd,bktd->bkgst", dof, vf)
    ds = torch.where(ok, p * (dp - delta[..., None]), 0.0) * scale
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, kf)
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qf)
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dof)
    return (dq.reshape(b, h, s, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype), delta.reshape(b, h, s))


def ref_rmsnorm(x, scale, eps=1e-6):
    """``x / sqrt(mean(x²) + eps) * scale`` over the last dim, fp32 math,
    cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ((xf / torch.sqrt(var + eps)) * scale.to(torch.float32)
            ).to(x.dtype)


def ref_rmsnorm_fwd(x, scale, eps=1e-6):
    """K4's function, as the Pallas ``_fwd_kernel`` computes it:
    ``rinv = 1 / sqrt(mean(x²) + eps)`` per row in fp32 and ``out = x ·
    rinv · scale`` in x's dtype. Returns ``(out (..., D), rinv (rows,)
    fp32)``, rows being the product of x's leading dims."""
    xf = x.to(torch.float32).reshape(-1, x.shape[-1])
    rinv = 1.0 / torch.sqrt((xf * xf).mean(dim=-1) + eps)
    out = (xf * rinv[:, None]) * scale.to(torch.float32)
    return out.to(x.dtype).reshape(x.shape), rinv


def ref_rmsnorm_bwd(x, scale, rinv, dy):
    """K5's function, by the formula of the Pallas ``_bwd_kernel`` in fp32
    (not by autograd): ``dx = rinv·(dy∘s) − rinv³/D·x·rowsum(dy∘s∘x)`` in
    x's dtype and ``dscale = Σ_rows dy∘x∘rinv`` in scale's dtype."""
    d = x.shape[-1]
    xf = x.to(torch.float32).reshape(-1, d)
    dyf = dy.to(torch.float32).reshape(-1, d)
    r = rinv.to(torch.float32)[:, None]
    dys = dyf * scale.to(torch.float32)
    dot = (dys * xf).sum(dim=-1, keepdim=True)
    dx = r * dys - (r * r * r * (1.0 / d)) * xf * dot
    dscale = (dyf * xf * r).sum(dim=0)
    return dx.to(x.dtype).reshape(x.shape), dscale.to(scale.dtype)


def ref_rmsnorm_sumsq(x):
    """The split-row forward's partial pass: per row of x (..., D), the
    fp32 sum of squares of its D columns, (rows,)."""
    xf = x.to(torch.float32).reshape(-1, x.shape[-1])
    return (xf * xf).sum(dim=-1)


def ref_rmsnorm_apply(x, scale, sumsq, width, eps=1e-6):
    """The split-row forward's apply pass: ``rinv = 1 / sqrt(sumsq / width
    + eps)`` from the whole row's fp32 sum of squares (rows,) and width,
    then ``out = x · rinv · scale`` on this part's columns. Returns
    ``(out (..., D) in x's dtype, rinv (rows,) fp32)``."""
    xf = x.to(torch.float32).reshape(-1, x.shape[-1])
    rinv = 1.0 / torch.sqrt(sumsq.to(torch.float32) / width + eps)
    out = (xf * rinv[:, None]) * scale.to(torch.float32)
    return out.to(x.dtype).reshape(x.shape), rinv


def ref_rmsnorm_bwd_dot(x, scale, dy):
    """The split-row backward's partial pass: per row, the fp32
    ``rowsum(dy∘s∘x)`` over this part's columns, (rows,)."""
    d = x.shape[-1]
    xf = x.to(torch.float32).reshape(-1, d)
    dys = dy.to(torch.float32).reshape(-1, d) * scale.to(torch.float32)
    return (dys * xf).sum(dim=-1)


def ref_rmsnorm_bwd_apply(x, scale, rinv, dy, dot, width):
    """The split-row backward's apply pass, K5's formula with the whole
    row's ``dot`` = rowsum(dy∘s∘x) (rows,) and width: ``dx = rinv·(dy∘s)
    − rinv³/width·x·dot`` in x's dtype and this part's ``dscale = Σ_rows
    dy∘x∘rinv`` in scale's dtype."""
    d = x.shape[-1]
    xf = x.to(torch.float32).reshape(-1, d)
    dyf = dy.to(torch.float32).reshape(-1, d)
    r = rinv.to(torch.float32)[:, None]
    dys = dyf * scale.to(torch.float32)
    dx = r * dys - (r * r * r * (1.0 / width)) * xf * \
        dot.to(torch.float32)[:, None]
    dscale = (dyf * xf * r).sum(dim=0)
    return dx.to(x.dtype).reshape(x.shape), dscale.to(scale.dtype)


def ref_wkv6(r, k, v, wlog, u, s0):
    """The sequential WKV6 recurrence, one step at a time, in fp32.

    r/k/v/wlog (B,S,H,P), u (H,P), s0 (B,H,P,P):
      o_t = r_t·(S_{t-1} + diag(u) k_tᵀ v_t),  S_t = diag(e^{w_t}) S_{t-1}
      + k_tᵀ v_t.
    Returns ``(o (B,S,H,P), s_end (B,H,P,P))``, both fp32."""
    f32 = torch.float32
    r, k, v, wlog = (x.to(f32) for x in (r, k, v, wlog))
    u = u.to(f32)
    state = s0.to(f32)
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], wlog[:, t]   # (B,H,P)
        outs.append(torch.einsum("bhp,bhpq->bhq", rt, state)
                    + torch.einsum("bhp,hp,bhp,bhq->bhq", rt, u, kt, vt))
        state = torch.exp(wt)[..., None] * state + \
            torch.einsum("bhp,bhq->bhpq", kt, vt)
    return torch.stack(outs, dim=1), state


def _wkv6_chunks(x, chunk):
    """(B,S,H,P) -> fp32 (NC, B,H,chunk,P), the chunk axis first."""
    b, s, h, p = x.shape
    return x.to(torch.float32).reshape(b, s // chunk, chunk, h, p) \
        .permute(1, 0, 3, 2, 4)


def wkv6_decays(w):
    """For a chunk's log-decays w (B,H,cs,P): L = cumsum(w), lprev = L − w,
    l_end = L[-1] (B,H,1,P), and the pairwise decays
    exp(min(lprev_t − L_j, 0)) (B,H,cs,cs,P) on the strict lower triangle
    j < t (0 elsewhere), where the exponent is already <= 0."""
    L = torch.cumsum(w, dim=2)
    lprev = L - w
    cs = w.shape[2]
    tri = torch.tril(torch.ones((cs, cs), dtype=torch.bool,
                                device=w.device), diagonal=-1)
    pair = torch.exp(torch.clamp_max(lprev[:, :, :, None] - L[:, :, None],
                                     0.0))
    pair = torch.where(tri[:, :, None], pair, 0.0)
    return L, lprev, L[:, :, -1:], pair, tri


def ref_wkv6_fwd(r, k, v, wlog, u, s0, *, chunk, with_states):
    """K6's function, as the Pallas ``_fwd_kernel`` computes it
    (``wkv6.py:57-112``), over every (B,H) at once and the chunks in turn,
    in fp32. Per chunk, with L = cumsum(w) and lprev = L − w:
      o = (r·e^{lprev})·S + Σ_{j<t} [Σ_p r_tp e^{lprev_tp − L_jp} k_jp] v_j
          + (r·u·k) v,
      S <- e^{L_end} S + (k·e^{L_end − L})ᵀ v.
    S % chunk must be 0. Returns ``(o (B,S,H,P), s_end (B,H,P,P), states
    (B,H,NC,P,P) | None)``, all fp32: ``states`` holds the state entering
    each chunk when ``with_states``."""
    b, s, h, p = r.shape
    uf = u.to(torch.float32)[None, :, None, :]              # (1,H,1,P)
    state = s0.to(torch.float32)
    outs, states = [], []
    for rc, kc, vc, wc in zip(*(_wkv6_chunks(x, chunk)
                                for x in (r, k, v, wlog))):
        if with_states:
            states.append(state)
        L, lprev, l_end, pair, _ = wkv6_decays(wc)
        o = (rc * torch.exp(lprev)) @ state
        att = (rc[:, :, :, None] * pair * kc[:, :, None]).sum(-1)
        o = o + att @ vc
        o = o + (rc * uf * kc).sum(-1, keepdim=True) * vc
        kadv = kc * torch.exp(l_end - L)
        state = torch.exp(l_end).transpose(-1, -2) * state + \
            kadv.transpose(-1, -2) @ vc
        outs.append(o)
    o = torch.stack(outs, dim=2).permute(0, 2, 3, 1, 4).reshape(b, s, h, p)
    return o, state, (torch.stack(states, dim=2) if with_states else None)


def wkv6_pair_adjoints(r, k, dA, pair):
    """The intra-chunk adjoints of att[t,j] = Σ_p r_tp pair_tjp k_jp, in
    the reference's form (``wkv6.py:223-229``): with T1 = dA ∘ pair and
    E = T1 ∘ r_t ∘ k_j, returns ``(dr_att, dk_att, dlprev_pair, dL_pair)``
    = (Σ_j T1 k, Σ_t T1 r, Σ_j E, −Σ_t E). K7 folds E away:
    dlprev_pair = r ∘ dr_att and dL_pair = −k ∘ dk_att."""
    T1 = dA[..., None] * pair                               # (B,H,t,j,P)
    E = T1 * r[:, :, :, None] * k[:, :, None]
    return ((T1 * k[:, :, None]).sum(3), (T1 * r[:, :, :, None]).sum(2),
            E.sum(3), -E.sum(2))


def ref_wkv6_bwd(r, k, v, wlog, u, states, do, ds_end, *, chunk):
    """K7's function, by the formulas of the Pallas ``_bwd_kernel``
    (``wkv6.py:184-279``) in fp32 (not by autograd): the chunks in reverse,
    carrying G = dL/dS_out from ``ds_end``,
      G_in = (r·e^{lprev})ᵀ dO + e^{L_end} G,
    with the intra-chunk adjoints recomputed from the entering ``states``
    (B,H,NC,P,P). Returns ``(dr, dk, dv, dwlog, du, ds0)``: dr/dk/dv/dwlog
    (B,S,H,P) in their primals' dtypes, du (H,P) fp32 summed over the batch
    (``wkv6.py:342``) and ds0 (B,H,P,P) fp32."""
    f32 = torch.float32
    b, s, h, p = r.shape
    nc = s // chunk
    uf = u.to(f32)[None, :, None, :]
    rcs, kcs, vcs, wcs, docs = (_wkv6_chunks(x, chunk)
                                for x in (r, k, v, wlog, do))
    g = ds_end.to(f32)
    du = torch.zeros((b, h, p), dtype=f32, device=r.device)
    grads = [[None] * nc for _ in range(4)]
    last = torch.arange(chunk, device=r.device)[:, None] == chunk - 1
    for c in reversed(range(nc)):
        rc, kc, vc, wc, dc = rcs[c], kcs[c], vcs[c], wcs[c], docs[c]
        state = states[:, :, c].to(f32)
        L, lprev, l_end, pair, tri = wkv6_decays(wc)
        e_lprev, e_adv = torch.exp(lprev), torch.exp(l_end - L)
        rdec, kadv = rc * e_lprev, kc * e_adv
        dA = torch.where(tri, dc @ vc.transpose(-1, -2), 0.0)
        dr_att, dk_att, dlprev_pair, dL_pair = wkv6_pair_adjoints(
            rc, kc, dA, pair)
        drdec = dc @ state.transpose(-1, -2)
        ds_in = rdec.transpose(-1, -2) @ dc + \
            torch.exp(l_end).transpose(-1, -2) * g
        att = (rc[:, :, :, None] * pair * kc[:, :, None]).sum(-1)
        diag = (rc * uf * kc).sum(-1, keepdim=True)
        dov = (dc * vc).sum(-1, keepdim=True)
        dv = att.transpose(-1, -2) @ dc + kadv @ g + diag * dc
        dkadv = vc @ g.transpose(-1, -2)
        dk = dk_att + dkadv * e_adv + uf * rc * dov
        dr = dr_att + drdec * e_lprev + uf * kc * dov
        du = du + (rc * kc * dov).sum(2)
        dlprev = drdec * rdec + dlprev_pair
        dl_end = (dkadv * kadv).sum(2, keepdim=True) + torch.exp(l_end) * \
            (state * g).sum(-1)[:, :, None]
        dL_tot = dL_pair - dkadv * kadv + dlprev + torch.where(last, dl_end,
                                                               0.0)
        rev = dL_tot.sum(2, keepdim=True) - torch.cumsum(dL_tot, 2) + dL_tot
        for i, x in enumerate((dr, dk, dv, rev - dlprev)):
            grads[i][c] = x
        g = ds_in
    out = []
    for chunks, like in zip(grads, (r, k, v, wlog)):
        x = torch.stack(chunks, dim=2).permute(0, 2, 3, 1, 4)
        out.append(x.reshape(b, s, h, p).to(like.dtype))
    return (*out, du.sum(0), g)
