"""Port parity for WKV6 (K6 forward, K7 backward and their autograd
Function).

On the CPU the wrappers ``wkv6_fwd``/``wkv6_bwd`` take their plain versions
(``kernels/ref.py::ref_wkv6_fwd``/``ref_wkv6_bwd``). ``ops.wkv6`` through
``WKV6`` is held against the JAX package's sequential ``ref_wkv6`` and its
model's ``wkv6_chunked``, and its gradients against ``jax.vjp`` of
``ref_wkv6`` with fixed cotangents on o and s_end, at the reference's
WKV_CASES and bounds (``tests/test_kernels.py:51-53``,
``tests/test_kernel_grads.py:58-93``): o and s_end 5e-4 in fp32 and 5e-2
in bf16, gradients 1e-3 in fp32 and 0.3 for bf16 inputs against the fp32
oracle; strong decay stays finite. The Pallas kernels are reached only
through a probe that skips while this JAX cannot build them. The CUDA
kernels are checked on the card by ``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ops import wkv6 as jax_wkv6_kernel  # noqa: E402
from repro.kernels.ref import ref_wkv6 as jax_ref_wkv6  # noqa: E402
from repro.models.rwkv6 import wkv6_chunked as jax_wkv6_chunked  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402
from repro_torch.kernels.ref import ref_wkv6, ref_wkv6_bwd, ref_wkv6_fwd, \
    wkv6_decays, wkv6_pair_adjoints  # noqa: E402

TOL = {"float32": 5e-4, "bfloat16": 5e-2}
GRAD_TOL = {"float32": 1e-3, "bfloat16": 0.3}
NAMES = ("dr", "dk", "dv", "dwlog", "du", "ds0")

# tests/test_kernel_grads.py WKV_CASES: (b, s, h, p, chunk)
WKV_CASES = [
    (1, 64, 2, 32, 16),
    (2, 128, 4, 64, 32),
    (1, 96, 2, 64, 32),
    (2, 57, 3, 32, 16),    # ragged: ops.wkv6 pads the chunk tail
]


def _inputs(b, s, h, p, seed=0):
    """(r, k, v, wlog, u, s0) and the cotangents (wo, ws) as fp32 numpy,
    drawn as the reference's tests draw them."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.normal(0, 1, shape).astype(np.float32)
    r, k, v = n(b, s, h, p), n(b, s, h, p), n(b, s, h, p)
    wlog = -np.exp(n(b, s, h, p) - 0.5)
    return (r, k, v, wlog, 0.3 * n(h, p), 0.1 * n(b, h, p, p)), \
        (n(b, s, h, p), n(b, h, p, p))


def _torch(args, dtype):
    """r/k/v/wlog in ``dtype`` (as the reference's sweep casts them), u and
    s0 in fp32."""
    dt = getattr(torch, dtype)
    return tuple(torch.from_numpy(x).to(dt) for x in args[:4]) + \
        tuple(torch.from_numpy(x) for x in args[4:])


def _port_grads(args, cot, chunk):
    leaves = [x.clone().requires_grad_() for x in args]
    o, s_end = ops.wkv6(*leaves, chunk=chunk)
    loss = (o.float() * torch.from_numpy(cot[0])).sum() + \
        (s_end.float() * torch.from_numpy(cot[1])).sum()
    return (o, s_end), torch.autograd.grad(loss, leaves)


def _jax_vjp(args, cot):
    out, vjp = jax.vjp(jax_ref_wkv6, *map(jnp.asarray, args))
    return out, vjp(tuple(map(jnp.asarray, cot)))


def _close(got, want, tol, name):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=name)


@pytest.mark.parametrize("b,s,h,p,chunk", WKV_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(b, s, h, p, chunk, dtype):
    """``ops.wkv6`` against the sequential oracle, as
    ``tests/test_kernels.py::test_wkv6_sweep`` (its wlog unquantized), and
    against the model's chunked form; the plain K6 with states where S is
    a chunk multiple."""
    args, _ = _inputs(b, s, h, p)
    targs = _torch(args, dtype)
    o, s_end = ops.wkv6(*targs, chunk=chunk)
    assert o.dtype == s_end.dtype == torch.float32
    assert o.shape == (b, s, h, p) and s_end.shape == (b, h, p, p)
    q = tuple(jnp.asarray(x.float().numpy()) for x in targs[:3])
    want_o, want_se = jax_ref_wkv6(*q, *map(jnp.asarray, args[3:]))
    _close(o, want_o, TOL[dtype], "o")
    _close(s_end, want_se, TOL[dtype], "s_end")
    chunked = jax_wkv6_chunked(*q, jnp.asarray(args[3]), jnp.asarray(args[4]),
                               chunk, jnp.asarray(args[5]))
    _close(o, chunked[0], TOL[dtype], "o (chunked)")
    if s % chunk == 0:
        o2, se2, states = ref_wkv6_fwd(*targs, chunk=chunk, with_states=True)
        assert torch.equal(o2, o) and torch.equal(se2, s_end)
        assert states.shape == (b, h, s // chunk, p, p)
        assert torch.equal(states[:, :, 0], targs[5])


@pytest.mark.parametrize("b,s,h,p,chunk", WKV_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grads_match_jax_vjp(b, s, h, p, chunk, dtype):
    """Gradients through ``WKV6`` (the plain K7 here) against ``jax.vjp``
    of ``ref_wkv6``; bf16 inputs against the fp32 oracle on the same
    quantized values (``tests/test_kernel_grads.py:60-79``)."""
    args, cot = _inputs(b, s, h, p, seed=1)
    targs = _torch(args, dtype)
    _, got = _port_grads(targs, cot, chunk)
    for g, x in zip(got, targs):
        assert g.dtype == x.dtype and g.shape == x.shape
    q = tuple(x.float().numpy() for x in targs)
    _, want = _jax_vjp(q, cot)
    for n, g, w in zip(NAMES, got, want):
        _close(g, w, GRAD_TOL[dtype], n)


@pytest.mark.parametrize("b,s,h,p,chunk", WKV_CASES[:3])
def test_plain_backward_is_the_reference_formula(b, s, h, p, chunk):
    """``ref_wkv6_bwd`` (the formulas of the Pallas ``_bwd_kernel``) from
    the plain forward's entering states, against ``jax.vjp``, du summed
    over the batch."""
    args, cot = _inputs(b, s, h, p, seed=2)
    targs = _torch(args, "float32")
    _, _, states = ref_wkv6_fwd(*targs, chunk=chunk, with_states=True)
    got = ref_wkv6_bwd(*targs[:5], states, *map(torch.from_numpy, cot),
                       chunk=chunk)
    _, want = _jax_vjp(args, cot)
    assert got[4].shape == (h, p) and got[5].shape == (b, h, p, p)
    for n, g, w in zip(NAMES, got, want):
        _close(g, w, GRAD_TOL["float32"], n)


def test_sequential_oracle_matches_jax():
    args, _ = _inputs(2, 40, 3, 32, seed=3)
    o, s_end = ref_wkv6(*map(torch.from_numpy, args))
    want_o, want_se = jax_ref_wkv6(*map(jnp.asarray, args))
    _close(o, want_o, 1e-5, "o")
    _close(s_end, want_se, 1e-5, "s_end")


def test_strong_decay_stays_finite():
    """wlog = -8 gives L_end = -256 per chunk: the pairwise-decay forward
    and backward stay finite and within 1e-3 of the oracle
    (``tests/test_kernel_grads.py:82-93``, ``tests/test_kernels.py:65-79``)."""
    b, s, h, p = 1, 128, 2, 32
    args, cot = _inputs(b, s, h, p, seed=4)
    args = args[:3] + (np.full((b, s, h, p), -8.0, np.float32),) + args[4:]
    (o, s_end), got = _port_grads(_torch(args, "float32"), cot, 32)
    (want_o, want_se), want = _jax_vjp(args, cot)
    for x in (o, s_end) + got:
        assert torch.isfinite(x).all()
    _close(o, want_o, 1e-3, "o")
    for n, g, w in zip(NAMES, got, want):
        _close(g, w, 1e-3, n)


def test_pair_adjoint_identities():
    """K7 folds the reference's E tensor away: dlprev_pair = r ∘ dr_att and
    dL_pair = −k ∘ dk_att (``wkv6.py:223-229``)."""
    rng = np.random.default_rng(5)
    b, h, cs, p = 2, 3, 16, 32
    r, k = (torch.from_numpy(rng.normal(0, 1, (b, h, cs, p)).astype(
        np.float32)) for _ in range(2))
    w = -torch.exp(torch.from_numpy(rng.normal(0, 1, (b, h, cs, p)).astype(
        np.float32)))
    _, _, _, pair, tri = wkv6_decays(w)
    dA = torch.where(tri, torch.from_numpy(rng.normal(0, 1, (b, h, cs, cs))
                                           .astype(np.float32)), 0.0)
    dr_att, dk_att, dlprev_pair, dL_pair = wkv6_pair_adjoints(r, k, dA, pair)
    torch.testing.assert_close(dlprev_pair, r * dr_att, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(dL_pair, -k * dk_att, rtol=1e-5, atol=1e-5)
    assert pair.shape == (b, h, cs, cs, p) and \
        float(pair.max()) <= 1.0 and torch.all(pair[:, :, ~tri] == 0)


def test_forward_saves_states_only_for_a_gradient(monkeypatch):
    """The primal-only K6 (no input needs a gradient) writes no states and
    the graph keeps nothing; with a gradient the entering states are saved
    beside the inputs, and the backward runs K7 and no forward."""
    b, s, h, p, cs = 2, 64, 2, 32, 16
    args, cot = _inputs(b, s, h, p, seed=6)
    targs = _torch(args, "float32")
    calls = []

    def spy(*a, with_states, **kw):
        calls.append(with_states)
        return ref_wkv6_fwd(*a, with_states=with_states, **kw)
    monkeypatch.setattr(wk, "ref_wkv6_fwd", spy)
    o, _ = ops.wkv6(*targs, chunk=cs)
    assert calls == [False] and o.grad_fn is None
    with torch.no_grad():
        ops.wkv6(*(x.requires_grad_() for x in _torch(args, "float32")),
                 chunk=cs)
    assert calls == [False, False]
    leaves = [x.clone().requires_grad_() for x in targs]
    o, s_end = wk.wkv6(*leaves, chunk=cs)
    assert calls == [False, False, True]
    assert type(o.grad_fn).__name__ == "WKV6Backward"
    saved = o.grad_fn.saved_tensors
    assert [tuple(x.shape) for x in saved[-1:]] == [(b, h, s // cs, p, p)]

    def forbid(*a, **kw):
        raise AssertionError("the backward called a forward")
    monkeypatch.setattr(wk, "ref_wkv6_fwd", forbid)
    got = torch.autograd.grad((o * torch.from_numpy(cot[0])).sum(), leaves)
    # s_end unused: its None cotangent is taken as zeros
    want = ref_wkv6_bwd(*targs[:5], saved[-1], torch.from_numpy(cot[0]),
                        torch.zeros(b, h, p, p), chunk=cs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_pads_and_chunk_clamp(monkeypatch):
    """``ops.wkv6`` clamps the chunk to WKV_CHUNK_MAX, pads a ragged S once
    per call, and takes the model's layout with no copy."""
    monkeypatch.setattr(wk.pad_to_chunk, "pads", 0)
    monkeypatch.setattr(wk.kernel_layout, "copies", 0)
    args, _ = _inputs(2, 64, 2, 32, seed=7)
    targs = _torch(args, "float32")
    o32, _ = ops.wkv6(*targs, chunk=32)
    o128, _ = ops.wkv6(*targs, chunk=128)
    assert torch.equal(o32, o128) and wk.pad_to_chunk.pads == 0
    ops.wkv6(*(x[:, :57] for x in targs[:4]), *targs[4:], chunk=16)
    assert wk.pad_to_chunk.pads == 1
    assert wk.kernel_layout(targs[0]) is targs[0]
    # a projection's (B,S,H*P) output seen per head needs no copy
    proj = torch.zeros(2, 64, 2 * 32).reshape(2, 64, 2, 32)
    assert wk.kernel_layout(proj) is proj and wk.kernel_layout.copies == 0
    odd = torch.zeros(2, 64, 32, 2).transpose(2, 3)
    assert wk.kernel_layout(odd).stride(-1) == 1
    assert wk.kernel_layout(targs[4][:, ::2], dense=True).is_contiguous()
    assert wk.kernel_layout.copies == 2


def test_checks_raise():
    args, _ = _inputs(1, 64, 2, 32)
    r, k, v, w, u, s0 = _torch(args, "float32")
    good = dict(chunk=16, with_states=False)
    bad = [
        ((r, k[:, :32], v, w, u, s0), good, "one \\(B,S,H,P\\) shape"),
        ((r, k, v, w, u[:1], s0), good, "wants u"),
        ((r, k, v, w, u, s0[:, :1]), good, "wants u"),
        ((r, k.bfloat16(), v, w, u, s0), good, "share one dtype"),
        ((r.half(), k.half(), v.half(), w, u, s0), good, "share one dtype"),
        ((r, k, v, w.half(), u, s0), good, "share one dtype"),
        ((r, k, v, w, u.bfloat16(), s0), good, "must be float32"),
        ((r, k, v, w, u, s0), dict(good, chunk=8), "chunk in"),
        ((r, k, v, w, u, s0), dict(good, chunk=64), "chunk in"),
        ((r[:, :48], k[:, :48], v[:, :48], w[:, :48], u, s0),
         dict(good, chunk=32), "multiple of the chunk"),
    ]
    for xs, kw, match in bad:
        with pytest.raises(ValueError, match=match):
            wk.wkv6_fwd(*xs, **kw)
    args48, _ = _inputs(1, 64, 2, 48)
    with pytest.raises(ValueError, match="P in"):
        wk.wkv6_fwd(*_torch(args48, "float32"), **good)
    states = torch.zeros(1, 2, 4, 32, 32)
    with pytest.raises(ValueError, match="states must be"):
        wk.wkv6_bwd(r, k, v, w, u, states[:, :, :2], r, s0, chunk=16)
    with pytest.raises(ValueError, match="states must be"):
        wk.wkv6_bwd(r, k, v, w, u, states, r.bfloat16(), s0, chunk=16)
    # a tensor of another device than cuda or cpu never reaches a kernel
    with pytest.raises(ValueError, match="runs on cuda"):
        wk.wkv6_fwd(*(x.to("meta") for x in (r, k, v, w, u, s0)), **good)
    with pytest.raises(ValueError, match="runs on cuda"):
        wk.wkv6_bwd(*(x.to("meta") for x in (r, k, v, w, u, states, r, s0)),
                    chunk=16)


def test_cpu_calls_do_not_count_launches():
    args, cot = _inputs(1, 64, 2, 32)
    before = (wk.wkv6_fwd.launches, wk.wkv6_bwd.launches)
    _port_grads(_torch(args, "float32"), cot, 16)
    assert before == (0, 0)
    assert (wk.wkv6_fwd.launches, wk.wkv6_bwd.launches) == (0, 0)


@pytest.mark.parametrize("b,s,h,p,chunk", WKV_CASES[:2])
def test_matches_pallas_interpret(b, s, h, p, chunk):
    """The port against the Pallas kernels themselves in interpret mode,
    where this JAX can build them (ROADMAP caveat R1)."""
    args, cot = _inputs(b, s, h, p, seed=8)
    (o, s_end), got = _port_grads(_torch(args, "float32"), cot, chunk)

    def loss(*a):
        o, s_end = jax_wkv6_kernel(*a, chunk=chunk, interpret=True)
        return jnp.sum(o * cot[0]) + jnp.sum(s_end * cot[1]), (o, s_end)
    try:
        (_, (want_o, want_se)), want = jax.value_and_grad(
            loss, argnums=tuple(range(6)), has_aux=True)(
            *map(jnp.asarray, args))
    except AttributeError as e:     # this JAX's Pallas cannot build the call
        pytest.skip(f"Pallas interpret mode does not run with this JAX: {e}")
    _close(o, want_o, TOL["float32"], "o")
    _close(s_end, want_se, TOL["float32"], "s_end")
    for n, g, w in zip(NAMES, got, want):
        _close(g, w, GRAD_TOL["float32"], n)


def _k7_two_phase(r, k, v, wlog, u, states, do, ds_end, chunk,
                  dtype=torch.float32):
    """K7's split in plain PyTorch (fp32 as the kernel, or ``dtype``), as
    ``csrc/wkv6.cu`` computes it:
    (a) the reverse scan writes G_c = dLoss/dS_out of every chunk,
    G_{NC-1} = dS_end and G_{c-1} = (r_c e^lprev_c)ᵀ dO_c + e^L_end,c G_c;
    (b) every chunk's adjoints at once, vectorised over the chunk axis,
    from its entering state S_c and G_c alone, with lprev_t = L_{t-1} and
    du as (B,H,NC,P) partials summed over chunks, then B. Returns the six
    gradients of ``ref_wkv6_bwd`` and the scratch G (B,H,NC,P,P)."""
    f32 = dtype
    b, s, h, p = r.shape
    nc = s // chunk

    def chunks(x):                       # (B,S,H,P) -> (B,H,NC,cs,P)
        return x.to(f32).reshape(b, nc, chunk, h, p).permute(0, 3, 1, 2, 4)
    rc, kc, vc, wc, dc = map(chunks, (r, k, v, wlog, do))
    uf = u.to(f32)[None, :, None, None, :]
    L = torch.cumsum(wc, 3)
    lprev = torch.cat([torch.zeros_like(L[..., :1, :]), L[..., :-1, :]], 3)
    lend = L[..., -1:, :]                                   # (B,H,NC,1,P)
    rdec = rc * torch.exp(lprev)

    # (a) the scan, the only serial part
    g, gs = ds_end.to(f32), [None] * nc
    for c in reversed(range(nc)):
        gs[c] = g
        g = rdec[:, :, c].transpose(-1, -2) @ dc[:, :, c] + \
            torch.exp(lend[:, :, c]).transpose(-1, -2) * g
    G, ds0, S = torch.stack(gs, 2), g, states.to(f32)

    # (b) the chunks' adjoints, all at once
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool), -1)
    pair = torch.where(tri[:, :, None], torch.exp(torch.clamp_max(
        lprev[..., :, None, :] - L[..., None, :, :], 0.0)), 0.0)
    att = (rc[..., :, None, :] * pair * kc[..., None, :, :]).sum(-1)
    dA = torch.where(tri, dc @ vc.transpose(-1, -2), 0.0)
    dr_att = (dA[..., None] * pair * kc[..., None, :, :]).sum(-2)
    dk_att = (dA[..., None] * pair * rc[..., :, None, :]).sum(-3)
    e_adv = torch.exp(lend - L)
    kadv = kc * e_adv
    drdec, dkadv = dc @ S.transpose(-1, -2), vc @ G.transpose(-1, -2)
    diag = (rc * uf * kc).sum(-1, keepdim=True)
    dov = (dc * vc).sum(-1, keepdim=True)
    dv = att.transpose(-1, -2) @ dc + kadv @ G + diag * dc
    dr = dr_att + drdec * torch.exp(lprev) + uf * kc * dov
    dk = dk_att + dkadv * e_adv + uf * rc * dov
    dlp = drdec * rdec + rc * dr_att
    kk = dkadv * kadv
    dl_end = kk.sum(3, keepdim=True) + torch.exp(lend) * \
        (S * G).sum(-1)[..., None, :]
    tot = dlp - kc * dk_att - kk
    dw = tot.flip(3).cumsum(3).flip(3) + dl_end - dlp
    du = (rc * kc * dov).sum(3).sum(2).sum(0)

    def unchunk(x):
        return x.permute(0, 2, 3, 1, 4).reshape(b, s, h, p)
    return tuple(map(unchunk, (dr, dk, dv, dw))) + (du, ds0), G


def _sequential_f64(r, k, v, wlog, u, s0, chunk):
    """The sequential oracle's recurrence (``ref_wkv6``) in float64, and the
    state entering each chunk."""
    state, outs, states = s0, [], []
    for t in range(r.shape[1]):
        if t % chunk == 0:
            states.append(state)
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], wlog[:, t]
        outs.append(torch.einsum("bhp,bhpq->bhq", rt, state)
                    + torch.einsum("bhp,hp,bhp,bhq->bhq", rt, u, kt, vt))
        state = torch.exp(wt)[..., None] * state + \
            torch.einsum("bhp,bhq->bhpq", kt, vt)
    return torch.stack(outs, 1), state, torch.stack(states, 2)


@pytest.mark.parametrize("b,s,h,p,chunk", WKV_CASES)
def test_k7_two_phase_split_matches_reference(b, s, h, p, chunk):
    """The algebra of K7's two launches, before the card (the ragged case
    padded to a chunk multiple, as ``ops.wkv6`` pads it): in float64 the
    scan's G_c and the chunk-parallel adjoints give autograd's gradients of
    the sequential recurrence within 1e-9; in fp32 they give
    ``ref_wkv6_bwd``'s within 1e-5 of each output's largest value (both
    fp32 forms sit ~3e-5 elementwise from a float64 evaluation, so an
    elementwise 1e-5 between them would measure rounding, not algebra),
    and ``jax.vjp`` of the sequential oracle within 1e-4 on the unpadded
    rows."""
    args, cot = _inputs(b, s, h, p, seed=9)
    targs = _torch(args, "float32")
    do, ds_end = map(torch.from_numpy, cot)
    pad = -s % chunk
    r, k, v, w, dop = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                       for x in targs[:4] + (do,))
    u, s0 = targs[4:]
    nc = (s + pad) // chunk

    f64 = [x.double().requires_grad_() for x in (r, k, v, w, u, s0)]
    o, s_end, states = _sequential_f64(*f64, chunk)
    exact = torch.autograd.grad((o * dop.double()).sum()
                                + (s_end * ds_end.double()).sum(), f64)
    got, G = _k7_two_phase(*(x.detach() for x in f64[:5]), states.detach(),
                           dop.double(), ds_end.double(), chunk,
                           dtype=torch.float64)
    assert torch.equal(G[:, :, nc - 1], ds_end.double())
    for n, g, x in zip(NAMES, got, exact):
        torch.testing.assert_close(g, x, rtol=1e-9, atol=1e-9, msg=n)

    _, _, states = ref_wkv6_fwd(r, k, v, w, u, s0, chunk=chunk,
                                with_states=True)
    got, G = _k7_two_phase(r, k, v, w, u, states, dop, ds_end, chunk)
    assert G.shape == wk.bwd_scratch_shapes(b, s + pad, h, p, chunk)[0]
    want = ref_wkv6_bwd(r, k, v, w, u, states, dop, ds_end, chunk=chunk)
    for n, g, x in zip(NAMES, got, want):
        assert g.shape == x.shape and g.dtype == x.dtype, n
        assert float((g - x).abs().max()) <= 1e-5 * float(x.abs().max()), n
    _, jax_want = _jax_vjp(args, cot)
    for n, g, x in zip(NAMES, got, jax_want):
        _close(g[:, :s] if n in ("dr", "dk", "dv", "dwlog") else g, x, 1e-4,
               n)


def test_k7_scratch_shapes():
    """K7's G scratch is the size of K6's states (134.2 MB at the RWKV6
    slice's B 4, S 1024, H 64, P 64, chunk 32) and its du partials are one
    (P,) row per (b, h, chunk)."""
    g, du = wk.bwd_scratch_shapes(4, 1024, 64, 64, 32)
    assert g == (4, 64, 32, 64, 64) and du == (4, 64, 32, 64)
    assert torch.empty(g, dtype=torch.float32, device="meta").nbytes == \
        134_217_728
    assert wk.bwd_scratch_shapes(2, 64, 3, 32, 16) == ((2, 3, 4, 32, 32),
                                                       (2, 3, 4, 32))
    args, _ = _inputs(2, 64, 3, 32)
    states = ref_wkv6_fwd(*_torch(args, "float32"), chunk=16,
                          with_states=True)[2]
    assert tuple(states.shape) == wk.bwd_scratch_shapes(2, 64, 3, 32, 16)[0]


def test_k7_phase_tags_name_lines_of_the_kernel():
    """``scripts/wkv6_bwd_phases.py`` takes K7's parts out by their
    ``// phase: NAME`` tags in ``wkv6.cu``: every tag it names marks lines
    there, a tagged loop header keeps its init and step with a ``false``
    condition, a tagged launch is dropped, and no other line changes."""
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "wkv6_bwd_phases", root / "scripts" / "wkv6_bwd_phases.py")
    phases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(phases)
    src = (Path(wk.__file__).parent / "csrc" / "wkv6.cu").read_text()
    counts = {"scan-launch": (0, 1), "chunk-launch": (0, 1),
              "pair-loops": (2, 0), "att-pass": (1, 0), "products": (3, 0)}
    assert {t for tags in phases.VARIANTS.values() for t in tags} == \
        set(counts)
    for tag, (loops, launches) in counts.items():
        got = phases.without(src, [tag]).split("\n")
        changed = [(a, b) for a, b in zip(src.split("\n"), got) if a != b]
        assert len(got) == len(src.split("\n"))
        assert len(changed) == loops + launches, tag
        for old, new in changed:
            if old.lstrip().startswith("for ("):
                init, _, step = old.split(";", 2)
                assert new == f"{init}; false;{step}"
            else:
                assert "<<<" in old and new == ""
    with pytest.raises(SystemExit):
        phases.without(src, ["no-such-part"])


def _k6_two_phase(r, k, v, wlog, u, s0, chunk, dtype=torch.float32,
                  slice_rows=32):
    """K6's split in plain PyTorch (fp32 as the kernel, or ``dtype``), as
    ``csrc/wkv6.cu`` computes it:
    (a) the state scan, a slice of ``slice_rows`` rows of S at a time, each
    slice from its own columns of k and wlog and all of v: S_0 = s0 and
    S_{c+1}[p] = e^L_end,p S_c[p] + sum_j k_jp e^(L_end,p - L_jp) v_j,
    writing every S_c;
    (b) every chunk's o at once, vectorised over the chunk axis, from its
    rows and S_c alone: o = (r e^lprev) S_c + att v + (r·u·k) v with
    lprev_t = L_{t-1} and att over the live triangle j < t.
    Returns ``(o, s_end, states)`` as ``ref_wkv6_fwd`` with states."""
    f32 = dtype
    b, s, h, p = r.shape
    nc = s // chunk

    def chunks(x):                       # (B,S,H,P) -> (B,H,NC,cs,P)
        return x.to(f32).reshape(b, nc, chunk, h, p).permute(0, 3, 1, 2, 4)
    rc, kc, vc, wc = map(chunks, (r, k, v, wlog))
    L = torch.cumsum(wc, 3)
    lprev = torch.cat([torch.zeros_like(L[..., :1, :]), L[..., :-1, :]], 3)
    lend = L[..., -1:, :]                                   # (B,H,NC,1,P)

    # (a) the scan, the only serial part, row slice by row slice
    states = torch.empty((b, h, nc, p, p), dtype=f32)
    s_end = torch.empty((b, h, p, p), dtype=f32)
    for p0 in range(0, p, slice_rows):
        sl = slice(p0, p0 + slice_rows)
        st = s0.to(f32)[:, :, sl]                           # (B,H,slice,P)
        kadv = kc[..., sl] * torch.exp(lend[..., sl] - L[..., sl])
        for c in range(nc):
            states[:, :, c, sl] = st
            st = torch.exp(lend[:, :, c, 0, sl])[..., None] * st + \
                kadv[:, :, c].transpose(-1, -2) @ vc[:, :, c]
        s_end[:, :, sl] = st

    # (b) the chunks' outputs, all at once
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool), -1)
    pair = torch.where(tri[:, :, None], torch.exp(torch.clamp_max(
        lprev[..., :, None, :] - L[..., None, :, :], 0.0)), 0.0)
    att = (rc[..., :, None, :] * pair * kc[..., None, :, :]).sum(-1)
    diag = (rc * u.to(f32)[None, :, None, None, :] * kc).sum(-1,
                                                              keepdim=True)
    o = (rc * torch.exp(lprev)) @ states + att @ vc + diag * vc
    return o.permute(0, 2, 3, 1, 4).reshape(b, s, h, p), s_end, states


@pytest.mark.parametrize("b,s,h,p,chunk", WKV_CASES)
def test_k6_two_phase_split_matches_reference(b, s, h, p, chunk):
    """The algebra of K6's two launches, before the card (the ragged case
    padded to a chunk multiple, as ``ops.wkv6`` pads it): in float64 the
    row-slice scan's states and s_end and the chunk-parallel o equal the
    sequential recurrence within 1e-9; in fp32 they equal ``ref_wkv6_fwd``
    within 1e-5 of each output's largest value (both fp32 forms round in
    their own order), and the JAX package's sequential oracle within 1e-4
    on the unpadded rows."""
    args, _ = _inputs(b, s, h, p, seed=10)
    targs = _torch(args, "float32")
    pad = -s % chunk
    r, k, v, w = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                  for x in targs[:4])
    u, s0 = targs[4:]

    f64 = [x.double() for x in (r, k, v, w, u, s0)]
    want = _sequential_f64(*f64, chunk)
    got = _k6_two_phase(*f64, chunk, dtype=torch.float64)
    assert torch.equal(got[2][:, :, 0], s0.double())
    for n, g, x in zip(("o", "s_end", "states"), got, want):
        torch.testing.assert_close(g, x, rtol=1e-9, atol=1e-9, msg=n)

    got = _k6_two_phase(r, k, v, w, u, s0, chunk)
    want = ref_wkv6_fwd(r, k, v, w, u, s0, chunk=chunk, with_states=True)
    assert got[2].shape == wk.fwd_scratch_shapes(b, s + pad, h, p, chunk)
    for n, g, x in zip(("o", "s_end", "states"), got, want):
        assert g.shape == x.shape and g.dtype == x.dtype, n
        assert float((g - x).abs().max()) <= 1e-5 * float(x.abs().max()), n
    jax_o, jax_se = jax_ref_wkv6(*map(jnp.asarray, args))
    _close(got[0][:, :s], jax_o, 1e-4, "o")
    _close(got[1], jax_se, 1e-4, "s_end")


def test_k6_scratch_shapes():
    """K6's scan writes every S_c to the states' shape, (B,H,NC,P,P) fp32:
    the states output, or for the primal-only call a scratch of 134.2 MB
    at the RWKV6 slice's B 4, S 1024, H 64, P 64, chunk 32 (the size of
    K7's G scratch)."""
    shape = wk.fwd_scratch_shapes(4, 1024, 64, 64, 32)
    assert shape == (4, 64, 32, 64, 64)
    assert torch.empty(shape, dtype=torch.float32, device="meta").nbytes == \
        134_217_728
    assert shape == wk.bwd_scratch_shapes(4, 1024, 64, 64, 32)[0]
    args, _ = _inputs(2, 64, 3, 32)
    states = ref_wkv6_fwd(*_torch(args, "float32"), chunk=16,
                          with_states=True)[2]
    assert tuple(states.shape) == wk.fwd_scratch_shapes(2, 64, 3, 32, 16)


def test_k6_phase_tags_name_lines_of_the_kernel():
    """K6's parts that ``scripts/wkv6_bwd_phases.py`` takes out are tagged
    ``// phase: NAME`` in ``wkv6.cu``: the scan and chunk launches, the
    chunk launch's att pass and its two products; every tag the script's
    K6 variants name marks those lines, and no other line changes."""
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "wkv6_bwd_phases", root / "scripts" / "wkv6_bwd_phases.py")
    phases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(phases)
    src = (Path(wk.__file__).parent / "csrc" / "wkv6.cu").read_text()
    counts = {"fwd-scan-launch": (0, 1), "fwd-chunk-launch": (0, 1),
              "fwd-att-pass": (1, 0), "fwd-products": (2, 0)}
    assert {t for tags in phases.FWD_VARIANTS.values() for t in tags} == \
        set(counts)
    for tag, (loops, launches) in counts.items():
        got = phases.without(src, [tag]).split("\n")
        changed = [(a, b) for a, b in zip(src.split("\n"), got) if a != b]
        assert len(got) == len(src.split("\n"))
        assert len(changed) == loops + launches, tag
        for old, new in changed:
            if old.lstrip().startswith("for ("):
                init, _, step = old.split(";", 2)
                assert new == f"{init}; false;{step}"
            else:
                assert "wkv6_fwd_" in old and "<<<" in old and new == ""
