"""Port parity at head sizes and chunks the kernels are not built for
(ROADMAP F2): K1-K3 at a (D, Dv) outside ``HEAD_DIM_PAIRS`` and WKV6
(K6/K7 through ``ops.wkv6``) at a P outside {32, 64} or a chunk outside
{16, 32} run at the next built size, the inputs padded with zeros and the
outputs sliced back.

On the CPU the wrappers pad as on the card and call their plain versions
at the padded widths, so this holds the padding code itself: the forward
and the gradients against ``repro.kernels.ref`` (fp32 1e-4; WKV6 1e-3,
``tests/test_kernel_grads.py``'s bound) and against the unpadded plain
versions. The refusals that stay (D or Dv > 256, P > 64) are named by
their messages. The CUDA kernels at padded shapes are checked on the card
by ``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ref import ref_attention as jax_ref_attention  # noqa: E402
from repro.kernels.ref import ref_wkv6 as jax_ref_wkv6  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402
from repro_torch.kernels.ref import ref_attention, ref_attention_bwd, \
    ref_wkv6_bwd, ref_wkv6_fwd  # noqa: E402

TOL, WKV_TOL = 1e-4, 1e-3

# (D, Dv) -> the built pair it runs at
PAIRS = {(16, 16): (32, 32), (96, 96): (128, 128), (40, 24): (48, 32)}
# b, h, kh, s, causal, window
ATTN = [(2, 4, 2, 37, True, 0), (1, 2, 2, 30, False, 0),
        (1, 4, 1, 41, True, 9)]
# (P, requested chunk) -> (the padded P, the chunk it runs at)
WKV = {(16, 8): (32, 16), (48, 24): (64, 16), (16, 24): (32, 16),
       (48, 8): (64, 16)}


def _qkv(b, h, kh, s, d, dv, seed):
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.normal(0, 1, shape).astype(np.float32)
    return n(b, h, s, d), n(b, kh, s, d), n(b, kh, s, dv), n(b, h, s, dv)


@pytest.mark.parametrize("pair", list(PAIRS), ids=lambda p: f"{p[0]}x{p[1]}")
@pytest.mark.parametrize("b,h,kh,s,causal,window", ATTN)
def test_flash_at_an_unbuilt_pair(pair, b, h, kh, s, causal, window,
                                  monkeypatch):
    """``flash_attention`` (K1 forward, K2/K3 backward) at a padded pair:
    out and dq/dk/dv against the JAX reference and its ``jax.grad``, and
    against the unpadded plain forward and backward; each of the three
    wrapper calls pads once."""
    d, dv = pair
    assert fa.built_pair(d, dv) == PAIRS[pair]
    monkeypatch.setattr(fa.pad_head_dims, "pads", 0)
    q, k, v, w = _qkv(b, h, kh, s, d, dv, seed=d + dv + s)
    kw = {"causal": causal, "window": window}
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, **kw)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    assert out.shape == (b, h, s, dv) and fa.pad_head_dims.pads == 3
    assert [g.shape for g in grads] == [x.shape for x in leaves]

    def loss(q, k, v):
        return jnp.sum(jax_ref_attention(q, k, v, **kw) * w)
    want_out = jax_ref_attention(*map(jnp.asarray, (q, k, v)), **kw)
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=TOL, rtol=TOL)
    for g, r in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL,
                                   rtol=TOL)
    tq, tk, tv, tw = map(torch.from_numpy, (q, k, v, w))
    plain, lse = ref_attention(tq, tk, tv, **kw)
    plain_g = ref_attention_bwd(tq, tk, tv, plain, lse, tw, **kw)[:3]
    np.testing.assert_allclose(out.detach().numpy(), plain.numpy(),
                               atol=TOL, rtol=TOL)
    for g, r in zip(grads, plain_g):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=TOL, rtol=TOL)
    # the wrappers' lse and delta are the unpadded ones
    got_out, got_lse = fa.flash_attention_fwd(tq, tk, tv, **kw)
    np.testing.assert_allclose(got_lse.numpy(), lse.numpy(), atol=TOL,
                               rtol=TOL)
    _, delta = fa.flash_attention_bwd_dq(tq, tk, tv, got_out, got_lse, tw,
                                         **kw)
    np.testing.assert_allclose(delta.numpy(), (tw * plain).sum(-1).numpy(),
                               atol=TOL, rtol=TOL)


def test_flash_mha_at_an_unbuilt_pair_in_the_model_layout():
    """The model's (B,S,H,D) views through ``flash_mha`` at (40, 24):
    the padded wrappers take the transposed views and return (B,S,H,Dv)."""
    q, k, v, _ = _qkv(2, 4, 2, 33, 40, 24, seed=1)
    got = ops.flash_mha(*(torch.from_numpy(x).transpose(1, 2)
                          for x in (q, k, v)), causal=True)
    want, _ = ref_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    assert got.shape == (2, 33, 4, 24)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want.numpy(),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("d,dv", [(264, 264), (64, 320), (512, 128)])
def test_flash_refuses_above_the_largest_pair(d, dv):
    """D or Dv above 256 still raises, naming the largest built width."""
    q, k, v, _ = _qkv(1, 2, 2, 8, d, dv, seed=0)
    with pytest.raises(ValueError, match="kernel head dims go up to D = "
                                         "Dv = 256"):
        fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)))
    with pytest.raises(ValueError, match="go up to"):
        fa.built_pair(d, dv)


def test_flash_on_meta_charges_the_padded_work():
    """On ``meta`` (the dry run) the padded wrapper returns the true
    widths and charges the op counter with the built pair's work."""
    from repro_torch.launch import op_count
    q, k, v = (torch.empty(shape, device="meta") for shape in
               ((1, 4, 64, 40), (1, 2, 64, 40), (1, 2, 64, 24)))
    with op_count.OpCounter() as counter:
        out, lse = fa.flash_attention_fwd(q, k, v)
    assert out.shape == (1, 4, 64, 24) and lse.shape == (1, 4, 64)
    nbytes, flops = op_count.attn_work((1, 4, 2, 64, 64, 48, 32), 4,
                                       True)["fwd"]
    assert counter.by_op["kernel.flash_fwd"][:2] == [flops, nbytes]


def _wkv_inputs(b, s, h, p, seed):
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.normal(0, 1, shape).astype(np.float32)
    args = (n(b, s, h, p), n(b, s, h, p), n(b, s, h, p),
            -np.exp(n(b, s, h, p) - 0.5), 0.3 * n(h, p), 0.1 * n(b, h, p, p))
    return args, (n(b, s, h, p), n(b, h, p, p))


@pytest.mark.parametrize("p,chunk", list(WKV), ids=lambda x: str(x))
def test_wkv6_at_an_unbuilt_head_size_and_chunk(p, chunk, monkeypatch):
    """``ops.wkv6`` at P 16/48 and chunk 8/24 (S 48, a multiple of both
    and of the chunk it runs at, 16): o, s_end and the six gradients
    against ``jax.vjp`` of the JAX package's ``ref_wkv6`` and against the
    unpadded plain K6/K7 at the requested chunk, within 1e-3."""
    monkeypatch.setattr(wk.pad_head_dim, "pads", 0)
    monkeypatch.setattr(wk.pad_to_chunk, "pads", 0)
    assert wk.built_chunk(chunk) == WKV[p, chunk][1]
    b, s, h = 2, 48, 3
    args, cot = _wkv_inputs(b, s, h, p, seed=p + chunk)
    leaves = [torch.from_numpy(x).requires_grad_() for x in args]
    o, s_end = ops.wkv6(*leaves, chunk=chunk)
    assert o.shape == (b, s, h, p) and s_end.shape == (b, h, p, p)
    assert wk.pad_head_dim.pads == 1 and wk.pad_to_chunk.pads == 0
    loss = (o * torch.from_numpy(cot[0])).sum() + \
        (s_end * torch.from_numpy(cot[1])).sum()
    grads = torch.autograd.grad(loss, leaves)
    (want_o, want_se), vjp = jax.vjp(jax_ref_wkv6, *map(jnp.asarray, args))
    want_g = vjp(tuple(map(jnp.asarray, cot)))
    for got, want in zip((o, s_end) + grads, (want_o, want_se) + want_g):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=WKV_TOL, rtol=WKV_TOL)
    targs = tuple(map(torch.from_numpy, args))
    plain_o, plain_se, states = ref_wkv6_fwd(*targs, chunk=chunk,
                                             with_states=True)
    plain_g = ref_wkv6_bwd(*targs[:5], states, *map(torch.from_numpy, cot),
                           chunk=chunk)
    for got, want in zip((o, s_end) + grads, (plain_o, plain_se) + plain_g):
        np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                                   atol=WKV_TOL, rtol=WKV_TOL)


def test_wkv6_pads_a_ragged_sequence_at_an_unbuilt_head_size(monkeypatch):
    """P 48 and chunk 24 at S 57: the chunk runs at 16, S pads to 64 and
    P to 64, each counted once; o equals the unpadded plain forward."""
    monkeypatch.setattr(wk.pad_head_dim, "pads", 0)
    monkeypatch.setattr(wk.pad_to_chunk, "pads", 0)
    args, _ = _wkv_inputs(1, 57, 2, 48, seed=4)
    targs = tuple(map(torch.from_numpy, args))
    o, s_end = ops.wkv6(*targs, chunk=24)
    assert wk.pad_head_dim.pads == 1 and wk.pad_to_chunk.pads == 1
    want_o, want_se = (np.asarray(x) for x in
                       jax_ref_wkv6(*map(jnp.asarray, args)))
    np.testing.assert_allclose(o.numpy(), want_o, atol=WKV_TOL, rtol=WKV_TOL)
    np.testing.assert_allclose(s_end.numpy(), want_se, atol=WKV_TOL,
                               rtol=WKV_TOL)


def test_wkv6_refuses_above_the_largest_head_size():
    """P above 64 still raises; the wrappers themselves still take only
    the built P and chunks (``ops.wkv6`` pads and maps)."""
    args, _ = _wkv_inputs(1, 32, 2, 80, seed=0)
    targs = tuple(map(torch.from_numpy, args))
    with pytest.raises(ValueError, match="the kernels take P up to 64; got "
                                         "P=80"):
        ops.wkv6(*targs, chunk=16)
    args, _ = _wkv_inputs(1, 32, 2, 48, seed=0)
    with pytest.raises(ValueError, match="P in"):
        wk.wkv6_fwd(*map(torch.from_numpy, args), chunk=16,
                    with_states=False)
