"""Port parity for attention (K1's plain path and the naive path).

On the CPU, ``repro_torch.kernels.flash_attention_fwd`` takes its plain
version; it is held against the JAX package's Pallas forward in interpret
mode (where that runs), its ``ref_attention`` oracle and a
``jax.nn.logsumexp`` lse, at fp32 atol 1e-4 (``tests/test_flash_grad.py``'s
bound). The CUDA kernel itself is checked on the card by ``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import flash_attention as ref_fa  # noqa: E402
from repro.kernels.ref import ref_attention  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ops import flash_mha  # noqa: E402
from repro_torch.models import attention  # noqa: E402

ATOL = 1e-4

# jitted, so each shape compiles once instead of op by op
jax_ref_attention = jax.jit(ref_attention, static_argnames=("causal", "window"))
jax_sdpa = jax.jit(ref_attn.sdpa)

# b, h, kh, s, d, causal: every S of the ViT path's ragged tails (65 smoke,
# 197 full) and beyond one tile, both head dims, both masks, one GQA case
CASES = [
    (1, 2, 2, 1, 32, False), (1, 2, 2, 1, 32, True),
    (1, 2, 2, 65, 64, False), (1, 2, 2, 65, 64, True),
    (1, 2, 2, 130, 32, False), (1, 2, 2, 130, 32, True),
    (1, 2, 2, 197, 64, False), (1, 2, 2, 197, 64, True),
    (2, 4, 2, 65, 32, True),
]


def _qkv(b, h, kh, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, h, s, d)).astype(np.float32),
            rng.normal(0, 1, (b, kh, s, d)).astype(np.float32),
            rng.normal(0, 1, (b, kh, s, d)).astype(np.float32))


def _port(q, k, v, **kw):
    out, lse = fa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), **kw)
    return out.numpy(), lse.numpy()


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_lse(q, k, causal, window=0):
    b, h, s, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    qg = q.reshape(b, kh, h // kh, s, d)
    scores = jnp.einsum("bkgsd,bktd->bkgst", qg, k) * d ** -0.5
    qp, kp = jnp.arange(s)[:, None], jnp.arange(t)[None, :]
    ok = jnp.ones((s, t), bool)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= (qp - kp) < window
    scores = jnp.where(ok, scores, ref_fa.NEG_INF)
    return jax.nn.logsumexp(scores, axis=-1).reshape(b, h, s)


@pytest.mark.parametrize("b,h,kh,s,d,causal", CASES)
def test_plain_path_matches_pallas_interpret(b, h, kh, s, d, causal):
    q, k, v = _qkv(b, h, kh, s, d)
    out, lse = _port(q, k, v, causal=causal)
    try:
        want_out, want_lse = ref_fa.flash_attention_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            interpret=True)
    except AttributeError as e:     # this JAX's Pallas cannot build the call
        pytest.skip(f"Pallas interpret mode does not run with this JAX: {e}")
    np.testing.assert_allclose(out, np.asarray(want_out), atol=ATOL)
    np.testing.assert_allclose(lse, np.asarray(want_lse), atol=ATOL)


@pytest.mark.parametrize("b,h,kh,s,d,causal", CASES)
def test_plain_path_matches_jax_ref(b, h, kh, s, d, causal):
    q, k, v = _qkv(b, h, kh, s, d, seed=1)
    out, lse = _port(q, k, v, causal=causal)
    want = jax_ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal)
    np.testing.assert_allclose(out, np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(lse, np.asarray(_jax_lse(q, k, causal)), atol=ATOL)


def test_window_and_fully_masked_rows():
    """Rows with no live key (window 2, S > T) give out 0 and lse 2**30,
    as the kernel does; the live rows match the JAX oracle."""
    rng = np.random.default_rng(3)
    q = rng.normal(0, 1, (1, 2, 10, 32)).astype(np.float32)
    k = rng.normal(0, 1, (1, 2, 3, 32)).astype(np.float32)
    v = rng.normal(0, 1, (1, 2, 3, 32)).astype(np.float32)
    out, lse = _port(q, k, v, causal=False, window=2)
    want = np.asarray(jax_ref_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=False,
                                        window=2))
    live = slice(0, 4)                  # q - k < 2 needs q <= t = 3
    np.testing.assert_allclose(out[:, :, live], want[:, :, live], atol=ATOL)
    np.testing.assert_allclose(lse[:, :, live],
                               np.asarray(_jax_lse(q, k, False, 2))[:, :, live],
                               atol=ATOL)
    assert not out[:, :, 4:].any()
    assert (lse[:, :, 4:] == 2.0 ** 30).all()


@pytest.mark.parametrize("s,d", [(65, 32), (197, 64)])
def test_flash_mha_matches_reference_sdpa(s, d):
    """The model-layout dispatch against the reference's naive path with
    the non-causal ViT mask."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(0, 1, (2, s, 3, d)).astype(np.float32)
               for _ in range(3))
    got = flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), causal=False, window=0)
    pos = jnp.arange(s)[None]
    mask = ref_attn._mask(pos, pos, causal=False, window=0)[:, None, None]
    want = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask)
    assert tuple(got.shape) == (2, s, 3, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("causal,window,kh", [(False, 0, 4), (True, 5, 2)])
def test_port_sdpa_matches_reference_sdpa(causal, window, kh):
    rng = np.random.default_rng(5)
    q = rng.normal(0, 1, (2, 33, 4, 32)).astype(np.float32)
    k, v = (rng.normal(0, 1, (2, 33, kh, 32)).astype(np.float32)
            for _ in range(2))
    mask = attention._mask(33, 33, causal=causal, window=window,
                           device="cpu")
    got = attention.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), mask)
    pos = jnp.arange(33)[None]
    ref_mask = ref_attn._mask(pos, pos, causal=causal,
                              window=window)[:, None, None]
    want = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), ref_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_cpu_calls_do_not_count_launches():
    q, k, v = _qkv(1, 2, 2, 65, 32)
    _port(q, k, v, causal=False)
    flash_mha(*(torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)),
              causal=False)
    assert fa.flash_attention_fwd.launches == 0


def test_kernel_input_checks():
    """What the CUDA wrapper refuses, checked on host tensors: the model's
    (B,S,H,D) view passes; odd head dims, Dv != D, fp16 and misaligned
    strides raise."""
    x = torch.zeros((2, 197, 12, 64)).transpose(1, 2)
    fa.check_kernel_inputs(x, x, x)
    fa.check_kernel_inputs(*(t.bfloat16() for t in (x, x, x)))
    bad = [
        (torch.zeros(1, 2, 8, 48),) * 3,
        (torch.zeros(1, 2, 8, 64), torch.zeros(1, 2, 8, 64),
         torch.zeros(1, 2, 8, 32)),
        (torch.zeros(1, 2, 8, 64, dtype=torch.float16),) * 3,
        (torch.zeros(1, 2, 8, 68)[..., :64],) * 3,
    ]
    for q, k, v in bad:
        with pytest.raises(ValueError):
            fa.check_kernel_inputs(q, k, v)
    with pytest.raises(ValueError, match="divisible"):
        fa.check_shapes(torch.zeros(1, 3, 8, 32), torch.zeros(1, 2, 8, 32),
                        torch.zeros(1, 2, 8, 32))
