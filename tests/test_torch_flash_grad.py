"""Port parity for the attention backward (K2, K3 and their autograd
Function).

On the CPU the wrappers ``flash_attention_bwd_dq``/``_dkv`` take their
plain version, ``kernels/ref.py::ref_attention_bwd``. It is held against
``jax.vjp`` of the JAX package's ``ref_attention`` and against the Pallas
backward in interpret mode (where that runs), at the repo's own bounds
(``tests/test_flash_grad.py:66,71``): 1e-4 in fp32, and 2e-2 for bf16
inputs against the fp32 oracle. ``torch.autograd.grad`` through
``FlashAttention`` must equal the plain backward, and must never
differentiate the forward. The CUDA kernels are checked on the card by
``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import functools  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import flash_attention as ref_fa  # noqa: E402
from repro.kernels.ref import ref_attention as jax_ref_attention  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ops import flash_mha  # noqa: E402
from repro_torch.kernels.ref import ref_attention_bwd  # noqa: E402
from repro_torch.models import attention  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2e-2}

# b, h, kh, s, d, causal, window: the ViT path (non-causal, ragged 65 and
# 197), causal, GQA, sliding windows, MQA and a single row
CASES = [
    (1, 2, 2, 65, 32, False, 0),
    (1, 2, 2, 197, 64, False, 0),
    (1, 4, 4, 100, 32, True, 0),
    (2, 8, 2, 70, 32, True, 0),
    (1, 4, 2, 96, 32, True, 24),
    (1, 2, 1, 100, 32, False, 24),
    (1, 2, 2, 1, 64, True, 0),
]


def _inputs(b, h, kh, s, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, h, s, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, kh, s, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, kh, s, d)).astype(np.float32)
    w = rng.normal(0, 1, (b, h, s, d)).astype(np.float32)   # cotangent
    return q, k, v, w


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def _jax_grads(q, k, v, w, *, causal, window):
    def loss(q, k, v):
        out = jax_ref_attention(q, k, v, causal=causal, window=window)
        return jnp.sum(out.astype(jnp.float32) * w)
    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def _plain_bwd(q, k, v, w, dtype, causal, window):
    """The port's plain forward and backward, dO = w in the output dtype
    (what autograd hands a bf16 output of ``sum(out.float() * w)``)."""
    q, k, v = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    do = torch.from_numpy(w).to(dtype)
    return ref_attention_bwd(q, k, v, out, lse, do, causal=causal,
                             window=window), (q, k, v, out, lse, do)


def _assert_close(got, want, tol):
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r, np.float32), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("b,h,kh,s,d,causal,window", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_jax_vjp(b, h, kh, s, d, causal, window,
                                        dtype):
    q, k, v, w = _inputs(b, h, kh, s, d)
    (dq, dk, dv, delta), prim = _plain_bwd(q, k, v, w, getattr(torch, dtype),
                                           causal, window)
    for g, x in zip((dq, dk, dv), prim[:3]):
        assert g.dtype == x.dtype and g.shape == x.shape
    assert delta.dtype == torch.float32 and delta.shape == (b, h, s)
    want = _jax_grads(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(w), causal=causal, window=window)
    _assert_close((dq, dk, dv), want, TOL[dtype])


@pytest.mark.parametrize("b,h,kh,s,d,causal,window", CASES[:6])
def test_plain_backward_matches_pallas_interpret(b, h, kh, s, d, causal,
                                                 window):
    q, k, v, w = _inputs(b, h, kh, s, d, seed=1)
    (dq, dk, dv, _), _ = _plain_bwd(q, k, v, w, torch.float32, causal, window)

    def loss(q, k, v):
        out = ref_fa.flash_attention(q, k, v, causal=causal, window=window,
                                     block_q=32, block_k=32, interpret=True)
        return jnp.sum(out * w)
    try:
        want = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    except AttributeError as e:     # this JAX's Pallas cannot build the call
        pytest.skip(f"Pallas interpret mode does not run with this JAX: {e}")
    _assert_close((dq, dk, dv), want, TOL["float32"])


def test_wrappers_split_the_plain_backward():
    """K2's plain path gives dq and Δ = rowsum(dO∘O); K3's takes that Δ
    as given and gives dk, dv: together they equal the one-call plain
    backward."""
    q, k, v, w = _inputs(1, 4, 2, 33, 32, seed=2)
    (dq, dk, dv, delta), (q, k, v, out, lse, do) = _plain_bwd(
        q, k, v, w, torch.float32, True, 0)
    torch.testing.assert_close(delta, (do * out).sum(-1))
    dq2, delta2 = fa.flash_attention_bwd_dq(q, k, v, out, lse, do)
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta2)
    for got, want in ((dq2, dq), (delta2, delta), (dk2, dk), (dv2, dv)):
        assert torch.equal(got, want)


def test_fully_masked_rows_contribute_nothing():
    """Window 2 with S > T: query rows 4.. see no key (lse 2**30); their dq
    is 0 and dk/dv equal those of the live rows alone."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(0, 1, (1, 2, 10, 32)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(0, 1, (1, 2, 3, 32)).astype(
        np.float32)) for _ in range(2))
    do = torch.from_numpy(rng.normal(0, 1, (1, 2, 10, 32)).astype(np.float32))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=False, window=2)
    dq, dk, dv, _ = ref_attention_bwd(q, k, v, out, lse, do, causal=False,
                                      window=2)
    assert not dq[:, :, 4:].any()
    live = slice(0, 4)
    o2, lse2 = fa.flash_attention_fwd(q[:, :, live], k, v, causal=False,
                                      window=2)
    _, dk2, dv2, _ = ref_attention_bwd(q[:, :, live], k, v, o2, lse2,
                                       do[:, :, live], causal=False, window=2)
    torch.testing.assert_close(dk, dk2)
    torch.testing.assert_close(dv, dv2)


@pytest.mark.parametrize("causal,window,kh", [(False, 0, 4), (True, 0, 2),
                                              (True, 7, 2)])
def test_autograd_function_equals_plain_backward(causal, window, kh):
    q, k, v, w = _inputs(2, 4, kh, 65, 32, seed=4)
    (dq, dk, dv, _), _ = _plain_bwd(q, k, v, w, torch.float32, causal, window)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    for g, want in zip(got, (dq, dk, dv)):
        assert torch.equal(g, want)


def test_backward_never_differentiates_the_forward(monkeypatch):
    """The graph holds one FlashAttention node over the primals, and its
    backward runs K2 then K3 (here their plain versions) with no forward
    call and no autograd through one."""
    q, k, v, w = _inputs(1, 2, 2, 40, 32, seed=5)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=False)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert [type(f[0]).__name__ for f in out.grad_fn.next_functions] == \
        ["AccumulateGrad"] * 3
    calls = []

    def forbid(*a, **kw):
        raise AssertionError("the backward called a forward")

    def spy(fn, name):
        def wrapped(*a, **kw):
            calls.append(name)
            assert not torch.is_grad_enabled() or not any(
                x.requires_grad for x in a if isinstance(x, torch.Tensor))
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(fa, "flash_attention_fwd", forbid)
    monkeypatch.setattr(fa, "ref_attention", forbid)
    monkeypatch.setattr(fa, "flash_attention_bwd_dq",
                        spy(fa.flash_attention_bwd_dq, "dq"))
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv",
                        spy(fa.flash_attention_bwd_dkv, "dkv"))
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    assert calls == ["dq", "dkv"]
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("s,d,kh", [(65, 32, 3), (197, 64, 3), (50, 32, 1)])
def test_flash_mha_grads_match_reference_sdpa(s, d, kh):
    """The model layout end to end: grads through ``flash_mha`` (the path
    ``attention_block`` takes) against ``jax.grad`` through the
    reference's naive ``sdpa`` with the ViT mask."""
    rng = np.random.default_rng(6)
    q, w = (rng.normal(0, 1, (2, s, 3, d)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.normal(0, 1, (2, s, kh, d)).astype(np.float32)
            for _ in range(2))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_mha(*leaves, causal=False, window=0)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    pos = jnp.arange(s)[None]
    mask = ref_attn._mask(pos, pos, causal=False, window=0)[:, None, None]
    want = jax.grad(lambda q, k, v: jnp.sum(ref_attn.sdpa(q, k, v, mask) * w),
                    argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v))
    _assert_close(got, want, TOL["float32"])
    # and against autograd through the port's own naive path
    leaves2 = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    mask_t = attention._mask(s, s, causal=False, window=0, device="cpu")
    out2 = attention.sdpa(*leaves2, mask_t)
    want2 = torch.autograd.grad((out2 * torch.from_numpy(w)).sum(), leaves2)
    for g, r in zip(got, want2):
        torch.testing.assert_close(g, r, atol=TOL["float32"],
                                   rtol=TOL["float32"])


def test_cpu_calls_do_not_count_launches():
    q, k, v, w = _inputs(1, 2, 2, 30, 32)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=False)
    torch.autograd.grad(out.sum(), leaves)
    assert fa.flash_attention_bwd_dq.launches == 0
    assert fa.flash_attention_bwd_dkv.launches == 0


def test_kernel_layout_copies_only_what_the_kernels_refuse(monkeypatch):
    monkeypatch.setattr(fa.kernel_layout, "copies", 0)
    model_layout = torch.zeros(2, 197, 12, 64).transpose(1, 2)
    assert fa.kernel_layout(model_layout) is model_layout
    assert fa.kernel_layout.copies == 0
    for odd in (torch.zeros(1, 2, 8, 1).expand(1, 2, 8, 64),
                torch.zeros(1, 2, 64, 8).transpose(2, 3),
                torch.zeros(1, 2, 8, 68)[..., :64],
                torch.zeros(1 + 2 * 8 * 64)[1:].view(1, 2, 8, 64)):
        fixed = fa.kernel_layout(odd)
        assert fixed.is_contiguous() and torch.equal(fixed, odd)
        assert fixed.data_ptr() % 16 == 0
    assert fa.kernel_layout.copies == 4


def test_build_cache_sees_the_shared_header(tmp_path, monkeypatch):
    """The library's name digests every ``csrc/*.cuh`` beside the source,
    so an edit to the shared flash header rebuilds K1-K3 (no ``nvcc``
    needed to check)."""
    from repro_torch.kernels import build
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.lib_path("k")
    assert build.lib_path("k") == first
    header.write_text("// v2\n")
    second = build.lib_path("k")
    assert second != first and second.parent == first.parent
    (tmp_path / "other.cuh").write_text("// new\n")
    assert build.lib_path("k") not in (first, second)
    assert {p.name for p in (tmp_path.glob("*.cuh"))} == {"common.cuh",
                                                          "other.cuh"}


# b, kh, t, d, group: the ViT-B/16 training and eval shapes (MHA), a
# 1-head group, the decoder's attention (GQA 32:2), and a group of 6
SPLIT_SHAPES = [(64, 12, 197, 64, 1), (128, 12, 197, 64, 1),
                (4, 4, 130, 64, 1), (4, 2, 1024, 128, 16),
                (1, 2, 300, 64, 6)]


@pytest.mark.parametrize("b,kh,t,d,group", SPLIT_SHAPES)
def test_dkv_group_split(b, kh, t, d, group):
    n_sm = 132
    split = fa.dkv_group_split(b, kh, t, d, group, n_sm, col_tiles=1, dv=d)
    ctas = -(-t // fa.KEY_TILE) * kh * b
    assert group % split.gs == 0
    if group == 1 or ctas >= 2 * n_sm:     # the ViT shapes: no split
        assert split.gs == 1 and split.scratch_shape == ()
    else:                                  # at least two CTAs per SM
        assert ctas * split.gs >= 2 * n_sm or split.gs == group
        assert split.scratch_shape == (split.gs, 2, b, kh, t, d)
    if (b, kh, t, group) == (4, 2, 1024, 16):
        # 512 CTAs; dk and dv partials of 4 x 2 x 4 x 1024 x 128 fp32 each
        scratch = torch.empty(split.scratch_shape, dtype=torch.float32)
        assert split.gs == 4 and ctas * split.gs == 512
        assert scratch.nbytes == 2 * (4 * 2 * 4 * 1024 * 128 * 4)


def test_key_tile_matches_the_kernel_header():
    """Where no library is loaded, :func:`dkv_group_split` sizes K3's grid
    with ``KEY_TILE``; it must be the header's BN, which the built kernel
    reports through ``repro_flash_key_tile``."""
    header = Path(fa.__file__).parent / "csrc" / "flash_common.cuh"
    tiles = re.findall(r"constexpr int BN = (\d+);", header.read_text())
    assert tiles == [str(fa.KEY_TILE)]
    split = fa.dkv_group_split(4, 2, 1024, 128, 16, 132, key_tile=128,
                               col_tiles=1, dv=128)
    assert split.gs == 8        # half the key tiles: twice the split


@pytest.mark.parametrize("causal", [False, True])
def test_group_split_partials_sum_to_the_unsplit_gradients(causal):
    """K3's split in plain form: each of ``gs`` CTAs sums dk, dv over its
    slice of every group's query heads (heads kvh*g + j*g/gs ..), and the
    second launch adds the fp32 partials in slice order j = 0, 1, ...;
    that equals the unsplit fp32 dk, dv within 1e-6 of their largest
    value (the sums regroup, so they differ by fp32 rounding: a few
    e-6 where a sum of terms of order 10 nearly cancels), and ``jax.grad``
    of the JAX package's ``ref_attention`` within the fp32 gate."""
    b, h, kh, s, d, gs = 2, 16, 2, 70, 32, 4
    g = h // kh
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(b, h, kh, s, d, 5))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    _, dk, dv, delta = ref_attention_bwd(q, k, v, out, lse, w, causal=causal)
    sum_k, sum_v = torch.zeros_like(dk), torch.zeros_like(dv)
    for j in range(gs):
        heads = [kvh * g + j * (g // gs) + i for kvh in range(kh)
                 for i in range(g // gs)]
        _, pk, pv, _ = ref_attention_bwd(
            q[:, heads], k, v, None, lse[:, heads], w[:, heads],
            causal=causal, delta=delta[:, heads])
        sum_k, sum_v = sum_k + pk, sum_v + pv
    for got, want in ((sum_k, dk), (sum_v, dv)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-6 * float(want.abs().max()))
    want = _jax_grads(*(jnp.asarray(x.numpy()) for x in (q, k, v, w)),
                      causal=causal, window=0)
    _assert_close((sum_k, sum_v), want[1:], TOL["float32"])


def test_build_takes_another_source_directory(tmp_path, monkeypatch):
    """``lib_path(name, csrc)`` names the library of another source
    directory as it would if that directory were ``CSRC``, and a copy with
    one line changed gets a library of its own (no ``nvcc`` needed)."""
    from repro_torch.kernels import build
    real = build.lib_path("wkv6")
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    assert build.lib_path("wkv6", copy) == real
    (copy / "wkv6.cu").write_text((copy / "wkv6.cu").read_text() + "\n")
    other = build.lib_path("wkv6", copy)
    assert other != real and other.parent == real.parent
    monkeypatch.setattr(build, "CSRC", copy)
    assert build.lib_path("wkv6") == other


def test_query_tile_matches_the_kernel_header():
    """K2's grid is one CTA per BM query rows, head and batch; the built
    library reports that tile through ``repro_flash_query_tile`` (which
    ``chip_smoke.py`` reads for K2's grid), so the getter must return the
    header's one BM."""
    header = Path(fa.__file__).parent / "csrc" / "flash_common.cuh"
    tiles = re.findall(r"constexpr int BM = (\d+);", header.read_text())
    assert len(tiles) == 1 and int(tiles[0]) > 0
    getter = re.search(r"int repro_flash_query_tile\(\) \{ return (\w+); \}",
                       (header.parent / "flash_bwd.cu").read_text())
    assert getter and getter.group(1) == "BM"


def _k2_bf16_dq(q, k, v, out, lse, do, causal, window):
    """dq as the bf16 K2 rounds it: S = Q Kᵀ and dP = dO Vᵀ in fp32 from
    the bf16 operands, P = exp(S·scale − lse) (masked pairs 0), dS =
    P (dP − Δ) rounded to bf16 as the A operand of dS·K, fp32 sums, times
    scale, then dq in bf16."""
    f32 = torch.float32
    b, h, s, d = q.shape
    g = h // k.shape[1]
    kf, vf = (x.repeat_interleave(g, dim=1).to(f32) for x in (k, v))
    qp = torch.arange(s)[:, None]
    kp = torch.arange(k.shape[2])[None, :]
    ok = torch.ones((s, k.shape[2]), dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= qp - kp < window
    delta = (do.to(f32) * out.to(f32)).sum(-1)
    p = torch.where(ok, torch.exp(q.to(f32) @ kf.transpose(-1, -2)
                                  * d ** -0.5 - lse[..., None]), 0.0)
    ds = p * (do.to(f32) @ vf.transpose(-1, -2) - delta[..., None])
    dq = (ds.to(torch.bfloat16).to(f32) @ kf) * d ** -0.5
    return dq.to(torch.bfloat16), delta


@pytest.mark.parametrize("b,h,kh,s,d,causal,window", CASES)
def test_k2_bf16_rounding_of_ds_stays_inside_the_gate(b, h, kh, s, d,
                                                      causal, window):
    """The bf16 K2 rounds dS to bf16 before dq += dS K (the tensor cores
    take bf16 operands): that dq stays within the bf16 gate (2e-2) of the
    plain backward, which rounds only dq, and of ``jax.grad`` of the JAX
    package's ``ref_attention``; Δ is the plain backward's."""
    q, k, v, w = _inputs(b, h, kh, s, d, seed=6)
    (dq, _, _, delta), (qt, kt, vt, out, lse, do) = _plain_bwd(
        q, k, v, w, torch.bfloat16, causal, window)
    got, got_delta = _k2_bf16_dq(qt, kt, vt, out, lse, do, causal, window)
    assert got.dtype == torch.bfloat16 and got.shape == dq.shape
    torch.testing.assert_close(got_delta, delta, rtol=1e-6, atol=1e-6)
    _assert_close((got,), (dq.float().numpy(),), TOL["bfloat16"])
    want = _jax_grads(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(w), causal=causal, window=window)
    _assert_close((got,), want[:1], TOL["bfloat16"])
