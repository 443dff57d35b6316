"""Port parity for the dense-decoder family (``qwen2.5-14b``, ``glm4-9b``,
``gemma3-12b``): the configs, the LM forward, loss and gradients of each,
Gemma3's branches (the tied embedding and its rounded sqrt(d) scale,
GeGLU, the 5:1 local:global window), the logit softcap, the blockwise
flash in PyTorch, activation checkpointing, K1-K3's plain path at head dim
256 and the training CLI.

The reference side is the JAX package's pure functions
(``model.forward``, ``model.loss_fn`` with ``jax.value_and_grad``,
``mlp``, ``sdpa``, ``blockwise_attention``, ``kernels.ref``), never
``DistributedEngine``. Its smoke params cross with ``params_from_numpy``,
with the unit norm scales (and zero biases) perturbed by numpy noise on
both sides so that every branch matters. Tolerances are
``tests/test_torch_lm.py``'s: logits 1e-4, loss 1e-5, grads 2e-4; the
blockwise checks take ``tests/test_models_math.py:89``'s (rtol 1e-5 on
the value, 1e-4 on the grads) and ``tests/test_perf_options.py:92``'s
(logits 3e-4). The CUDA kernels at head dim 256 are checked on the card
by ``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import dataclasses  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.kernels.ref import ref_attention as jax_ref_attention  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import blockwise as ref_blockwise  # noqa: E402
from repro.models import mlp as ref_mlp  # noqa: E402
from repro.models import transformer as ref_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ref import ref_attention_bwd  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models import attention, blockwise, mlp, \
    transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCHS = ("qwen2.5-14b", "glm4-9b", "gemma3-12b")
LOGITS_TOL, LOSS_TOL, GRAD_TOL = 1e-4, 1e-5, 2e-4
VOCAB = 512
# gemma3's smoke window is 64: at 128 tokens the local layer's mask bites
SEQ = {"qwen2.5-14b": 32, "glm4-9b": 32, "gemma3-12b": 128}


def _flat(tree, prefix=""):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flat(leaf, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = np.asarray(leaf)
    return out


@functools.lru_cache(maxsize=None)
def _smoke(arch, **replace):
    """(reference cfg, reference params, numpy param tree), fp32, with the
    norm scales and qkv biases perturbed."""
    cfg = ref_configs.get_smoke_config(arch).replace(dtype="float32",
                                                     **replace)
    params = jax.jit(lambda k: ref_model.init_params(cfg, k))(
        jax.random.PRNGKey(0))
    tree = jax.tree.map(np.array, params)
    rng = np.random.default_rng(7)
    groups = [("ln1", ("scale",)), ("ln2", ("scale",))]
    if cfg.qkv_bias:
        groups.append(("attn", ("bq", "bk", "bv")))
    for group, keys in groups:
        for key in keys:
            leaf = tree["stack"][group][key]
            leaf += rng.normal(0, 0.1, leaf.shape).astype(np.float32)
    tree["final_norm"]["scale"] += rng.normal(
        0, 0.1, tree["final_norm"]["scale"].shape).astype(np.float32)
    return cfg, jax.tree.map(jnp.asarray, tree), tree


def _port_cfg(arch, **kw):
    return configs.get_smoke_config(arch).replace(**{"dtype": "float32",
                                                     **kw})


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(
        0, VOCAB, (b, s)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(cfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: ref_model.loss_fn(cfg, p, b), has_aux=True))


def _port_loss_and_grads(cfg, tree, tokens):
    leaves = {k: v.requires_grad_() for k, v in
              params_from_numpy(tree).items()}
    tb = {"tokens": torch.from_numpy(tokens)}
    logits, aux = transformer.forward(cfg, leaves, tb)
    loss, metrics = transformer.loss_from_logits(cfg, logits, tb, aux)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return logits, loss, metrics, dict(zip(leaves, grads))


# --- configs --------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factory", ["config", "smoke"])
def test_config_fields_match_reference(arch, factory):
    port = getattr(configs.REGISTRY[arch], factory)()
    ref = getattr(ref_configs.REGISTRY[arch], factory)()
    for f in dataclasses.fields(port):
        if f.name != "use_kernels":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.layer_windows() == ref.layer_windows()
    assert (configs.get_config if factory == "config"
            else configs.get_smoke_config)(arch) == port
    assert arch not in configs.NOT_YET_PORTED


def test_gemma3_windows_are_five_local_to_one_global():
    cfg = configs.get_config("gemma3-12b")
    assert cfg.layer_windows() == ([1024] * 5 + [0]) * 8
    assert cfg.replace(num_layers=6).layer_windows() == [1024] * 5 + [0]
    assert cfg.head_dim == 256 and cfg.head_dim != cfg.d_model // \
        cfg.num_heads


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_shapes_match_reference(arch):
    """At full width and two layers every param's key and shape equal the
    reference's ``jax.eval_shape``; a tied model has no ``head.w``."""
    ref_cfg = ref_configs.get_config(arch).replace(num_layers=2)
    want = jax.eval_shape(lambda k: ref_model.init_params(ref_cfg, k),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    params = transformer.init_params(
        configs.get_config(arch).replace(num_layers=2), device="meta")
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in _flat_shapes(want).items()}
    assert ("head.w" in params) == (not ref_cfg.tie_embeddings)
    assert sum(v.numel() for v in params.values()) == ref_cfg.param_count()


def _flat_shapes(tree, prefix=""):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flat_shapes(leaf, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = leaf
    return out


# --- the model against the reference ---------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernels", [True, False])
def test_logits_loss_and_grads_match_jax(arch, use_kernels):
    """fp32 logits, loss and every gradient against the reference's
    ``forward`` and ``jax.value_and_grad(loss_fn)``; for gemma3 at 128
    tokens, past its 64-token window, with the tied embedding's gradient
    the sum of the lookup's and the head's."""
    cfg, params, tree = _smoke(arch)
    tokens = _tokens(2, SEQ[arch], seed=1)
    jb = {"tokens": jnp.asarray(tokens)}
    want_logits = jax.jit(lambda p, b: ref_model.forward(cfg, p, b)[0])(
        params, jb)
    (loss, metrics), grads = _ref_value_and_grad(cfg)(params, jb)
    pcfg = _port_cfg(arch, use_kernels=use_kernels)
    logits, got_loss, got_m, got = _port_loss_and_grads(pcfg, tree, tokens)
    assert logits.shape == (2, SEQ[arch], VOCAB)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), atol=LOGITS_TOL)
    assert set(got_m) == set(metrics)
    np.testing.assert_allclose(float(got_loss.detach()), float(loss),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    want = _flat(grads)
    assert set(want) == set(got)
    for key, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[key], atol=GRAD_TOL,
                                   err_msg=key)
    if pcfg.tie_embeddings:
        assert "head.w" not in got and got["embed.tok"].abs().max() > 0


def test_gemma3_window_bites_at_the_test_length():
    """The gemma3 parity runs past the local layer's window: a wider
    window changes the logits there."""
    cfg, _, tree = _smoke("gemma3-12b")
    tokens = {"tokens": torch.from_numpy(_tokens(1, SEQ["gemma3-12b"], 2))}
    params = params_from_numpy(tree)
    narrow, _ = transformer.forward(_port_cfg("gemma3-12b"), params, tokens)
    wide, _ = transformer.forward(
        _port_cfg("gemma3-12b", sliding_window=1024), params, tokens)
    assert cfg.sliding_window < SEQ["gemma3-12b"]
    assert torch.equal(narrow[:, :cfg.sliding_window],
                       wide[:, :cfg.sliding_window])
    assert (narrow - wide).abs().max() > 1e-3


@pytest.mark.parametrize("d_model", [192, 256])
def test_embed_scale_is_rounded_to_the_compute_dtype(d_model):
    """bf16 gemma3: the token embedding times sqrt(d) rounded to bf16 first
    (13.875 for sqrt(192) = 13.856...), bitwise as the reference's
    ``_embed``; at 192 the unrounded scale would differ. Then the whole
    bf16 forward agrees with the reference's within bf16's rounding."""
    ref_cfg, params, tree = _smoke("gemma3-12b", d_model=d_model)
    ref_cfg = ref_cfg.replace(dtype="bfloat16")
    cfg = _port_cfg("gemma3-12b", d_model=d_model, dtype="bfloat16")
    tokens = _tokens(2, 64, seed=3)
    want_h, _ = ref_model._embed(ref_cfg, params,
                                 {"tokens": jnp.asarray(tokens)}, "train")
    port = params_from_numpy(tree)
    got_h, _ = transformer._embed(cfg, port, {"tokens":
                                              torch.from_numpy(tokens)})
    assert got_h.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_h.float().numpy(),
                                  np.asarray(want_h, np.float32))
    unrounded = (port["embed.tok"][torch.from_numpy(tokens).long()]
                 .to(torch.bfloat16) * math.sqrt(d_model))
    assert torch.equal(unrounded, got_h) == (d_model == 256)
    want = jax.jit(lambda p, b: ref_model.forward(ref_cfg, p, b)[0])(
        params, {"tokens": jnp.asarray(tokens)})
    got, _ = transformer.forward(cfg, port,
                                 {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=0.1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_geglu_matches_reference_mlp(dtype):
    rng = np.random.default_rng(4)
    d, ff = 48, 96
    p = {"w_gate": rng.normal(0, 0.2, (d, ff)).astype(np.float32),
         "w_up": rng.normal(0, 0.2, (d, ff)).astype(np.float32),
         "w_out": rng.normal(0, 0.2, (ff, d)).astype(np.float32)}
    x = rng.normal(0, 1, (2, 7, d)).astype(np.float32)
    want = ref_mlp.mlp({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x).astype(dtype), "geglu")
    got = mlp.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                  torch.from_numpy(x).to(getattr(torch, dtype)), "geglu")
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    swiglu = mlp.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x), "swiglu")
    assert not torch.allclose(swiglu, mlp.mlp(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        "geglu"))


# --- softcap -------------------------------------------------------------


@pytest.mark.parametrize("softcap", [0.0, 5.0, 50.0])
@pytest.mark.parametrize("window", [0, 12])
def test_sdpa_softcap_matches_reference(softcap, window):
    rng = np.random.default_rng(5)
    q = rng.normal(0, 3, (2, 40, 4, 32)).astype(np.float32)
    k = rng.normal(0, 3, (2, 40, 2, 32)).astype(np.float32)
    v = rng.normal(0, 1, (2, 40, 2, 32)).astype(np.float32)
    pos = jnp.arange(40)[None]
    mask = ref_attn._mask(pos, pos, causal=True, window=window)[:, None, None]
    want = ref_attn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         mask, softcap=softcap)
    tmask = attention._mask(40, 40, causal=True, window=window,
                            device="cpu")
    got = attention.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), tmask, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    if softcap:
        plain = attention.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), tmask)
        assert (plain - got).abs().max() > 1e-3


def test_softcap_never_reaches_the_flash_path(monkeypatch):
    """gemma3 smoke with a logit softcap and ``use_kernels``: the logits
    equal the reference's (which takes its naive path too), and neither the
    flash kernels' entry nor the blockwise path is called."""
    cfg, params, tree = _smoke("gemma3-12b", attn_logit_softcap=5.0)
    tokens = _tokens(2, 96, seed=6)
    want = jax.jit(lambda p, b: ref_model.forward(cfg, p, b)[0])(
        params, {"tokens": jnp.asarray(tokens)})

    def refuse(*a, **kw):
        raise AssertionError("a softcapped layer reached a flash path")
    monkeypatch.setattr(attention, "flash_mha", refuse)
    monkeypatch.setattr(attention, "blockwise_attention_qchunked", refuse)
    for impl in ("naive", "blockwise"):
        pcfg = _port_cfg("gemma3-12b", attn_logit_softcap=5.0,
                         use_kernels=True, attn_impl=impl)
        got, _ = transformer.forward(pcfg, params_from_numpy(tree),
                                     {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGITS_TOL)


def test_attention_routes_as_the_reference(monkeypatch):
    """Kernels first (``use_kernels``), then ``attn_impl="blockwise"``,
    else the naive sdpa."""
    calls = []
    monkeypatch.setattr(attention, "flash_mha",
                        lambda *a, **kw: calls.append("flash") or a[0])
    monkeypatch.setattr(attention, "blockwise_attention_qchunked",
                        lambda *a, **kw: calls.append("blockwise") or a[0])
    cfg = _port_cfg("qwen2.5-14b")
    p = {k[len("stack.attn."):]: v[0] for k, v in
         transformer.init_params(cfg, device="cpu").items()
         if k.startswith("stack.attn.")}
    x = torch.zeros((1, 8, cfg.d_model))
    pos = torch.arange(8)[None]
    for kw, want in (({"use_kernels": True, "attn_impl": "blockwise"},
                      "flash"),
                     ({"use_kernels": False, "attn_impl": "blockwise"},
                      "blockwise"),
                     ({"use_kernels": False}, None)):
        calls.clear()
        attention.attention_block(p, x, cfg.replace(**kw), window=0,
                                  positions=pos)
        assert calls == ([want] if want else [])


# --- blockwise ------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("causal", "window", "bk",
                                             "chunked"))
def _jax_blockwise_value_and_grads(q, k, v, *, causal, window, bk, chunked):
    def f(q, k, v):
        if chunked:
            o = ref_blockwise.blockwise_attention_qchunked(
                q, k, v, window, causal=causal, block_k=bk, block_q=bk)
        else:
            o = ref_blockwise.blockwise_attention(q, k, v, window,
                                                  causal=causal, block_k=bk)
        return jnp.sum(jnp.sin(o))
    return jax.value_and_grad(f, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("causal,window,bk", [
    (True, 0, 64), (True, 32, 32), (False, 0, 128), (True, 0, 48),
])
@pytest.mark.parametrize("chunked", [False, True])
def test_blockwise_attention_matches_reference(causal, window, bk, chunked):
    """``sum(sin(out))`` and its gradients against the reference's
    ``blockwise_attention`` (and its q-chunked scan), as
    ``tests/test_models_math.py:89`` holds the reference against
    ``ref_attention``; block 48 shrinks to 32 to divide T = 128."""
    b, s, h, kh, d = 2, 128, 4, 2, 32
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(0, 1, (b, s, n, d)).astype(np.float32)
               for n in (h, kh, kh))
    val, grads = _jax_blockwise_value_and_grads(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, bk=bk, chunked=chunked)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    if chunked:
        out = blockwise.blockwise_attention_qchunked(
            *leaves, window, causal=causal, block_k=bk, block_q=bk)
    else:
        out = blockwise.blockwise_attention(*leaves, window, causal=causal,
                                            block_k=bk)
    got = torch.sin(out).sum()
    np.testing.assert_allclose(float(got.detach()), float(val), rtol=1e-5)
    for g, w in zip(torch.autograd.grad(got, leaves), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_blockwise_backward_recomputes_from_the_lse(monkeypatch):
    """The backward is the flash backward of ``BlockwiseAttention``: the
    forward's loop is not differentiated (autograd records no graph
    through it), and its grads equal the plain attention's."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (1, 64, n, 16)).astype(
        np.float32)).requires_grad_() for n in (2, 1, 1))
    out = blockwise.blockwise_attention(q, k, v, 0, causal=True, block_k=16)
    assert type(out.grad_fn).__name__ == "BlockwiseAttentionBackward"
    want = attention.sdpa(q, k, v, attention._mask(64, 64, causal=True,
                                                   window=0, device="cpu"))
    gw = rng.normal(0, 1, out.shape).astype(np.float32)
    got = torch.autograd.grad(out, (q, k, v), torch.from_numpy(gw))
    ref = torch.autograd.grad(want, (q, k, v), torch.from_numpy(gw))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)


def test_blockwise_prescales_q_in_its_dtype():
    """bf16: q times a bf16 D^-0.5, rounded before any product, as the
    reference's ``_prep``; the forward agrees with the reference's."""
    rng = np.random.default_rng(10)
    q, k, v = (rng.normal(0, 1, (1, 96, n, 48)).astype(np.float32)
               for n in (4, 2, 2))
    tq = torch.from_numpy(q).bfloat16()
    qg, bk = blockwise._prep(tq, torch.from_numpy(k), 40)
    assert bk == 32 and qg.dtype == torch.bfloat16
    want_qg, want_bk = ref_blockwise._prep(
        jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(k), 40)
    assert want_bk == bk
    np.testing.assert_array_equal(qg.float().numpy(),
                                  np.asarray(want_qg, np.float32))
    got = blockwise.blockwise_attention_qchunked(
        tq, *(torch.from_numpy(x).bfloat16() for x in (k, v)), 24,
        causal=True, block_k=32, block_q=32)
    want = ref_blockwise.blockwise_attention_qchunked(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)), 24,
        causal=True, block_k=32, block_q=32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


def test_blockwise_full_model_parity():
    """gemma3 smoke with ``attn_impl="blockwise"`` (blocks of 32) and the
    kernels off against the reference's naive forward, at
    ``tests/test_perf_options.py:92``'s 3e-4, and the grads of the port's
    naive path within the gradient gate."""
    cfg, params, tree = _smoke("gemma3-12b")
    tokens = _tokens(2, 128, seed=11)
    want = jax.jit(lambda p, b: ref_model.forward(cfg, p, b)[0])(
        params, {"tokens": jnp.asarray(tokens)})
    kw = dict(use_kernels=False, attn_impl="blockwise", attn_block_k=32,
              attn_block_q=32)
    logits, loss, _, grads = _port_loss_and_grads(
        _port_cfg("gemma3-12b", **kw), tree, tokens)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               atol=3e-4)
    _, naive_loss, _, naive = _port_loss_and_grads(
        _port_cfg("gemma3-12b", use_kernels=False), tree, tokens)
    np.testing.assert_allclose(float(loss.detach()),
                               float(naive_loss.detach()), atol=LOSS_TOL)
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), naive[key].numpy(),
                                   atol=GRAD_TOL, err_msg=key)


# --- remat -----------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma3-12b", "chatglm3-6b", "rwkv6-7b"])
@pytest.mark.parametrize("remat", ["block", "dots"])
def test_remat_gives_the_same_loss_and_grads(arch, remat):
    """Each layer's body under ``torch.utils.checkpoint`` ("block") or the
    selective policy that keeps the projection products ("dots") gives
    the loss of ``remat="none"`` bitwise and its grads within 1e-6; the
    kernels' plain path is on, so K1 and K4 are recomputed."""
    cfg = _port_cfg(arch)
    params = transformer.init_params(cfg, device="cpu")
    tokens = _tokens(2, 96, seed=12)
    out = {}
    for r in ("none", remat):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss, _ = transformer.loss_fn(cfg.replace(remat=r), leaves,
                                      {"tokens": torch.from_numpy(tokens)})
        out[r] = (loss, torch.autograd.grad(loss, list(leaves.values())))
    assert torch.equal(out[remat][0], out["none"][0])
    for g, w in zip(out[remat][1], out["none"][1]):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


class _CountOps(TorchDispatchMode):
    """Counts the aten ops that run under it, by name."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func)] = self.counts.get(str(func), 0) + 1
        return func(*args, **(kwargs or {}))


def test_remat_recomputes_what_it_does_not_save():
    """The products the backward runs (``aten.mm``): "block" recomputes
    each layer's projection products up to the last one its backward needs
    (q, k, v, o, gate and up: the output projection's result is needed by
    no gradient), "dots" keeps them all and recomputes none, as "none"."""
    cfg = _port_cfg("gemma3-12b")
    params = transformer.init_params(cfg, device="cpu")
    tokens = {"tokens": torch.from_numpy(_tokens(2, 96, seed=13))}
    mms = {}
    for r in ("none", "dots", "block"):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss, _ = transformer.loss_fn(cfg.replace(remat=r), leaves, tokens)
        with _CountOps() as ops:
            torch.autograd.grad(loss, list(leaves.values()))
        mms[r] = ops.counts["aten.mm.default"]
    assert mms["dots"] == mms["none"]
    assert mms["block"] == mms["none"] + 6 * cfg.num_layers


def test_unknown_remat_and_attn_impl_raise():
    with pytest.raises(ValueError, match="remat"):
        _port_cfg("gemma3-12b", remat="full")
    with pytest.raises(ValueError, match="attn_impl"):
        _port_cfg("gemma3-12b", attn_impl="ring")


# --- K1-K3's plain path at head dim 256 ----------------------------------


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def _jax_ref_grads(q, k, v, w, *, causal, window):
    def loss(q, k, v):
        out = jax_ref_attention(q, k, v, causal=causal, window=window)
        return jnp.sum(out * w)
    return jax.value_and_grad(loss, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("b,h,kh,s,causal,window", [
    (1, 4, 2, 130, True, 0), (1, 4, 2, 130, True, 48),
    (2, 2, 2, 65, False, 0), (1, 2, 1, 97, False, 20),
])
def test_flash_plain_path_at_head_dim_256(b, h, kh, s, causal, window):
    """``flash_attention_fwd`` and the K2/K3 wrappers on CPU tensors at D
    256 (their plain versions) against the reference's ``ref_attention``
    and ``jax.grad`` of it, fp32 within 1e-4."""
    d = 256
    rng = np.random.default_rng(14)
    q, w = (rng.normal(0, 1, (b, h, s, d)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.normal(0, 1, (b, kh, s, d)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv, tw = (torch.from_numpy(x) for x in (q, k, v, w))
    kw = {"causal": causal, "window": window}
    out, lse = fa.flash_attention_fwd(tq, tk, tv, **kw)
    val, grads = _jax_ref_grads(*(jnp.asarray(x) for x in (q, k, v, w)),
                                **kw)
    want = jax_ref_attention(*(jnp.asarray(x) for x in (q, k, v)), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-4)
    dq, delta = fa.flash_attention_bwd_dq(tq, tk, tv, out, lse, tw, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(tq, tk, tv, tw, lse, delta, **kw)
    for g, r in zip((dq, dk, dv), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)
    assert fa.flash_attention_fwd.launches == 0
    torch.testing.assert_close(
        delta, ref_attention_bwd(tq, tk, tv, out, lse, tw, **kw)[3])


def test_kernel_inputs_take_head_dim_256_only_beside_the_others():
    """D = Dv = 256 is taken beside 32, 64, 80 (HuBERT's and Zamba2's) and
    128; another width, or 256 against another Dv, raises."""
    ok = torch.zeros((1, 2, 8, 256))
    fa.check_kernel_inputs(ok, ok, ok)
    fa.check_kernel_inputs(*(t.bfloat16() for t in (ok, ok, ok)))
    assert fa.HEAD_DIMS == (32, 64, 80, 128, 256)
    for q, k, v in ((torch.zeros(1, 2, 8, 96),) * 3,
                    (ok, ok, torch.zeros(1, 2, 8, 128)),
                    (torch.zeros(1, 2, 8, 512),) * 3):
        with pytest.raises(ValueError, match="head dims"):
            fa.check_kernel_inputs(q, k, v)


@pytest.mark.parametrize("b,kh,t,group,n_sm,want_gs", [
    (1, 8, 4096, 2, 132, 1),     # gemma3: 64 key tiles x 8 x 2 halves
    (1, 8, 300, 2, 132, 2),      # 5 x 8 x 2 = 80 CTAs: split the pairs
    (2, 2, 197, 2, 132, 2),
])
def test_dkv_group_split_counts_the_column_halves(b, kh, t, group, n_sm,
                                                  want_gs):
    """At D 256 K3 gives each key tile's dK, dV columns to two CTAs (the
    kernel source's ``dkv_cols``), so the group split counts twice the CTAs
    of D 128."""
    src = (Path(fa.__file__).parent / "csrc" / "flash_bwd.cu").read_text()
    cols = re.search(r"constexpr int dkv_cols\(\) \{ return D == 256 \? "
                     r"(\d+) : D; \}", src)
    assert cols and 256 // int(cols.group(1)) == 2
    split = fa.dkv_group_split(b, kh, t, 256, group, n_sm, col_tiles=2,
                                dv=256)
    ctas = -(-t // fa.KEY_TILE) * kh * 2 * b
    assert split.gs == want_gs
    assert ctas * split.gs >= 2 * n_sm or split.gs == group
    assert split.scratch_shape == ((split.gs, 2, b, kh, t, 256)
                                   if split.gs > 1 else ())
    assert fa.dkv_group_split(b, kh, t, 256, group, n_sm, col_tiles=1,
                              dv=256).gs >= split.gs


# --- the CLI ----------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_on_the_cpu(arch, tmp_path, capsys):
    out = tmp_path / "metrics.json"
    hist = cli.main(["--arch", arch, "--smoke", "--steps", "2", "--seq",
                     "128", "--batch", "2", "--log-every", "1", "--device",
                     "cpu", "--metrics-out", str(out)])
    rows = json.loads(out.read_text())
    assert rows == hist and [r["step"] for r in rows] == [0, 1]
    for r in rows:
        assert r["step_ok"] == 1 and np.isfinite(r["loss"])
        assert np.isfinite(r["grad_norm"])
    printed = capsys.readouterr().out
    assert f"arch={arch}-smoke" in printed and "seq=128 vocab=512" in printed
