"""Port parity for Mamba2 and the Zamba2 hybrid (``zamba2-2.7b``): the
config, ``models/mamba2.py`` (the causal conv, the chunked SSD scan, its
carried state and the one-step decode), the block, the whole model's
logits, loss and gradients (the shared attention block's summed over its
uses), the plain Mamba2 stack, remat, prefill and decode from the Mamba2
and shared-block caches, and the training and serve CLIs.

The reference side is the JAX package's pure functions (``mamba2``'s,
``model.forward`` in every mode, ``model.loss_fn`` with
``jax.value_and_grad``), never ``DistributedEngine``. Its smoke params
cross with ``params_from_numpy``, the unit norm scales and Mamba2's
``A_log``, ``dt_bias``, ``D`` and inner norm perturbed by numpy noise on
both sides. Tolerances: the SSD scan 2e-4 (``tests/test_models_math.py``),
the block and the model's logits 1e-4, loss 1e-5, grads 2e-4 in fp32 (as
``tests/test_torch_dense.py``), decode against train-mode logits 5e-4
(``tests/test_arch_smoke.py``). The data-parallel gradients of the shared
block are held at worlds 1, 2 and 4 in ``tests/test_torch_dp.py``.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import mamba2 as ref_m2  # noqa: E402
from repro.models import transformer as ref_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models import mamba2, transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "zamba2-2.7b"
SSD_TOL, LOGITS_TOL, LOSS_TOL, GRAD_TOL, TRAIN_TOL = \
    2e-4, 1e-4, 1e-5, 2e-4, 5e-4
KEY = jax.random.PRNGKey(7)


def _flat(tree, prefix=""):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flat(leaf, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = leaf if isinstance(
                leaf, jax.ShapeDtypeStruct) else np.asarray(leaf)
    return out


def _nest(flat):
    out = {}
    for key, leaf in flat.items():
        *path, name = key.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[name] = jnp.asarray(leaf)
    return out


def _ref_cfg(**kw):
    return ref_configs.get_smoke_config(ARCH).replace(dtype="float32", **kw)


def _cfg(**kw):
    return configs.get_smoke_config(ARCH).replace(dtype="float32", **kw)


@functools.lru_cache(maxsize=None)
def _params(**kw):
    """Numpy flat params of the reference's fp32 init, the norm scales and
    the Mamba2 scalars perturbed."""
    cfg = _ref_cfg(**kw)
    params = jax.jit(lambda k: ref_model.init_params(cfg, k))(
        jax.random.PRNGKey(0))
    flat = {k: v.copy() for k, v in _flat(params).items()}
    rng = np.random.default_rng(7)
    for key, leaf in flat.items():
        if key.endswith(("scale", "A_log", "dt_bias", "mamba.D",
                         "mamba.norm", "conv_b")):
            leaf += rng.normal(0, 0.1, leaf.shape).astype(np.float32)
    return flat


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, _cfg().vocab_size, (b, s)).astype(np.int32)


def _ssd_inputs(b, s, h, p, n):
    """The reference's ``test_models_math`` draws."""
    ks = jax.random.split(KEY, 5)
    return (jax.random.normal(ks[0], (b, s, h, p)),
            jax.random.normal(ks[1], (b, s, n)),
            jax.random.normal(ks[2], (b, s, n)),
            jax.nn.softplus(jax.random.normal(ks[3], (b, s, h))),
            jax.random.normal(ks[4], (h,)) * 0.3)


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


# --- the config --------------------------------------------------------------


@pytest.mark.parametrize("factory", ["config", "smoke"])
def test_config_fields_match_reference(factory):
    port = getattr(configs.zamba2_2_7b, factory)()
    ref = getattr(ref_configs.REGISTRY[ARCH], factory)()
    for f in dataclasses.fields(port):
        if f.name not in ("use_kernels", "ssm"):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert dataclasses.asdict(port.ssm) == dataclasses.asdict(ref.ssm)
    assert configs.get_config(ARCH) == port or factory == "smoke"
    assert ARCH in configs.REGISTRY and ARCH not in configs.NOT_YET_PORTED
    for m in ("supports_decode", "supports_long_decode"):
        assert getattr(port, m)() is getattr(ref, m)() is True
    assert port.is_attention_free and port.hybrid_group > 0


def test_supports_long_decode_matches_reference_for_every_arch():
    """The hybrid term of ``supports_long_decode`` is back: every arch of
    the registry answers as the reference does."""
    for arch in ref_configs.ALL_ARCHS:
        assert configs.get_config(arch).supports_long_decode() == \
            ref_configs.get_config(arch).supports_long_decode(), arch


def test_config_refuses_what_the_reference_cannot_run():
    """A hybrid needs mamba2 blocks in whole groups and an SSMConfig; a
    mamba2 block needs an ssm or hybrid arch."""
    cfg = configs.get_config(ARCH)
    for change, match in (({"num_layers": 10}, "whole number of groups"),
                          ({"hybrid_group": 0}, "with block_kind"),
                          ({"block_kind": "attn"}, "with block_kind"),
                          ({"ssm": None}, "needs ssm"),
                          ({"arch_type": "dense", "hybrid_group": 0},
                           "with block_kind")):
        with pytest.raises(ValueError, match=match):
            cfg.replace(**change)
    plain = cfg.replace(arch_type="ssm", hybrid_group=0)
    assert plain.is_attention_free and plain.supports_decode()


def test_full_width_param_shapes_match_reference():
    """zamba2-2.7b at full width and depth, and the 12 layers the card
    trains: every param's key and shape equal the reference's
    ``jax.eval_shape`` (``stack.ln``, ``stack.mamba.*`` and the one
    unstacked ``shared_attn.*``)."""
    for layers in (54, 12):
        ref_cfg = ref_configs.get_config(ARCH).replace(num_layers=layers)
        want = jax.eval_shape(lambda k: ref_model.init_params(ref_cfg, k),
                              jax.ShapeDtypeStruct((2,), jnp.uint32))
        params = transformer.init_params(
            configs.get_config(ARCH).replace(num_layers=layers),
            device="meta")
        assert {k: tuple(v.shape) for k, v in params.items()} == \
            {k: tuple(v.shape) for k, v in _flat(want).items()}
        assert params["shared_attn.attn.wq"].shape == (2560, 32 * 80)
    n = sum(v.numel() for v in params.values())
    assert 0.7e9 < n < 0.8e9


# --- models/mamba2.py against the reference ----------------------------------


@pytest.mark.parametrize("s,chunk", [(64, 16), (100, 32), (32, 32)])
def test_ssd_chunk_scan_matches_reference(s, chunk):
    """``_ssd_chunk_scan`` at ``tests/test_models_math.py``'s cases (ragged
    S 100 in chunks of 32 included), from a zero and a random state: y and
    the end state within 2e-4 of the reference's."""
    xh, bmat, cmat, dt, a_log = _ssd_inputs(2, s, 3, 8, 4)
    for h0 in (jnp.zeros((2, 3, 8, 4)),
               jax.random.normal(jax.random.PRNGKey(1), (2, 3, 8, 4))):
        want_y, want_h = ref_m2._ssd_chunk_scan(xh, bmat, cmat, dt, a_log,
                                                chunk, h0)
        y, h_end = mamba2._ssd_chunk_scan(*_t(xh, bmat, cmat, dt, a_log),
                                          chunk, *_t(h0))
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                   atol=SSD_TOL)
        np.testing.assert_allclose(h_end.numpy(), np.asarray(want_h),
                                   atol=SSD_TOL)


def test_ssd_chunk_scan_carries_state():
    """Two calls, the second from the first's end state, equal one call
    (the reference's ``test_mamba2_chunked_carries_state``)."""
    xh, bmat, cmat, dt, a_log = (t[:1, :64] if t.ndim > 1 else t
                                 for t in _ssd_inputs(2, 64, 2, 8, 4))
    xh, bmat, cmat, dt, a_log = _t(xh, bmat, cmat, dt, a_log)
    h0 = torch.zeros((1, 2, 8, 4))
    y_full, h_full = mamba2._ssd_chunk_scan(xh, bmat, cmat, dt, a_log, 16,
                                            h0)
    y1, h_mid = mamba2._ssd_chunk_scan(xh[:, :32], bmat[:, :32],
                                       cmat[:, :32], dt[:, :32], a_log, 16,
                                       h0)
    y2, h_end = mamba2._ssd_chunk_scan(xh[:, 32:], bmat[:, 32:],
                                       cmat[:, 32:], dt[:, 32:], a_log, 16,
                                       h_mid)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=0,
                               atol=SSD_TOL)
    torch.testing.assert_close(h_end, h_full, rtol=0, atol=SSD_TOL)


def test_one_step_decode_matches_the_chunked_scan():
    """``ssd_step`` run token by token equals the chunked scan of the same
    sequence: every y and the end state within 2e-4."""
    xh, bmat, cmat, dt, a_log = _t(*_ssd_inputs(2, 40, 3, 8, 4))
    y, h_end = mamba2._ssd_chunk_scan(xh, bmat, cmat, dt, a_log, 16,
                                      torch.zeros((2, 3, 8, 4)))
    h = torch.zeros((2, 3, 8, 4))
    for t in range(40):
        yt, h = mamba2.ssd_step(xh[:, t], bmat[:, t], cmat[:, t], dt[:, t],
                                a_log, h)
        torch.testing.assert_close(yt, y[:, t], rtol=0, atol=SSD_TOL)
    torch.testing.assert_close(h, h_end, rtol=0, atol=SSD_TOL)


def test_strong_decay_gradients_stay_finite():
    """At chunk 128 with dt ~ 3 the masked pairs' exp(L_i - L_j) would
    overflow fp32; the scan's gradients stay finite and its values those
    of the sequential recurrence."""
    xh, bmat, cmat, _, a_log = _t(*_ssd_inputs(1, 128, 2, 4, 4))
    dt = torch.full((1, 128, 2), 3.0, requires_grad=True)
    y, h_end = mamba2._ssd_chunk_scan(xh, bmat, cmat, dt, a_log, 128,
                                      torch.zeros((1, 2, 4, 4)))
    grad, = torch.autograd.grad((y.sum() + h_end.sum()), dt)
    assert bool(torch.isfinite(grad).all())
    h = torch.zeros((1, 2, 4, 4))
    for t in range(128):
        yt, h = mamba2.ssd_step(xh[:, t], bmat[:, t], cmat[:, t],
                                dt[:, t].detach(), a_log, h)
        torch.testing.assert_close(yt, y[:, t].detach(), rtol=0,
                                   atol=SSD_TOL)


def test_causal_conv_matches_reference():
    """The depthwise causal conv with SiLU, from zeros and from a cached
    state (its new state too)."""
    rng = np.random.default_rng(2)
    xbc = rng.normal(0, 1, (2, 9, 12)).astype(np.float32)
    w = rng.normal(0, 0.3, (4, 12)).astype(np.float32)
    bias = rng.normal(0, 0.1, (12,)).astype(np.float32)
    state = rng.normal(0, 1, (2, 3, 12)).astype(np.float32)
    for st in (None, state):
        want, want_st = ref_m2._causal_conv(
            jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(bias),
            None if st is None else jnp.asarray(st))
        got, got_st = mamba2._causal_conv(
            *_t(xbc, w, bias), None if st is None else torch.from_numpy(st))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st),
                                   atol=0)


@pytest.mark.parametrize("s", [1, 45])
def test_mamba2_block_matches_reference(s):
    """One Mamba2 block of layer 1's params (fp32), without and with a
    cache (S 1 takes the one-step decode): the output within 1e-4 and the
    written cache within 1e-5 of the reference's returned one."""
    cfg, ref_cfg = _cfg(use_kernels=False), _ref_cfg()
    flat = _params()
    layer = {k[len("stack.mamba."):]: v[1] for k, v in flat.items()
             if k.startswith("stack.mamba.")}
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, s, cfg.d_model)).astype(np.float32)
    rc = jax.tree.map(lambda a: jnp.asarray(rng.normal(0, 0.5, a.shape),
                                            jnp.float32),
                      ref_m2.init_mamba2_cache(ref_cfg, 2))
    for cache in (None, rc):
        if cache is None and s == 1:
            continue
        want, want_c = ref_m2.mamba2_block(
            {k: jnp.asarray(v) for k, v in layer.items()}, jnp.asarray(x),
            ref_cfg, cache=cache)
        pc = None if cache is None else {
            k: torch.from_numpy(np.array(v)) for k, v in cache.items()}
        got = mamba2.mamba2_block(
            {k: torch.from_numpy(v) for k, v in layer.items()},
            torch.from_numpy(x), cfg, cache=pc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGITS_TOL)
        if pc is not None:
            for k in pc:
                np.testing.assert_allclose(pc[k].numpy(),
                                           np.asarray(want_c[k]), atol=1e-5)


# --- the whole model ---------------------------------------------------------


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("kw", [{}, {"arch_type": "ssm", "hybrid_group": 0}],
                         ids=["hybrid", "plain-mamba2"])
def test_logits_loss_and_grads_match_reference(kw, use_kernels):
    """The smoke hybrid (4 Mamba2 layers, the shared block after every 2)
    and the plain Mamba2 stack on 2 x 70 tokens (three SSD chunks of 32,
    the last ragged): logits 1e-4, loss 1e-5 and every gradient 2e-4
    against ``jax.value_and_grad(loss_fn)``; the shared block's gradient
    sums its two uses."""
    ref_cfg, cfg = _ref_cfg(**kw), _cfg(use_kernels=use_kernels, **kw)
    flat = _params(**kw)
    tokens = _tokens(2, 70)
    jb = {"tokens": jnp.asarray(tokens)}
    params = _nest(flat)
    want_logits, _, _ = ref_model.forward(ref_cfg, params, jb, mode="train")
    (want_loss, _), want_grads = jax.value_and_grad(
        lambda p: ref_model.loss_fn(ref_cfg, p, jb), has_aux=True)(params)
    p = {k: v.requires_grad_() for k, v in params_from_numpy(flat).items()}
    tb = {"tokens": torch.from_numpy(tokens)}
    logits, _ = transformer.forward(cfg, p, tb)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), atol=LOGITS_TOL)
    loss, _ = transformer.loss_fn(cfg, p, tb)
    np.testing.assert_allclose(loss.item(), float(want_loss),
                               atol=LOSS_TOL)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    want = _flat(want_grads)
    assert set(want) == set(grads)
    assert any(k.startswith("shared_attn.") for k in grads) == \
        bool(cfg.hybrid_group)
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[key], atol=GRAD_TOL,
                                   err_msg=key)


def test_shared_block_gradient_sums_its_uses():
    """With the shared block's params entering as two separate copies, one
    per group, their gradients sum to the shared one's."""
    cfg = _cfg(use_kernels=False)
    p = params_from_numpy(_params())
    tb = {"tokens": torch.from_numpy(_tokens(2, 33))}
    shared = [k for k in p if k.startswith("shared_attn.")]
    leaves = {k: p[k].clone().requires_grad_() for k in shared}
    whole = torch.autograd.grad(
        transformer.loss_fn(cfg, dict(p, **leaves), tb)[0],
        list(leaves.values()))
    uses = []
    block = transformer._block

    def spy(cfg_, layer, h, *a, **kw):
        if "attn.wq" in layer and layer["attn.wq"].ndim == 2:
            layer = {k: v.clone() for k, v in layer.items()}
            uses.append(layer)
        return block(cfg_, layer, h, *a, **kw)
    transformer._block = spy
    try:
        loss, _ = transformer.loss_fn(cfg, dict(p, **leaves), tb)
    finally:
        transformer._block = block
    assert len(uses) == cfg.num_layers // cfg.hybrid_group == 2
    per_use = torch.autograd.grad(
        loss, [u["attn.wq"] for u in uses] + [leaves["shared_attn.attn.wq"]])
    torch.testing.assert_close(per_use[0] + per_use[1], per_use[2])
    torch.testing.assert_close(per_use[2], whole[shared.index(
        "shared_attn.attn.wq")])


@pytest.mark.parametrize("remat", ["block", "dots"])
def test_remat_matches_no_remat(remat):
    """Each Mamba2 layer and each use of the shared block checkpointed:
    the loss and every gradient equal those without (1e-6)."""
    p = params_from_numpy(_params())
    tb = {"tokens": torch.from_numpy(_tokens(2, 40))}
    out = []
    for r in ("none", remat):
        view = {k: v.clone().requires_grad_() for k, v in p.items()}
        loss, _ = transformer.loss_fn(_cfg(remat=r), view, tb)
        out.append((loss, torch.autograd.grad(loss, list(view.values()))))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=1e-6)
    for a, b in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# --- serving -----------------------------------------------------------------


@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_and_decode_match_train_logits_and_reference(use_kernels):
    """A prompt of 70 tokens (across two SSD chunk boundaries) prefilled
    into the Mamba2 and shared-block caches, then four decode steps: each
    step's logits within 5e-4 of the train-mode logits of the whole
    sequence, and of the reference's ``forward(mode="prefill" |
    "decode")`` at the same params; the caches' shapes are the
    reference's."""
    ref_cfg, cfg = _ref_cfg(), _cfg(use_kernels=use_kernels)
    flat = _params()
    params, p = _nest(flat), params_from_numpy(flat)
    toks, s, n = _tokens(2, 74, seed=1), 70, 4
    want, _ = transformer.forward(cfg, p, {"tokens": torch.from_numpy(toks)},
                                  mode="eval")
    cache = transformer.init_cache(cfg, 2, s + n, dtype=torch.float32,
                                   device="cpu")
    rcache = ref_model.init_cache(ref_cfg, 2, s + n, dtype=jnp.float32)
    assert {g: {k: tuple(v.shape) for k, v in c.items()}
            for g, c in cache.items()} == \
        {g: {k: tuple(v.shape) for k, v in c.items()}
         for g, c in rcache.items()}
    got, cache, _ = transformer.forward(
        cfg, p, {"tokens": torch.from_numpy(toks[:, :s])}, mode="prefill",
        cache=cache)
    ref, rcache, _ = ref_model.forward(
        ref_cfg, params, {"tokens": jnp.asarray(toks[:, :s])},
        mode="prefill", cache=rcache)
    pairs = [(got, want[:, :s], ref)]
    for i in range(n):
        tok = toks[:, s + i:s + i + 1]
        got, cache, _ = transformer.forward(
            cfg, p, {"token": torch.from_numpy(tok), "index": s + i},
            mode="decode", cache=cache)
        ref, rcache, _ = ref_model.forward(
            ref_cfg, params, {"token": jnp.asarray(tok),
                              "index": jnp.int32(s + i)},
            mode="decode", cache=rcache)
        pairs.append((got[:, 0], want[:, s + i], ref[:, 0]))
    for got, train, ref in pairs:
        torch.testing.assert_close(got, train, rtol=0, atol=TRAIN_TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=TRAIN_TOL)
    for key, leaf in _flat(jax.tree.map(np.asarray, rcache)).items():
        g, k = key.split(".")
        np.testing.assert_allclose(cache[g][k].numpy(), leaf, atol=1e-5,
                                   rtol=1e-5, err_msg=key)


def test_bf16_cache_keeps_the_compute_dtype():
    """In bf16 the Mamba2 state is cast to the cache's dtype as the
    reference does, and the shared block's K/V cache in another dtype than
    the compute dtype raises."""
    cfg = _cfg().replace(dtype="bfloat16")
    p = params_from_numpy(_params())
    toks = torch.from_numpy(_tokens(2, 20))
    cache = transformer.init_cache(cfg, 2, 24, dtype=torch.bfloat16,
                                   device="cpu")
    logits, cache, _ = transformer.forward(cfg, p, {"tokens": toks},
                                           mode="prefill", cache=cache)
    assert logits.dtype == torch.bfloat16
    assert all(v.dtype == torch.bfloat16 and v.abs().sum() > 0
               for g in cache.values() for v in g.values())
    wrong = transformer.init_cache(cfg, 2, 24, dtype=torch.float32,
                                   device="cpu")
    with pytest.raises(ValueError, match="compute dtype"):
        transformer.forward(cfg, p, {"tokens": toks}, mode="prefill",
                            cache=wrong)


# --- the CLIs ----------------------------------------------------------------


def test_train_cli_on_the_cpu():
    """``--arch zamba2-2.7b --smoke`` trains on the token stream: finite
    losses and grad norms, ``step_ok`` 1; ``--layers`` cuts whole groups
    and refuses a ragged group."""
    rows = cli.main(["--arch", ARCH, "--smoke", "--steps", "3", "--seq",
                     "40", "--batch", "4", "--accum", "2", "--log-every",
                     "1", "--device", "cpu"])
    assert [r["step"] for r in rows] == [0, 1, 2]
    for r in rows:
        assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
        assert r["step_ok"] == 1
    with pytest.raises(ValueError, match="whole number of groups"):
        cli.main(["--arch", ARCH, "--smoke", "--layers", "3", "--steps",
                  "1", "--device", "cpu"])


def test_serve_cli_on_the_cpu(capsys):
    """The serve CLI prefills and decodes the smoke hybrid; the same
    command with the plain paths generates the same ids."""
    argv = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "40",
            "--gen", "5", "--device", "cpu"]
    res = serve.main(argv)
    out = capsys.readouterr().out
    assert f"[serve] arch={ARCH}-smoke batch=2 prefill(40 tok)=" in out
    assert res["tokens"].shape == (2, 5) and res["tokens"].dtype == np.int32
    again = serve.main(argv + ["--no-kernels"])
    assert np.array_equal(again["tokens"], res["tokens"])

