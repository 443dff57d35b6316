"""Port parity for the MoE decoder (``granite-moe-3b-a800m``): the config,
the router and its capacity arithmetic, the GShard and gather dispatch,
shared experts, leading dense layers, the whole model's logits, loss,
``moe_aux`` and gradients, remat and the training CLI.

The reference side is the JAX package's pure functions
(``repro.models.moe.*``, ``model.forward``, ``model.loss_fn`` with
``jax.value_and_grad``), never ``DistributedEngine``. Its smoke params
cross with ``params_from_numpy``, with the unit norm scales perturbed by
numpy noise on both sides so that every branch matters. Tolerances: the
whole model takes ``tests/test_torch_lm.py``'s (logits 1e-4, loss 1e-5,
grads 2e-4); gather against GShard takes ``tests/test_perf_options.py:
29-47``'s (logits 2e-5, aux rtol 1e-5, grads 5e-5); the MoE functions
alone take 1e-5 in fp32 and 2e-2 in bf16 (``tests/test_flash_grad.py``'s
bf16 gate). Data parallelism and the ZeRO-3 checkpoint of this model are
in ``tests/test_torch_dp.py``.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import dataclasses  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.configs.base import MoEConfig as RefMoEConfig  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "granite-moe-3b-a800m"
LOGITS_TOL, LOSS_TOL, GRAD_TOL = 1e-4, 1e-5, 2e-4
IMPL_LOGITS_TOL, IMPL_AUX_RTOL, IMPL_GRAD_TOL = 2e-5, 1e-5, 5e-5
FFN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
VOCAB, SEQ = 512, 32
# leading dense layer and a shared expert: builds dense_stack and moe_stack
VARIANT = {"first_dense_layers": 1, "num_shared_experts": 1}


def _flat(tree, prefix=""):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flat(leaf, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = leaf
    return out


def _moe_replace(cfg, **kw):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **kw)) if kw else cfg


@functools.lru_cache(maxsize=None)
def _smoke(impl="gshard", variant=False):
    """(reference cfg, reference params, numpy param tree), fp32, with the
    norm scales perturbed."""
    cfg = _moe_replace(ref_configs.get_smoke_config(ARCH).replace(
        dtype="float32", moe_impl=impl), **(VARIANT if variant else {}))
    params = jax.jit(lambda k: ref_model.init_params(cfg, k))(
        jax.random.PRNGKey(0))
    tree = jax.tree.map(np.array, params)
    rng = np.random.default_rng(7)
    for stack in ("dense_stack", "moe_stack"):
        for ln in ("ln1", "ln2"):
            if stack in tree:
                leaf = tree[stack][ln]["scale"]
                leaf += rng.normal(0, 0.1, leaf.shape).astype(np.float32)
    tree["final_norm"]["scale"] += rng.normal(
        0, 0.1, tree["final_norm"]["scale"].shape).astype(np.float32)
    return cfg, jax.tree.map(jnp.asarray, tree), tree


def _port_cfg(impl="gshard", variant=False, **kw):
    cfg = configs.get_smoke_config(ARCH).replace(
        **{"dtype": "float32", "moe_impl": impl, **kw})
    return _moe_replace(cfg, **(VARIANT if variant else {}))


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(
        0, VOCAB, (b, s)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(cfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: ref_model.loss_fn(cfg, p, b), has_aux=True))


def _port_run(cfg, params, tokens):
    """(logits, loss, metrics, {key: grad}) of the port on ``params``."""
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    tb = {"tokens": torch.from_numpy(tokens)}
    logits, aux = transformer.forward(cfg, leaves, tb)
    loss, metrics = transformer.loss_from_logits(cfg, logits, tb, aux)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return logits.detach(), loss.detach(), \
        {k: v.detach() for k, v in metrics.items()}, dict(zip(leaves, grads))


# --- configs --------------------------------------------------------------


def test_moe_config_defaults_match_reference():
    assert dataclasses.asdict(MoEConfig()) == \
        dataclasses.asdict(RefMoEConfig())
    assert MoEConfig().capacity_factor == 1.25
    assert MoEConfig().router_aux_coef == 0.001


@pytest.mark.parametrize("factory", ["config", "smoke"])
def test_config_fields_match_reference(factory):
    port = getattr(configs.REGISTRY[ARCH], factory)()
    ref = getattr(ref_configs.REGISTRY[ARCH], factory)()
    for f in dataclasses.fields(port):
        if f.name == "moe":
            assert dataclasses.asdict(port.moe) == dataclasses.asdict(ref.moe)
        elif f.name != "use_kernels":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert (configs.get_config if factory == "config"
            else configs.get_smoke_config)(ARCH) == port
    assert ARCH not in configs.NOT_YET_PORTED and port.has_moe


@pytest.mark.parametrize("variant", [False, True])
def test_full_width_param_shapes_match_reference(variant):
    """At full width and two layers every param's key and shape equal the
    reference's ``jax.eval_shape`` (with a leading dense layer and a
    shared expert: ``dense_stack`` beside ``moe_stack``)."""
    ref_cfg = _moe_replace(ref_configs.get_config(ARCH).replace(num_layers=2),
                           **(VARIANT if variant else {}))
    want = jax.eval_shape(lambda k: ref_model.init_params(ref_cfg, k),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    cfg = _moe_replace(configs.get_config(ARCH).replace(num_layers=2),
                       **(VARIANT if variant else {}))
    params = transformer.init_params(cfg, device="meta")
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in _flat(want).items()}
    assert "head.w" not in params
    assert ("dense_stack.mlp.w_gate" in params) == variant
    assert params["moe_stack.moe.experts.w_gate"].shape == (
        2 - variant, 40, 1536, 512)


def test_unported_and_unknown_options_raise():
    """DeepSeek-V3 loads now (``tests/test_torch_mla.py`` holds it), an
    ``mtp_depth`` of 1 builds one MTP head, an mla block without its
    MLAConfig and an unknown dispatch raise."""
    assert configs.get_config("deepseek-v3-671b").block_kind == "mla"
    with_mtp = configs.get_config(ARCH).replace(mtp_depth=1, num_layers=2)
    assert "mtp.proj" in transformer.init_params(with_mtp, device="meta")
    with pytest.raises(ValueError, match="an mla block needs mla"):
        configs.get_config(ARCH).replace(block_kind="mla")
    with pytest.raises(ValueError, match="moe_impl"):
        configs.get_config(ARCH).replace(moe_impl="sparse")


@pytest.mark.parametrize("tokens,cf,want", [
    (1024, 1.25, 256), (4 * 1024, 1.25, 1024), (32, 1.25, 20),
    (64, 1.25, 40), (7, 0.01, 1), (64, 8.0, 256)])
def test_capacity_is_the_reference_arithmetic(tokens, cf, want):
    """Granite at 1024 tokens a row (GShard) and over 4 x 1024 (gather),
    the smoke config at 32 and 64, the floor of one slot."""
    full = configs.get_config(ARCH) if tokens >= 1024 else _port_cfg()
    cfg = _moe_replace(full, capacity_factor=cf)
    m = cfg.moe
    assert moe.capacity(tokens, cfg) == want == max(1, int(math.ceil(
        tokens * m.top_k / m.num_experts * m.capacity_factor)))


# --- the router -----------------------------------------------------------


def _logits(kind, b=2, s=32, e=4, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "tied":          # three levels: every row has ties
        return rng.integers(0, 3, (b, s, e)).astype(np.float32)
    x = rng.normal(0, 1, (b, s, e)).astype(np.float32)
    if kind == "skewed":        # expert 0 overflows its capacity
        x[..., 0] += 2.0
    return x


@pytest.mark.parametrize("kind", ["random", "skewed", "tied"])
def test_top_k_routing_matches_reference(kind):
    """Dispatch equals the reference's bitwise at the default capacity (20
    slots for 32 tokens, top-2 of 4), drops included, and combine within
    the two softmaxes' fp32 rounding; ties go to the lower expert index
    as ``lax.top_k`` orders them."""
    x = _logits(kind)
    cap = moe.capacity(32, _port_cfg())
    want = ref_moe.top_k_routing(jnp.asarray(x), 2, cap)
    got = moe.top_k_routing(torch.from_numpy(x), 2, cap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)
    kept = got[0].sum((1, 3))                       # (B, E) tokens kept
    if kind == "skewed":
        assert (kept[:, 0] == cap).all() and got[0].sum() < 2 * 32 * 2


def test_top_k_keeps_the_lower_index_on_ties():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3]])
    _, idx = moe.top_k(probs, 2)
    assert idx.tolist() == [[0, 1], [1, 2]]
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(probs.numpy()),
                                              2)[1]))


@pytest.mark.parametrize("kind", ["random", "tied"])
def test_routing_gradient_flows_through_gates_and_ce_only(kind):
    """d/dlogits of ``Σ combine·W + aux``: the selected gates and ``ce``
    carry gradient, the one-hot counts none; equal to the reference's."""
    x = _logits(kind, seed=3)
    w = np.random.default_rng(4).normal(0, 1, (2, 32, 4, 20)).astype(
        np.float32)

    def ref_f(lg):
        _, comb, aux = ref_moe.top_k_routing(lg, 2, 20)
        return jnp.sum(comb * w) + aux
    want = jax.grad(ref_f)(jnp.asarray(x))
    lg = torch.from_numpy(x).requires_grad_()
    _, comb, aux = moe.top_k_routing(lg, 2, 20)
    (comb * torch.from_numpy(w)).sum().add(aux).backward()
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want), atol=1e-6)
    # the counts alone: aux's gradient is E·me·dce, none through me
    lg2 = torch.from_numpy(x).requires_grad_()
    _, _, aux = moe.top_k_routing(lg2, 2, 20)
    aux.backward()
    idx = moe.top_k(torch.softmax(lg2.detach(), -1), 2)[1]
    me = torch.nn.functional.one_hot(idx, 4).sum(-2).float().mean((0, 1)) / 2
    lg3 = torch.from_numpy(x).requires_grad_()
    (4 * (me * torch.softmax(lg3, -1).mean((0, 1))).sum()).backward()
    torch.testing.assert_close(lg2.grad, lg3.grad, atol=0, rtol=0)


# --- the MoE functions ----------------------------------------------------


def _ffn_inputs(shared, cf, dtype, seed=0):
    """(reference cfg, reference layer params, port cfg, port layer params,
    x) at the smoke widths, B 2, S 32."""
    ref_cfg = _moe_replace(ref_configs.get_smoke_config(ARCH).replace(
        dtype=dtype), num_shared_experts=shared, capacity_factor=cf)
    p = ref_moe.init_moe(jax.random.PRNGKey(seed), ref_cfg)
    cfg = _moe_replace(_port_cfg(dtype=dtype), num_shared_experts=shared,
                       capacity_factor=cf)
    x = np.random.default_rng(seed).normal(0, 1, (2, 32, 128)).astype(
        np.float32)
    return ref_cfg, p, cfg, params_from_numpy(jax.tree.map(np.array, p)), x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("impl", ["gshard", "gather"])
def test_moe_ffn_matches_reference(impl, cf, shared, dtype):
    """``moe_ffn`` and ``moe_ffn_gather`` against their reference
    counterparts: out and aux, with and without a shared expert, at the
    default capacity (tokens dropped; the gather path also loses slot C-1
    of an overflowing expert, caveat R4) and at a capacity of 8 (none
    dropped)."""
    ref_cfg, p, cfg, port, x = _ffn_inputs(shared, cf, dtype)
    jdt = jnp.dtype(dtype)
    ref_fn = ref_moe.moe_ffn_gather if impl == "gather" else ref_moe.moe_ffn
    fn = moe.moe_ffn_gather if impl == "gather" else moe.moe_ffn
    want, want_aux = ref_fn(p, jnp.asarray(x).astype(jdt), ref_cfg)
    got, got_aux = fn(port, torch.from_numpy(x).to(getattr(torch, dtype)),
                      cfg)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 32, 128)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=FFN_TOL[dtype], rtol=FFN_TOL[dtype])
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)
    assert got_aux.dtype == torch.float32


def test_gather_overflow_clears_the_last_slot():
    """Caveat R4: the reference's gather table writes dropped entries into
    slot C-1, and the last writer (a dropped one) wins there on the CPU,
    so an overflowing expert's kept token in slot C-1 is invalid too. Two
    experts, three slots, five entries to expert 0: valid[0] is [True,
    True, False], as the reference's scatter gives, and that token's
    output from expert 0 is zero in both."""
    ek = np.array([[0], [0], [0], [1], [0], [0]])
    slot_tok, valid, safe_pos, keep = moe.gather_slots(
        torch.from_numpy(ek), 2, 3)
    assert valid.tolist() == [[True, True, False], [True, False, False]]
    assert slot_tok[0].tolist()[:2] == [0, 1] and keep.tolist() == [
        True, True, True, True, False, False]
    # the reference's own scatter (moe.py:148-151)
    flat = jnp.asarray(ek[:, 0])
    oh = jax.nn.one_hot(flat, 2, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(oh, 0) - oh, flat[:, None], 1)[:, 0]
    ref_keep = pos < 3
    ref_valid = jnp.zeros((2, 3), bool).at[
        flat, jnp.where(ref_keep, pos, 2)].set(ref_keep, mode="drop")
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(safe_pos.numpy(),
                                  np.asarray(jnp.where(ref_keep, pos, 2)))
    # the whole function: token 2 (slot C-1 of expert 0) gets nothing
    # from expert 0 at capacity 3 of 6 entries (top-1 of two experts)
    ref_cfg, p, cfg, port, _ = _ffn_inputs(0, 1.0, "float32")
    ref_cfg = _moe_replace(ref_cfg, num_experts=2, top_k=1)
    cfg = _moe_replace(cfg, num_experts=2, top_k=1)
    p = dict(p, router=jnp.zeros((128, 2)).at[0, 0].set(1.0).at[0, 1].set(
        -1.0), experts={k: v[:2] for k, v in p["experts"].items()})
    port = params_from_numpy(jax.tree.map(np.array, p))
    x = np.random.default_rng(1).normal(0, 1, (1, 6, 128)).astype(np.float32)
    x[0, :, 0] = [3, 2, 1, -1, 4, 5]       # entries to experts 0,0,0,1,0,0
    assert moe.capacity(6, cfg) == 3
    want, _ = ref_moe.moe_ffn_gather(p, jnp.asarray(x), ref_cfg)
    got, _ = moe.moe_ffn_gather(port, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert float(np.abs(np.asarray(want)[0, 2]).max()) == 0.0
    assert float(np.abs(np.asarray(want)[0, 1]).max()) > 0.0


# --- the whole model against the reference --------------------------------


@pytest.mark.parametrize("variant", [False, True])
@pytest.mark.parametrize("impl", ["gshard", "gather"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_logits_loss_and_grads_match_jax(use_kernels, impl, variant):
    """fp32 logits, loss, ``moe_aux`` and every gradient of granite smoke
    against the reference's ``forward`` and ``jax.value_and_grad(loss_fn)``
    at the default capacity, through GShard and the gather dispatch; the
    variant has a leading dense layer and a shared expert."""
    cfg, params, tree = _smoke(impl, variant)
    tokens = _tokens(2, SEQ, seed=1)
    jb = {"tokens": jnp.asarray(tokens)}
    want_logits = jax.jit(lambda p, b: ref_model.forward(cfg, p, b)[0])(
        params, jb)
    (loss, metrics), grads = _ref_value_and_grad(cfg)(params, jb)
    pcfg = _port_cfg(impl, variant, use_kernels=use_kernels)
    logits, got_loss, got_m, got = _port_run(pcfg, params_from_numpy(tree),
                                             tokens)
    assert logits.shape == (2, SEQ, VOCAB)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=LOGITS_TOL)
    assert set(got_m) == set(metrics) == {"loss", "moe_aux"}
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert float(metrics["moe_aux"]) > 0
    np.testing.assert_allclose(float(got_m["moe_aux"]),
                               float(metrics["moe_aux"]), rtol=1e-5)
    want = {k: np.asarray(v) for k, v in _flat(grads).items()}
    assert set(want) == set(got)
    for key, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[key], atol=GRAD_TOL,
                                   err_msg=key)
    assert got["moe_stack.moe.router"].abs().max() > 0


# --- within the port ------------------------------------------------------


@pytest.mark.parametrize("variant", [False, True])
def test_gather_equals_gshard_at_ample_capacity(variant):
    """At a capacity factor of 8 nothing is dropped, so the two dispatches
    compute the same function: logits within 2e-5, aux rtol 1e-5, grads
    5e-5 (``tests/test_perf_options.py``'s gates)."""
    params = transformer.init_params(_port_cfg(variant=variant), seed=3,
                                     device="cpu")
    tokens = _tokens(2, SEQ, seed=5)
    out = {impl: _port_run(_moe_replace(_port_cfg(impl, variant),
                                        capacity_factor=8.0),
                           params, tokens)
           for impl in ("gshard", "gather")}
    (la, _, ma, ga), (lb, _, mb, gb) = out["gshard"], out["gather"]
    torch.testing.assert_close(lb, la, atol=IMPL_LOGITS_TOL, rtol=0)
    np.testing.assert_allclose(float(mb["moe_aux"]), float(ma["moe_aux"]),
                               rtol=IMPL_AUX_RTOL)
    for k in ga:
        torch.testing.assert_close(gb[k], ga[k], atol=IMPL_GRAD_TOL, rtol=0,
                                   msg=k)


@pytest.mark.parametrize("remat", ["block", "dots"])
@pytest.mark.parametrize("impl", ["gshard", "gather"])
def test_remat_carries_the_aux(impl, remat):
    """The checkpointed layer body returns ``(h, aux)``: the loss and
    ``moe_aux`` of ``remat="none"`` bitwise, grads within 1e-6."""
    cfg = _port_cfg(impl, True)
    params = transformer.init_params(cfg, device="cpu")
    tokens = _tokens(2, SEQ, seed=12)
    out = {r: _port_run(cfg.replace(remat=r), params, tokens)
           for r in ("none", remat)}
    assert torch.equal(out[remat][1], out["none"][1])
    assert torch.equal(out[remat][2]["moe_aux"], out["none"][2]["moe_aux"])
    assert float(out["none"][2]["moe_aux"]) > 0
    for k, w in out["none"][3].items():
        torch.testing.assert_close(out[remat][3][k], w, atol=1e-6, rtol=1e-6)


def test_dots_recomputes_the_expert_products():
    """``remat="dots"`` saves ``aten.mm`` (the router, the projections)
    and recomputes the experts' batched products (``aten.bmm``), as
    ``dots_with_no_batch_dims_saveable`` does; "none" recomputes
    nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.counts[str(func)] = self.counts.get(str(func), 0) + 1
            return func(*args, **(kwargs or {}))

    cfg = _port_cfg("gather")
    params = transformer.init_params(cfg, device="cpu")
    tb = {"tokens": torch.from_numpy(_tokens(2, SEQ, seed=13))}
    counts = {}
    for r in ("none", "dots"):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss, _ = transformer.loss_fn(cfg.replace(remat=r), leaves, tb)
        with Count() as ops:
            torch.autograd.grad(loss, list(leaves.values()))
        counts[r] = ops.counts
    mm = "aten.mm.default"
    bmm = "aten.bmm.default"
    assert counts["dots"][mm] == counts["none"][mm]
    # once more per layer: the experts' gate, up and out, and the
    # attention's two batched products (scores and P·V)
    assert counts["dots"][bmm] == counts["none"][bmm] + 5 * cfg.num_layers


def test_moe_aux_is_zero_without_experts():
    cfg = configs.get_smoke_config("chatglm3-6b").replace(dtype="float32")
    params = transformer.init_params(cfg, device="cpu")
    _, aux = transformer.forward(cfg, params, {
        "tokens": torch.from_numpy(_tokens(1, 8, seed=0))})
    assert float(aux["moe_aux"]) == 0.0


# --- the CLI --------------------------------------------------------------


@pytest.mark.parametrize("impl", ["gshard", "gather"])
def test_cli_trains_on_the_cpu(impl, tmp_path, capsys, monkeypatch):
    """``--arch granite-moe-3b-a800m --smoke`` trains; its rows carry a
    finite, non-zero ``moe_aux`` (the config's ``moe_impl`` picks the
    dispatch: there is no flag, as in the reference)."""
    if impl == "gather":
        smoke = configs.get_smoke_config
        monkeypatch.setattr(cli, "get_smoke_config", lambda a: smoke(
            a).replace(moe_impl="gather"))
    out = tmp_path / "metrics.json"
    hist = cli.main(["--arch", ARCH, "--smoke", "--steps", "2", "--seq",
                     "32", "--batch", "4", "--accum", "2", "--log-every",
                     "1", "--device", "cpu", "--metrics-out", str(out)])
    rows = json.loads(out.read_text())
    assert rows == hist and [r["step"] for r in rows] == [0, 1]
    for r in rows:
        assert r["step_ok"] == 1 and np.isfinite(r["loss"])
        assert np.isfinite(r["moe_aux"]) and r["moe_aux"] > 0
    printed = capsys.readouterr().out
    assert f"arch={ARCH}-smoke" in printed and "seq=32 vocab=512" in printed
