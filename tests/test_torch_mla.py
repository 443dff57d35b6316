"""Port parity for DeepSeek-V3 (``deepseek-v3-671b``): its config, multi-head
latent attention (MLA), the multi-token prediction (MTP) head, the flash
wrappers at a value head dim other than the query's, and the training CLI.

The reference side is the JAX package's pure functions
(``repro.models.attention.mla_block``, ``rope.apply_rope_1d``,
``kernels.ref.ref_attention``, ``model.forward``, ``model.loss_fn`` with
``jax.value_and_grad``), never ``DistributedEngine``, and never its Pallas
kernels (caveat R1: the reference runs with ``use_pallas=False``). Its
smoke params cross with ``params_from_numpy``, with the unit norm scales
(the layers', the final norm's, MLA's ``q_norm`` and ``kv_norm`` and the
MTP head's three) perturbed by numpy noise on both sides so that every
branch matters. Tolerances are ``tests/test_torch_lm.py``'s for the whole
model (logits 1e-4, loss 1e-5, grads 2e-4); ``mla_block`` alone takes
1e-5 in fp32 and 2e-2 in bf16, the rope 1e-6, the flash wrappers' plain
path 1e-5. The CUDA kernels at (D 192, Dv 128) are checked on the card by
``chip_smoke.py``; data parallelism of this model is in
``tests/test_torch_dp.py``.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import dataclasses  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.configs.base import MLAConfig as RefMLAConfig  # noqa: E402
from repro.kernels.ref import ref_attention as jax_ref_attention  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import rope as ref_rope  # noqa: E402
from repro.models import transformer as ref_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import MLAConfig  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels.ops import flash_mha  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models import attention, rope, transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "deepseek-v3-671b"
LOGITS_TOL, LOSS_TOL, GRAD_TOL = 1e-4, 1e-5, 2e-4
BLOCK_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
VOCAB, SEQ = 512, 32
# phase 14's cut of the full config: one layer, which is MoE, 16 experts
CUT = {"num_layers": 1, "first_dense_layers": 0, "num_experts": 16}


def _flat(tree, prefix=""):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flat(leaf, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = leaf
    return out


def _cut(cfg, cut):
    if not cut:
        return cfg
    return cfg.replace(num_layers=CUT["num_layers"], moe=dataclasses.replace(
        cfg.moe, first_dense_layers=CUT["first_dense_layers"],
        num_experts=CUT["num_experts"]))


def _perturb(tree, rng):
    """Unit norm scales plus numpy noise, in place: every scale leaf of
    the numpy tree (``scale``, ``q_norm``, ``kv_norm``)."""
    for key, leaf in _flat(tree).items():
        if key.endswith(("scale", "q_norm", "kv_norm")):
            leaf += rng.normal(0, 0.1, leaf.shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _smoke(impl="gshard"):
    """(reference cfg, reference params, numpy param tree), fp32, with the
    norm scales perturbed."""
    cfg = ref_configs.get_smoke_config(ARCH).replace(dtype="float32",
                                                     moe_impl=impl)
    params = jax.jit(lambda k: ref_model.init_params(cfg, k))(
        jax.random.PRNGKey(0))
    tree = jax.tree.map(np.array, params)
    _perturb(tree, np.random.default_rng(7))
    return cfg, jax.tree.map(jnp.asarray, tree), tree


def _port_cfg(impl="gshard", **kw):
    return configs.get_smoke_config(ARCH).replace(
        **{"dtype": "float32", "moe_impl": impl, **kw})


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(
        0, VOCAB, (b, s)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(cfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: ref_model.loss_fn(cfg, p, b), has_aux=True))


def _port_run(cfg, params, tokens, drop_mtp=False):
    """(logits, loss, metrics, {key: grad}) of the port on ``params``;
    ``drop_mtp`` leaves the MTP head's term out of the loss."""
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    tb = {"tokens": torch.from_numpy(tokens)}
    logits, aux = transformer.forward(cfg, leaves, tb)
    if drop_mtp:
        aux = {"moe_aux": aux["moe_aux"]}
    loss, metrics = transformer.loss_from_logits(cfg, logits, tb, aux)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=drop_mtp)
    return logits.detach(), loss.detach(), \
        {k: v.detach() for k, v in metrics.items()}, dict(zip(leaves, grads))


# --- configs --------------------------------------------------------------


def test_mla_config_defaults_match_reference():
    assert dataclasses.asdict(MLAConfig()) == \
        dataclasses.asdict(RefMLAConfig())
    assert MLAConfig().qk_nope_head_dim + MLAConfig().qk_rope_head_dim == 192


@pytest.mark.parametrize("factory", ["config", "smoke"])
def test_config_fields_match_reference(factory):
    port = getattr(configs.REGISTRY[ARCH], factory)()
    ref = getattr(ref_configs.REGISTRY[ARCH], factory)()
    for f in dataclasses.fields(port):
        if f.name in ("mla", "moe"):
            assert dataclasses.asdict(getattr(port, f.name)) == \
                dataclasses.asdict(getattr(ref, f.name)), f.name
        elif f.name != "use_kernels":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert (configs.get_config if factory == "config"
            else configs.get_smoke_config)(ARCH) == port
    assert ARCH not in configs.NOT_YET_PORTED and port.has_moe
    assert port.block_kind == "mla" and port.mtp_depth == 1


def test_config_refusals():
    """An mla block needs its MLAConfig; an MoE config needs at least its
    leading dense layers (the reference fails inside jax.random.split
    there); MTP stays unported on RWKV6 and the ViT."""
    cfg = configs.get_config(ARCH)
    with pytest.raises(ValueError, match="an mla block needs mla"):
        cfg.replace(mla=None)
    with pytest.raises(ValueError, match="first_dense_layers"):
        cfg.replace(num_layers=2)
    cfg.replace(num_layers=3)
    with pytest.raises(NotImplementedError, match="mtp_depth"):
        configs.get_config("rwkv6-7b").replace(mtp_depth=1)
    with pytest.raises(NotImplementedError, match="mtp_depth"):
        configs.get_config("vit-b16").replace(mtp_depth=1)
    with pytest.raises(NotImplementedError, match="mla block in a ViT"):
        configs.get_config("vit-b16").replace(block_kind="mla",
                                              mla=MLAConfig())


@pytest.mark.parametrize("cut", [False, True])
def test_full_width_param_shapes_match_reference(cut):
    """Every param's key and shape at full width equal the reference's
    ``jax.eval_shape(init_params)``: the whole 61-layer config (on the
    ``meta`` device) and phase 14's cut (one MoE layer of 16 experts);
    the MTP head's leaves are unstacked and its block is dense."""
    ref_cfg = _cut(ref_configs.get_config(ARCH), cut)
    want = jax.eval_shape(lambda k: ref_model.init_params(ref_cfg, k),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    cfg = _cut(configs.get_config(ARCH), cut)
    params = transformer.init_params(cfg, device="meta")
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in _flat(want).items()}
    assert params["mtp.proj"].shape == (2 * 7168, 7168)
    assert params["mtp.block.mlp.w_gate"].shape == (7168, 18432)
    assert params["moe_stack.attn.w_uq"].shape[-1] == 128 * 192
    n = sum(p.numel() for p in params.values())
    if cut:
        assert "dense_stack.attn.wo" not in params
        assert round(n / 1e9, 3) == 3.476
    else:
        assert params["dense_stack.attn.kv_norm"].shape == (3, 512)
        assert params["moe_stack.moe.experts.w_up"].shape == (
            58, 256, 7168, 2048)


# --- the pieces of MLA ----------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_1d_matches_reference(dtype):
    x = np.random.default_rng(0).normal(0, 1, (2, 48, 1, 64)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(48)[None], (2, 48)).astype(np.int32)
    jx = jnp.asarray(x).astype(dtype)
    want = ref_rope.apply_rope_1d(jx, jnp.asarray(pos), theta=10000.0)
    got = rope.apply_rope_1d(torch.from_numpy(x).to(getattr(torch, dtype)),
                             torch.from_numpy(pos), theta=10000.0)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 48, 1, 64)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1e-6 if dtype == "float32" else 1e-2)


def _mla_inputs(seed, dtype):
    ref_cfg = ref_configs.get_smoke_config(ARCH).replace(
        dtype=dtype, attn_block_k=8, attn_block_q=16)
    p = jax.tree.map(np.array, ref_attn.init_mla(jax.random.PRNGKey(seed),
                                                 ref_cfg))
    _perturb(p, np.random.default_rng(seed))
    x = np.random.default_rng(seed + 1).normal(
        0, 1, (2, SEQ, ref_cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(SEQ)[None], (2, SEQ)).astype(np.int32)
    return ref_cfg, p, x, pos


@pytest.mark.parametrize("route", ["kernels", "blockwise", "naive"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_block_matches_reference(dtype, route):
    """``mla_block`` on each route (the kernel route on the CPU is the
    plain ``ref_attention``) against the reference's train/prefill branch
    (its blockwise route for the blockwise one, else its naive ``sdpa``):
    q at 48 wide (32 nope + 16 rope), v at 32, so the scale is 48**-0.5."""
    ref_cfg, p, x, pos = _mla_inputs(3, dtype)
    jdt = getattr(jnp, dtype)
    rcfg = ref_cfg.replace(attn_impl="blockwise" if route == "blockwise"
                           else "naive")
    want, cache = ref_attn.mla_block(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x).astype(jdt), rcfg,
                                     positions=jnp.asarray(pos))
    assert cache is None
    cfg = configs.get_smoke_config(ARCH).replace(
        dtype=dtype, use_kernels=route == "kernels",
        attn_impl="blockwise" if route == "blockwise" else "naive",
        attn_block_k=8, attn_block_q=16)
    tdt = getattr(torch, dtype)
    got = attention.mla_block(params_from_numpy(p),
                              torch.from_numpy(x).to(tdt), cfg,
                              positions=torch.from_numpy(pos).long())
    assert got.dtype == tdt and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=BLOCK_TOL[dtype], rtol=BLOCK_TOL[dtype])


def test_mla_block_refuses_a_cache():
    """A latent cache in another dtype than the compute dtype is refused
    (K1 takes no mixed dtypes, and a cast would hide the mismatch), as is
    a prompt longer than the cache; a cache in the compute dtype takes
    the prompt's latent and rope key at rows 0..S-1 (the serving path is
    held in ``tests/test_torch_serve.py``)."""
    _, p, x, pos = _mla_inputs(0, "float32")
    cfg = configs.get_smoke_config(ARCH).replace(dtype="float32")
    m = cfg.mla

    def cache(rows, dtype):
        return {"c_kv": torch.zeros((2, rows, m.kv_lora_rank), dtype=dtype),
                "k_rope": torch.zeros((2, rows, m.qk_rope_head_dim),
                                      dtype=dtype)}
    kw = {"positions": torch.from_numpy(pos).long()}
    with pytest.raises(ValueError, match="compute dtype"):
        attention.mla_block(params_from_numpy(p), torch.from_numpy(x), cfg,
                            cache=cache(SEQ + 4, torch.bfloat16), **kw)
    with pytest.raises(ValueError, match="overflows"):
        attention.mla_block(params_from_numpy(p), torch.from_numpy(x), cfg,
                            cache=cache(SEQ - 1, torch.float32), **kw)
    c = cache(SEQ + 4, torch.float32)
    attention.mla_block(params_from_numpy(p), torch.from_numpy(x), cfg,
                        cache=c, **kw)
    assert c["c_kv"][:, :SEQ].abs().sum() > 0
    assert c["c_kv"][:, SEQ:].abs().sum() == 0


def test_kv_norm_reads_the_latent_rows_in_place():
    """``kv_norm`` normalises the first 512 columns of ``w_dkv``'s 576-wide
    rows: the K4/K5 wrappers take them at that row stride, no copy."""
    dkv = torch.zeros((2, 1024, 576), dtype=torch.bfloat16)
    before = rms.row_layout.copies
    x2 = rms.row_layout(dkv[..., :512])
    assert x2.shape == (2048, 512) and x2.stride() == (576, 1)
    assert x2.data_ptr() == dkv.data_ptr()
    assert rms.row_layout.copies == before


# --- the flash wrappers at Dv != D ----------------------------------------


@functools.partial(jax.jit, static_argnames=("causal",))
def _jax_ref_vjp(q, k, v, w, *, causal):
    out, vjp = jax.vjp(lambda q, k, v: jax_ref_attention(
        q, k, v, causal=causal), q, k, v)
    return out, vjp(w)


@pytest.mark.parametrize("s,causal", [(32, True), (37, True), (29, False)])
def test_flash_mha_at_dv_below_d_matches_reference(s, causal):
    """``ops.flash_mha`` at D 48 / Dv 32 (the smoke MLA's pair) on CPU
    tensors in the model's (B,S,H,D) layout, forward and gradients,
    against ``jax.vjp`` of the reference's ``ref_attention``, fp32 within
    1e-5; ragged S included. The output is (B,S,H,Dv)."""
    rng = np.random.default_rng(s)
    b, h = 2, 4
    q, k = (rng.normal(0, 1, (b, h, s, 48)).astype(np.float32)
            for _ in range(2))
    v, w = (rng.normal(0, 1, (b, h, s, 32)).astype(np.float32)
            for _ in range(2))
    out, grads = _jax_ref_vjp(*(jnp.asarray(x) for x in (q, k, v, w)),
                              causal=causal)
    leaves = [torch.from_numpy(x).transpose(1, 2).contiguous()
              .requires_grad_() for x in (q, k, v)]
    got = flash_mha(*leaves, causal=causal)
    assert got.shape == (b, s, h, 32)
    np.testing.assert_allclose(got.detach().transpose(1, 2).numpy(),
                               np.asarray(out), atol=1e-5)
    got_grads = torch.autograd.grad(
        got, leaves, grad_outputs=torch.from_numpy(w).transpose(1, 2))
    for g, r in zip(got_grads, grads):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), np.asarray(r),
                                   atol=1e-5)
    assert fa.flash_attention_fwd.launches == 0


def test_kernel_inputs_take_the_mla_pair_only():
    """The wrapper admits (D, Dv) = (192, 128) and the smoke pair (48, 32)
    beside D = Dv; (192, 64), (48, 48) and the others raise. The CUDA
    sources' dispatch table lists the same pairs."""
    for d, dv in ((192, 128), (48, 32)):
        q = torch.zeros((1, 2, 8, d))
        fa.check_kernel_inputs(q, q, torch.zeros((1, 2, 8, dv)))
        fa.check_kernel_inputs(*(t.bfloat16() for t in (
            q, q, torch.zeros((1, 2, 8, dv)))))
    for d, dv in ((192, 64), (48, 48), (128, 192), (192, 192)):
        with pytest.raises(ValueError, match="head dims"):
            fa.check_kernel_inputs(torch.zeros((1, 2, 8, d)),
                                   torch.zeros((1, 2, 8, d)),
                                   torch.zeros((1, 2, 8, dv)))
    header = (Path(fa.__file__).parent / "csrc" /
              "flash_common.cuh").read_text()
    table = re.search(r"#define FLASH_HEAD_DIM_PAIRS\(X\)((?:.*\\\n)*.*)",
                      header).group(1)
    pairs = tuple((int(a), int(b)) for a, b in
                  re.findall(r"X\((\d+), (\d+)\)", table))
    assert pairs == fa.HEAD_DIM_PAIRS


def test_dkv_group_split_holds_both_widths():
    """K3's group-split partials keep rows of max(D, Dv): dK's 192 columns
    and dV's 128 at the start of theirs; D = Dv is as before."""
    split = fa.dkv_group_split(2, 2, 300, 192, 4, 132, col_tiles=1, dv=128)
    assert split.gs == 4
    assert split.scratch_shape == (4, 2, 2, 2, 300, 192)
    scratch = torch.empty(split.scratch_shape)
    assert scratch[:, 0].numel() == 4 * 2 * 2 * 300 * 192
    assert scratch[:, 1, ..., :128].shape[-1] == 128
    assert fa.dkv_group_split(2, 2, 300, 128, 4, 132, col_tiles=1,
                              dv=128).scratch_shape == (4, 2, 2, 2, 300, 128)


def test_kernel_output_keeps_the_query_layout():
    """K1's output buffer for a (B,S,H,D) view seen as (B,H,S,D) is a
    (B,S,H,Dv) buffer seen the same way, so ``flash_mha`` hands the model
    a contiguous result without a copy."""
    q = torch.zeros((2, 5, 3, 192)).transpose(1, 2)
    out = fa.empty_in_layout(q, 128)
    assert out.shape == (2, 3, 5, 128)
    assert out.transpose(1, 2).is_contiguous()
    assert fa.empty_in_layout(q, 192).stride() == q.stride()
    flat = torch.zeros((2, 3, 5, 192))
    assert fa.empty_in_layout(flat, 128).is_contiguous()


# --- the whole model against the reference --------------------------------


@pytest.mark.parametrize("impl", ["gshard", "gather"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_logits_loss_and_grads_match_jax(use_kernels, impl):
    """fp32 logits, loss (with its 0.3-weighted MTP term), ``moe_aux`` and
    every gradient, the ``mtp.*`` leaves included, of the DeepSeek smoke
    model (one dense and one MoE layer with a shared expert, MLA, the MTP
    head) against the reference's ``forward`` and
    ``jax.value_and_grad(loss_fn)``, through GShard and the gather
    dispatch."""
    cfg, params, tree = _smoke(impl)
    tokens = _tokens(2, SEQ, seed=1)
    jb = {"tokens": jnp.asarray(tokens)}
    want_logits, _, want_aux = jax.jit(
        lambda p, b: ref_model.forward(cfg, p, b))(params, jb)
    (loss, metrics), grads = _ref_value_and_grad(cfg)(params, jb)
    pcfg = _port_cfg(impl, use_kernels=use_kernels)
    port = params_from_numpy(tree)
    logits, got_loss, got_m, got = _port_run(pcfg, port, tokens)
    assert logits.shape == (2, SEQ, VOCAB)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=LOGITS_TOL)
    with torch.no_grad():
        _, aux = transformer.forward(pcfg, port,
                                     {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(aux["mtp_logits"].numpy(),
                               np.asarray(want_aux["mtp_logits"]),
                               atol=LOGITS_TOL)
    assert set(got_m) == set(metrics) == {"loss", "moe_aux"}
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(float(got_m["moe_aux"]),
                               float(metrics["moe_aux"]), rtol=1e-5)
    want = {k: np.asarray(v) for k, v in _flat(grads).items()}
    assert set(want) == set(got)
    for key, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[key], atol=GRAD_TOL,
                                   err_msg=key)
    for key in ("mtp.proj", "mtp.block.attn.kv_norm", "mtp.norm_e.scale",
                "moe_stack.attn.w_dkv", "dense_stack.attn.q_norm"):
        assert got[key].abs().max() > 0, key


def test_loss_without_the_mtp_term_misses_the_reference():
    """A mutation check: the loss with the MTP head's term left out misses
    the reference's by far more than the loss tolerance, and the MTP
    leaves then get no gradient."""
    cfg, params, tree = _smoke()
    tokens = _tokens(2, SEQ, seed=1)
    (loss, _), _ = _ref_value_and_grad(cfg)(params,
                                            {"tokens": jnp.asarray(tokens)})
    port = params_from_numpy(tree)
    _, whole, _, _ = _port_run(_port_cfg(), port, tokens)
    _, dropped, _, grads = _port_run(_port_cfg(), port, tokens,
                                     drop_mtp=True)
    assert abs(float(whole) - float(loss)) <= LOSS_TOL * (1 + abs(float(loss)))
    assert abs(float(dropped) - float(loss)) > 1.0
    assert grads["mtp.proj"] is None


def test_mtp_logits_only_in_training():
    """The MTP head runs in the training forward only, as the reference's
    ``mode == "train"``: eval logits are the LM head's alone."""
    cfg = _port_cfg()
    params = transformer.init_params(cfg, device="cpu")
    tb = {"tokens": torch.from_numpy(_tokens(1, 8, seed=0))}
    with torch.no_grad():
        logits, aux = transformer.forward(cfg, params, tb)
        eval_logits, eval_aux = transformer.forward(cfg, params, tb,
                                                    mode="eval")
        model_logits = transformer.Transformer(cfg, params)(tb)
    assert aux["mtp_logits"].shape == logits.shape
    assert "mtp_logits" not in eval_aux
    assert torch.equal(eval_logits, logits) and torch.equal(model_logits,
                                                            logits)


@pytest.mark.parametrize("remat", ["block", "dots"])
def test_remat_equals_none(remat):
    """Checkpointed layers give the loss and every gradient of
    ``remat="none"`` within 1e-5."""
    cfg = _port_cfg()
    params = transformer.init_params(cfg, seed=2, device="cpu")
    tokens = _tokens(2, SEQ, seed=12)
    out = {r: _port_run(cfg.replace(remat=r), params, tokens)
           for r in ("none", remat)}
    np.testing.assert_allclose(float(out[remat][1]), float(out["none"][1]),
                               rtol=1e-5, atol=1e-5)
    for k, w in out["none"][3].items():
        torch.testing.assert_close(out[remat][3][k], w, atol=1e-5, rtol=1e-5)


# --- the CLI --------------------------------------------------------------


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    """``--arch deepseek-v3-671b --smoke`` trains on the CPU: finite losses
    and ``moe_aux`` > 0 in every row."""
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
