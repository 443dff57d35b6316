"""Port parity for Qwen2-VL-72B (``qwen2-vl-72b``), the vision-language
decoder: its config, M-RoPE, the image-embedding splice, the loss that
skips image positions, the training CLI's vlm feed, and its serving path.

The reference side is the JAX package's pure functions
(``repro.models.rope``, ``model.forward``, ``model.loss_fn`` with
``jax.value_and_grad``, ``model.init_cache``), never
``DistributedEngine``, with ``use_pallas=False`` (caveat R1). Smoke params
cross with ``params_from_numpy``, the unit norm scales perturbed by numpy
noise on both sides. Tolerances: the rope 1e-6; logits 1e-4, loss 1e-5,
grads 2e-4 (``tests/test_torch_lm.py``'s); prefill and decode logits
1e-4, cache leaves 1e-5 (absolute plus relative). Batches carry 16 image
embeddings and a (t, h, w) position grid whose three sections differ
over the image.
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
from repro.launch import specs as ref_specs  # noqa: E402
from repro.models import rope as ref_rope  # noqa: E402
from repro.models import transformer as ref_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models import rope, transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "qwen2-vl-72b"
LOGITS_TOL, LOSS_TOL, GRAD_TOL = 1e-4, 1e-5, 2e-4
CACHE_TOL = 1e-5
B, SEQ, N_IMG = 2, 40, 16


def _flat(tree, prefix=""):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flat(leaf, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = leaf
    return out


@functools.lru_cache(maxsize=None)
def _smoke():
    """(reference cfg, reference params, numpy param tree), fp32, the norm
    scales perturbed."""
    cfg = ref_configs.get_smoke_config(ARCH).replace(dtype="float32")
    tree = jax.tree.map(np.array, jax.jit(
        lambda k: ref_model.init_params(cfg, k))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    for key, leaf in _flat(tree).items():
        if key.endswith("scale"):
            leaf += rng.normal(0, 0.1, leaf.shape).astype(np.float32)
    return cfg, jax.tree.map(jnp.asarray, tree), tree


def _grid(b, s, n_img, side=4):
    """(B, S, 3) M-RoPE positions: the image a (side x n_img/side) patch
    grid at t 0, then text at max + 1 onward in all three sections."""
    i = np.arange(n_img)
    img = np.stack([np.zeros_like(i), i // side, i % side], -1)
    text = img.max() + 1 + np.arange(s - n_img)
    pos = np.concatenate([img, np.repeat(text[:, None], 3, -1)], 0)
    return np.broadcast_to(pos[None], (b, s, 3)).astype(np.int32)


def _batch(seed, s=SEQ):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 512, (B, s)).astype(np.int32),
            "image_embeds": rng.normal(0, 1, (B, N_IMG, 256)).astype(
                np.float32),
            "positions": _grid(B, s, N_IMG)}


def _port_cfg(**kw):
    return configs.get_smoke_config(ARCH).replace(**{"dtype": "float32",
                                                     **kw})


def _tb(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


# --- config and M-RoPE ----------------------------------------------------


@pytest.mark.parametrize("factory", ["config", "smoke"])
def test_config_fields_match_reference(factory):
    port = getattr(configs.REGISTRY[ARCH], factory)()
    ref = getattr(ref_configs.REGISTRY[ARCH], factory)()
    for f in dataclasses.fields(port):
        if f.name != "use_kernels":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert (configs.get_config if factory == "config"
            else configs.get_smoke_config)(ARCH) == port
    assert ARCH not in configs.NOT_YET_PORTED
    assert port.supports_decode() == ref.supports_decode() is True
    assert port.supports_long_decode() == ref.supports_long_decode()
    assert port.rope_style == "mrope" and port.arch_type == "vlm"


def test_decode_support_matches_reference_for_every_ported_arch():
    for arch in configs.REGISTRY:
        port, ref = configs.get_config(arch), ref_configs.get_config(arch)
        assert port.supports_decode() == ref.supports_decode(), arch
        assert port.supports_long_decode() == ref.supports_long_decode(), \
            arch
        assert port.is_attention_free == ref.is_attention_free, arch


def test_mrope_sections_must_split_the_rope_pairs():
    cfg = configs.get_config(ARCH)
    with pytest.raises(ValueError, match="mrope_sections"):
        cfg.replace(mrope_sections=(16, 24, 16))
    with pytest.raises(ValueError, match="sum to"):
        rope.mrope_angles(torch.zeros((1, 2, 3)), 32, 1e4, (4, 6, 4))


def test_full_width_param_shapes_match_reference():
    """qwen2-vl-72b at full width cut to the one layer the card runs:
    every key and shape equal the reference's ``jax.eval_shape``; 3.37 B
    params (on the ``meta`` device)."""
    ref_cfg = ref_configs.get_config(ARCH).replace(num_layers=1)
    want = jax.eval_shape(lambda k: ref_model.init_params(ref_cfg, k),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    params = transformer.init_params(
        configs.get_config(ARCH).replace(num_layers=1), device="meta")
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in _flat(want).items()}
    assert params["stack.attn.bq"].shape == (1, 8192)
    assert round(sum(p.numel() for p in params.values()) / 1e9, 2) == 3.37


def test_mrope_angles_match_reference():
    pos = np.random.default_rng(0).integers(0, 500, (2, 9, 3)).astype(
        np.int32)
    want = ref_rope.mrope_angles(jnp.asarray(pos), 128, 1e6, (16, 24, 24))
    got = rope.mrope_angles(torch.from_numpy(pos), 128, 1e6, (16, 24, 24))
    assert got.shape == (2, 9, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_mrope_matches_reference(dtype):
    """q and k rotated at different positions (a decode row's q against a
    cached grid's k, the reference's ``(q_pos, k_pos)`` tuple)."""
    rng = np.random.default_rng(1)
    q = rng.normal(0, 1, (2, 1, 8, 32)).astype(np.float32)
    k = rng.normal(0, 1, (2, SEQ, 2, 32)).astype(np.float32)
    q_pos = np.full((2, 1, 3), SEQ, np.int32)
    k_pos = _grid(2, SEQ, N_IMG)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = ref_rope.apply_rope(
        jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt),
        (jnp.asarray(q_pos), jnp.asarray(k_pos)), style="mrope",
        theta=1e6, sections=(4, 6, 6))
    got = rope.apply_rope(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        (torch.from_numpy(q_pos), torch.from_numpy(k_pos)), style="mrope",
        theta=1e6, sections=(4, 6, 6))
    tol = 1e-6 if dtype == "float32" else 1e-2
    for g, w in zip(got, want):
        assert g.dtype == tdt
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), atol=tol)
    # the default grid (no positions) is 0..S-1 in every section: the
    # same rotation as the full style at those positions
    pos = torch.arange(SEQ)[None].expand(2, SEQ)
    full = rope.apply_rope(torch.from_numpy(k), torch.from_numpy(k), pos,
                           style="full", theta=1e6)[0]
    mr = rope.apply_rope(torch.from_numpy(k), torch.from_numpy(k),
                         pos[..., None].expand(2, SEQ, 3), style="mrope",
                         theta=1e6, sections=(4, 6, 6))[0]
    torch.testing.assert_close(mr, full, rtol=0, atol=1e-6)


# --- the model --------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(cfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: ref_model.loss_fn(cfg, p, b), has_aux=True))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_logits_loss_and_grads_match_jax(use_kernels):
    """Smoke-size logits with image embeddings and a 3-D grid (1e-4), the
    loss with its image mask (1e-5) and every param's grad (2e-4)."""
    cfg, params, tree = _smoke()
    batch = _batch(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_logits = ref_model.forward(cfg, params, jb, mode="train")[0]
    (want_loss, _), want_grads = _ref_value_and_grad(cfg)(params, jb)
    pcfg = _port_cfg(use_kernels=use_kernels)
    leaves = {k: v.requires_grad_() for k, v in
              params_from_numpy(tree).items()}
    tb = _tb(batch)
    logits, aux = transformer.forward(pcfg, leaves, tb)
    loss, _ = transformer.loss_from_logits(pcfg, logits, tb, aux)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), atol=LOGITS_TOL)
    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL
    want = _flat(jax.tree.map(np.asarray, want_grads))
    assert set(grads) == set(want)
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[key], atol=GRAD_TOL,
                                   err_msg=key)
    # the image embeddings matter, and so does the grid
    other = dict(tb, image_embeds=tb["image_embeds"] + 1.0)
    assert not torch.allclose(transformer.forward(pcfg, leaves, other)[0],
                              logits)
    no_grid = {k: v for k, v in tb.items() if k != "positions"}
    assert not torch.allclose(
        transformer.forward(pcfg, leaves, no_grid)[0], logits)


def test_loss_skips_the_image_positions():
    """Logits at the image positions do not enter the loss; without
    ``image_embeds`` every position but the last does."""
    cfg = _port_cfg()
    tb = _tb(_batch(4))
    logits = torch.randn((B, SEQ, 512), generator=torch.Generator()
                         .manual_seed(0))
    loss = transformer.loss_from_logits(cfg, logits, tb)[0]
    moved = logits.clone()
    moved[:, :N_IMG] += torch.randn(moved[:, :N_IMG].shape)
    assert transformer.loss_from_logits(cfg, moved, tb)[0] == loss
    text = {"tokens": tb["tokens"]}
    assert transformer.loss_from_logits(cfg, moved, text)[0] != \
        transformer.loss_from_logits(cfg, logits, text)[0]
    want = ref_model.loss_from_logits(
        _smoke()[0], jnp.asarray(logits.numpy()),
        {k: jnp.asarray(v.numpy()) for k, v in tb.items()})[0]
    assert abs(loss.item() - float(want)) <= LOSS_TOL


def test_concrete_batch_has_the_reference_structure():
    cfg, ref_cfg = _port_cfg(), _smoke()[0]
    for seq in (64, 20):
        got = specs.concrete_batch(cfg, 3, seq, seed=1)
        want = ref_specs.concrete_batch(ref_cfg, 3, seq, seed=1)
        assert {k: (v.shape, str(v.dtype)) for k, v in got.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in want.items()}
        assert got["tokens"].max() < 512
    assert np.array_equal(specs.concrete_batch(cfg, 2, 8, seed=5)["tokens"],
                          specs.concrete_batch(cfg, 2, 8, seed=5)["tokens"])
    dense = configs.get_smoke_config("qwen2.5-14b")
    assert list(specs.concrete_batch(dense, 2, 8)) == ["tokens"]
    with pytest.raises(ValueError, match="data pipeline"):
        specs.concrete_batch(configs.get_smoke_config("vit-b16"), 2, 8)


def test_cli_trains_on_the_cpu(capsys):
    """The training CLI's vlm feed: batches drawn for each step (no data
    cursor), finite losses, ``step_ok`` 1, the same losses again from a
    second run, bitwise."""
    argv = ["--arch", ARCH, "--smoke", "--steps", "4", "--seq", "48",
            "--batch", "4", "--accum", "2", "--log-every", "1", "--device",
            "cpu"]
    hist = cli.main(argv)
    out = capsys.readouterr().out
    assert "[train] vlm: seq=48 vocab=512 image tokens=16" in out
    assert [r["step"] for r in hist] == [0, 1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["step_ok"] == 1 for r in hist)
    assert [r["loss"] for r in cli.main(argv)] == [r["loss"] for r in hist]


# --- serving ----------------------------------------------------------------


def test_prefill_and_decode_match_reference():
    """Prefill of a prompt with image embeddings and a 3-D grid, then four
    decode steps, against the reference's ``forward(mode="prefill" /
    "decode")`` at the same params: logits 1e-4, every cache leaf 1e-5;
    and the decode logits against train-mode logits of the whole sequence
    (5e-4, the reference's contract), whose grid continues the prompt's
    text positions at the decode index."""
    cfg, params, tree = _smoke()
    extra, s = 4, 24
    batch = _batch(5, s + extra)
    # decode rotates at the index in every section: the train-mode grid
    # must give the decode rows those positions
    batch["positions"][:, s:] = np.arange(s, s + extra)[None, :, None]
    batch["positions"][:, N_IMG:s] = np.arange(N_IMG, s)[None, :, None]
    prompt = {"tokens": batch["tokens"][:, :s],
              "image_embeds": batch["image_embeds"],
              "positions": batch["positions"][:, :s]}
    pcfg = _port_cfg()
    p = params_from_numpy(tree)
    rcache = ref_model.init_cache(cfg, B, s + extra, dtype=jnp.float32)
    pcache = transformer.init_cache(pcfg, B, s + extra, dtype=torch.float32,
                                    device="cpu")
    want, rcache, _ = ref_model.forward(
        cfg, params, {k: jnp.asarray(v) for k, v in prompt.items()},
        mode="prefill", cache=rcache)
    got, pcache, _ = transformer.forward(pcfg, p, _tb(prompt),
                                         mode="prefill", cache=pcache)
    full, _ = transformer.forward(pcfg, p, _tb(batch), mode="eval")
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_TOL)

    def same_cache():
        for key, leaf in _flat(jax.tree.map(np.asarray, rcache)).items():
            g, w = key.split(".")
            np.testing.assert_allclose(pcache[g][w].numpy(), leaf,
                                       atol=CACHE_TOL, rtol=CACHE_TOL,
                                       err_msg=key)
    same_cache()
    for i in range(extra):
        tok = batch["tokens"][:, s + i:s + i + 1]
        want, rcache, _ = ref_model.forward(
            cfg, params, {"token": jnp.asarray(tok),
                          "index": jnp.int32(s + i)},
            mode="decode", cache=rcache)
        got, pcache, _ = transformer.forward(
            pcfg, p, {"token": torch.from_numpy(tok), "index": s + i},
            mode="decode", cache=pcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGITS_TOL)
        np.testing.assert_allclose(got[:, 0].numpy(),
                                   full[:, s + i].numpy(), atol=5e-4)
        same_cache()
