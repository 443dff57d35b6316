"""Port parity for the audio encoder (``hubert-xlarge``): its config, the
audio embed (the stubbed frontend's frame features, the mask embedding and
the sinusoidal positions), the LayerNorm encoder and the masked-frame
loss, ``concrete_batch``'s audio batch, the refusals of a model with no
decode step, K1-K3's head dim 80 on the host side and on their plain path,
and the training CLI.

The reference side is the JAX package's pure functions (``model.forward``,
``model.loss_fn`` with ``jax.value_and_grad``, ``kernels.ref``), never
``DistributedEngine``. Its smoke params cross with ``params_from_numpy``,
the unit norm scales perturbed by numpy noise on both sides. Tolerances
are ``tests/test_torch_dense.py``'s: logits 1e-4, loss 1e-5, grads 2e-4
in fp32; K1-K3's plain path 1e-4 (``tests/test_flash_grad.py``). The
smoke config's head dim is 64, so a copy at head dim 80 (d_model 320, 4
heads) holds the model path at HuBERT's width on the CPU; the CUDA kernels
at D 80 are checked on the card by ``chip_smoke.py`` (phases 6c and 16).
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
from repro.kernels.ref import ref_attention as jax_ref_attention  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.models import transformer as ref_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.engine import Server  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.launch.specs import concrete_batch  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "hubert-xlarge"
LOGITS_TOL, LOSS_TOL, GRAD_TOL, KERNEL_TOL = 1e-4, 1e-5, 2e-4, 1e-4
B, S = 2, 40
# the smoke config, and a copy at HuBERT's head dim of 80
WIDTHS = {"smoke": {}, "d80": {"d_model": 320, "num_heads": 4,
                                "num_kv_heads": 4, "head_dim": 80,
                                "d_ff": 640}}


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


@functools.lru_cache(maxsize=None)
def _smoke(width):
    """(reference cfg, numpy flat params): the reference's fp32 init, the
    LayerNorm scales and biases perturbed."""
    cfg = ref_configs.get_smoke_config(ARCH).replace(dtype="float32",
                                                     **WIDTHS[width])
    params = jax.jit(lambda k: ref_model.init_params(cfg, k))(
        jax.random.PRNGKey(0))
    flat = {k: v.copy() for k, v in _flat(params).items()}
    rng = np.random.default_rng(7)
    for key, leaf in flat.items():
        if key.endswith(("scale", "bias")):
            leaf += rng.normal(0, 0.1, leaf.shape).astype(np.float32)
    return cfg, flat


def _batch(cfg, seed=0):
    """Frame features, a mask of about 0.3 and codebook labels (numpy)."""
    rng = np.random.default_rng(seed)
    return {"features": rng.standard_normal(
                (B, S, cfg.audio_feat_dim)).astype(np.float32),
            "mask": rng.random((B, S)) < 0.3,
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32)}


# --- the config --------------------------------------------------------------


@pytest.mark.parametrize("factory", ["config", "smoke"])
def test_config_fields_match_reference(factory):
    port = getattr(configs.hubert_xlarge, factory)()
    ref = getattr(ref_configs.REGISTRY[ARCH], factory)()
    for f in dataclasses.fields(port):
        if f.name != "use_kernels":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert configs.get_config(ARCH) == port or factory == "smoke"
    assert ARCH in configs.REGISTRY and ARCH not in configs.NOT_YET_PORTED
    assert port.supports_decode() is ref.supports_decode() is False
    assert port.supports_long_decode() == ref.supports_long_decode()
    assert port.is_encoder_only and port.head_dim == ref.head_dim


def test_full_width_param_shapes_match_reference():
    """hubert-xlarge at full width and depth: every param's key and shape
    equal the reference's ``jax.eval_shape``, and the count its
    ``param_count`` (0.96 B)."""
    ref_cfg = ref_configs.get_config(ARCH)
    want = jax.eval_shape(lambda k: ref_model.init_params(ref_cfg, k),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    params = transformer.init_params(configs.get_config(ARCH),
                                     device="meta")
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in _flat(want).items()}
    n = sum(v.numel() for v in params.values())
    assert n == ref_cfg.param_count() and 0.9e9 < n < 1.0e9


# --- the model against the reference -----------------------------------------


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_logits_loss_and_grads_match_reference(width, use_kernels):
    """The smoke encoder (and its head-dim-80 copy) on a masked batch:
    logits 1e-4, the masked-frame loss 1e-5 and every gradient 2e-4
    against ``jax.value_and_grad(loss_fn)``, through the kernels' plain
    path (``use_kernels``: K1-K3's CPU versions) and the naive
    attention."""
    ref_cfg, flat = _smoke(width)
    cfg = configs.get_smoke_config(ARCH).replace(
        dtype="float32", use_kernels=use_kernels, **WIDTHS[width])
    assert cfg.head_dim == ref_cfg.head_dim
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _nest(flat)
    want_logits, _, _ = ref_model.forward(ref_cfg, params, jb, mode="train")
    (want_loss, _), want_grads = jax.value_and_grad(
        lambda p: ref_model.loss_fn(ref_cfg, p, jb), has_aux=True)(params)
    p = {k: v.requires_grad_() for k, v in params_from_numpy(flat).items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, _ = transformer.forward(cfg, p, tb, mode="train")
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), atol=LOGITS_TOL)
    loss, metrics = transformer.loss_fn(cfg, p, tb)
    np.testing.assert_allclose(float(loss), float(want_loss),
                               atol=LOSS_TOL)
    assert float(metrics["loss"]) == float(loss)
    grads = torch.autograd.grad(loss, list(p.values()))
    want = _flat(want_grads)
    assert set(want) == set(p)
    for key, g in zip(p, grads):
        np.testing.assert_allclose(g.numpy(), want[key], atol=GRAD_TOL,
                                   err_msg=key)


def test_loss_counts_only_the_masked_frames():
    """Changing a label at an unmasked frame leaves the loss as it was; at
    a masked frame it moves it; a batch with no masked frame has loss 0,
    as the reference's ``_xent`` with its ``max(sum(mask), 1)``."""
    ref_cfg, flat = _smoke("smoke")
    cfg = configs.get_smoke_config(ARCH).replace(dtype="float32")
    p = params_from_numpy(flat)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=1).items()}
    base = float(transformer.loss_fn(cfg, p, batch)[0])
    free = torch.nonzero(~batch["mask"])[0]
    hit = torch.nonzero(batch["mask"])[0]
    for where, moves in ((free, False), (hit, True)):
        labels = batch["labels"].clone()
        labels[tuple(where)] = (labels[tuple(where)] + 1) % cfg.vocab_size
        got = float(transformer.loss_fn(cfg, p, dict(batch,
                                                     labels=labels))[0])
        assert (got != base) is moves
    none = dict(batch, mask=torch.zeros_like(batch["mask"]))
    got = transformer.loss_fn(cfg, p, none)[0]
    want, _ = ref_model.loss_fn(ref_cfg, _nest(flat), {
        k: jnp.asarray(v.numpy()) for k, v in none.items()})
    assert float(got) == float(want) == 0.0


def test_embed_matches_reference_with_and_without_a_mask():
    """The audio embed: features through feat_proj and feat_b, mask_emb
    at the masked frames, the sinusoidal table (reference
    ``_sinusoidal_pos``, also at an odd length); without a ``mask`` key no
    frame is replaced."""
    ref_cfg, flat = _smoke("smoke")
    cfg = configs.get_smoke_config(ARCH).replace(dtype="float32")
    p = params_from_numpy(flat)
    batch = _batch(cfg)
    for b in (batch, {"features": batch["features"][:, :37]}):
        want, _ = ref_model.embed(ref_cfg, _nest(flat),
                                  {k: jnp.asarray(v) for k, v in b.items()})
        got, positions = transformer._embed(
            cfg, p, {k: torch.from_numpy(v) for k, v in b.items()})
        assert positions is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5)
    np.testing.assert_allclose(
        transformer._sinusoidal_pos(37, 256, "cpu").numpy(),
        np.asarray(ref_model._sinusoidal_pos(37, 256)), atol=1e-5)


def test_encoder_is_bidirectional():
    """A change of the features at frame 20 moves the logits of earlier
    frames (the reference's ``test_encoder_is_bidirectional``)."""
    _, flat = _smoke("smoke")
    cfg = configs.get_smoke_config(ARCH).replace(dtype="float32")
    p = params_from_numpy(flat)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    batch["mask"] = torch.zeros_like(batch["mask"])
    a, _ = transformer.forward(cfg, p, batch)
    moved = dict(batch, features=batch["features"].clone())
    moved["features"][0, 20] += 1.0
    b, _ = transformer.forward(cfg, p, moved)
    assert (a - b).abs()[0, :20].max() > 1e-6


def test_bf16_logits_follow_fp32():
    """The compute dtype bf16 (the card's training dtype) on the same
    params: logits within bf16 rounding of the fp32 ones (cosine >=
    0.999)."""
    _, flat = _smoke("d80")
    cfg = configs.get_smoke_config(ARCH).replace(**WIDTHS["d80"])
    p = params_from_numpy(flat)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    lo, _ = transformer.forward(cfg, p, batch)
    hi, _ = transformer.forward(cfg.replace(dtype="float32"), p, batch)
    assert lo.dtype == torch.bfloat16
    cos = torch.nn.functional.cosine_similarity(
        lo.float().flatten(), hi.flatten(), dim=0)
    assert cos >= 0.999


# --- concrete_batch ----------------------------------------------------------


@pytest.mark.parametrize("seq", [32, 781])
def test_concrete_batch_has_the_reference_structure(seq):
    """The audio batch has the reference's keys, shapes and dtypes (numpy
    draws, deviation D5): fp32 features, a bool mask set with probability
    0.2, int32 labels inside the codebook; one seed gives one batch."""
    cfg = configs.get_smoke_config(ARCH)
    got = concrete_batch(cfg, 4, seq, seed=3)
    want = ref_specs.concrete_batch(
        ref_configs.get_smoke_config(ARCH), 4, seq, seed=3)
    assert {k: (v.shape, np.dtype(v.dtype)) for k, v in got.items()} == \
        {k: (v.shape, np.dtype(v.dtype)) for k, v in want.items()}
    assert got["labels"].min() >= 0 and got["labels"].max() < cfg.vocab_size
    frac = got["mask"].mean()
    assert 0.05 < frac < 0.4
    again = concrete_batch(cfg, 4, seq, seed=3)
    assert all(np.array_equal(got[k], again[k]) for k in got)


# --- no decode step ----------------------------------------------------------


def test_serving_refuses_the_encoder():
    """``init_cache``, ``Server`` and the serve CLI refuse HuBERT: it has
    no decode step."""
    cfg = configs.get_smoke_config(ARCH)
    with pytest.raises(ValueError, match="no decode step"):
        transformer.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="no decode step"):
        Server(cfg, {}, device="cpu")
    with pytest.raises(SystemExit, match="no decode step"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])


# --- K1-K3 at head dim 80 ----------------------------------------------------


def test_kernel_inputs_take_head_dim_80():
    """The wrappers' shape checks take (80, 80) and the smoke MLA pair (48,
    32) in both dtypes; a pair outside the table still raises."""
    assert (80, 80) in fa.HEAD_DIM_PAIRS and (48, 32) in fa.HEAD_DIM_PAIRS
    for d, dv in ((80, 80), (48, 32)):
        q = torch.zeros((1, 2, 8, d))
        v = torch.zeros((1, 2, 8, dv))
        fa.check_kernel_inputs(q, q, v)
        fa.check_kernel_inputs(q.bfloat16(), q.bfloat16(), v.bfloat16())
    for d, dv in ((80, 64), (64, 80), (96, 96), (40, 40)):
        with pytest.raises(ValueError, match="head dims"):
            fa.check_kernel_inputs(torch.zeros((1, 2, 8, d)),
                                   torch.zeros((1, 2, 8, d)),
                                   torch.zeros((1, 2, 8, dv)))


@pytest.mark.parametrize("causal", [False, True])
def test_plain_path_at_head_dim_80_matches_reference(causal):
    """K1-K3's CPU versions at D 80 and a ragged S of 45 (HuBERT's
    non-causal, Zamba2's causal) against the reference's ``ref_attention``
    and its VJP: 1e-4; no kernel launches on the CPU."""
    rng = np.random.default_rng(5)
    q, k, v, w = (rng.normal(0, 1, (2, 4, 45, 80)).astype(np.float32)
                  for _ in range(4))
    tq, tk, tv, tw = (torch.from_numpy(x) for x in (q, k, v, w))
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(tq, tk, tv, causal=causal)
    want, vjp = jax.vjp(lambda a, b, c: jax_ref_attention(
        a, b, c, causal=causal), *(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               atol=KERNEL_TOL)
    dq, delta = fa.flash_attention_bwd_dq(tq, tk, tv, out, lse, tw,
                                          causal=causal)
    dk, dv = fa.flash_attention_bwd_dkv(tq, tk, tv, tw, lse, delta,
                                        causal=causal)
    for g, r in zip((dq, dk, dv), vjp(jnp.asarray(w))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=KERNEL_TOL)
    assert fa.flash_attention_fwd.launches == before


# --- the training CLI --------------------------------------------------------


def test_train_cli_on_the_cpu():
    """``--arch hubert-xlarge --smoke`` trains on batches drawn each step
    by ``concrete_batch``: finite losses and grad norms, ``step_ok`` 1."""
    rows = cli.main(["--arch", ARCH, "--smoke", "--steps", "3", "--seq",
                     "48", "--batch", "4", "--accum", "2", "--log-every",
                     "1", "--device", "cpu"])
    assert [r["step"] for r in rows] == [0, 1, 2]
    for r in rows:
        assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
        assert r["step_ok"] == 1
