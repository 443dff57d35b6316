"""Port parity for the ViT eval path: the reference's own smoke params
(``init_params(cfg, PRNGKey(0))``) cross into the port through
``params_from_numpy``; logits must match ``model.forward`` to atol 1e-4 in
fp32 with the kernel path on and off, and the eval counts exactly."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.data import augment as ref_augment  # noqa: E402
from repro.models import transformer as ref_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import EngineConfig  # noqa: E402
from repro_torch.core.engine import Evaluator  # noqa: E402
from repro_torch.data.datasets import CIFARSource  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ATOL = 1e-4
ref_counts = jax.jit(ref_model.classification_counts)


@pytest.fixture(scope="module")
def smoke():
    """(reference cfg, reference params, numpy param tree), fp32."""
    cfg = ref_configs.get_smoke_config("vit-b16").replace(dtype="float32")
    params = jax.jit(lambda k: ref_model.init_params(cfg, k))(
        jax.random.PRNGKey(0))
    return cfg, params, jax.tree.map(np.asarray, params)


def _ref_logits(cfg, params, batch):
    return _jit_forward(cfg)(params, batch)


@functools.lru_cache(maxsize=None)
def _jit_forward(cfg):
    return jax.jit(lambda p, b: ref_model.forward(cfg, p, b, mode="train")[0])


def _port_vit(tree, use_kernels=True):
    cfg = configs.get_smoke_config("vit-b16").replace(
        dtype="float32", use_kernels=use_kernels)
    return transformer.ViT(cfg, params_from_numpy(tree))


def _flat_shapes(tree, prefix=""):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flat_shapes(leaf, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = tuple(leaf.shape)
    return out


@pytest.mark.parametrize("factory", ["config", "smoke"])
def test_config_fields_match_reference(factory):
    port = getattr(configs.vit_b16, factory)()
    ref = getattr(ref_configs.REGISTRY["vit-b16"], factory)()
    for f in dataclasses.fields(port):
        if f.name != "use_kernels":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.layer_windows() == ref.layer_windows()
    local = dict(sliding_window=3, global_every=2)
    assert port.replace(**local).layer_windows() == \
        ref.replace(**local).layer_windows()


def test_unported_arch_raises():
    """Every arch of the reference's registry is ported (HuBERT and Zamba2
    last), so ``NOT_YET_PORTED`` is empty; an unknown arch raises."""
    assert configs.NOT_YET_PORTED == ()
    assert configs.get_config("hubert-xlarge").arch_type == "audio"
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("hubert-xxlarge")
    assert set(configs.NOT_YET_PORTED) | set(configs.REGISTRY) == \
        set(ref_configs.ALL_ARCHS)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_logits_match_reference(smoke, use_kernels):
    cfg, params, tree = smoke
    images = np.random.default_rng(0).normal(
        0, 1, (4, 32, 32, 3)).astype(np.float32)
    want = _ref_logits(cfg, params, {"images": jnp.asarray(images)})
    vit = _port_vit(tree, use_kernels)
    got = vit({"images": torch.from_numpy(images)})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)


def test_classification_counts_match_reference():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 2, (33, 10)).astype(np.float32)
    logits[0] = 0.0                      # a full tie: argmax picks index 0
    labels = rng.integers(0, 10, (33,)).astype(np.int32)
    labels[0] = 0
    mask = (rng.random(33) > 0.3).astype(np.float32)
    for m in (mask, None):
        got = transformer.classification_counts(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        want = ref_counts(jnp.asarray(logits), jnp.asarray(labels),
                          None if m is None else jnp.asarray(m))
        for key in ("top1", "top5", "count"):
            assert int(got[key]) == int(want[key]), key
        np.testing.assert_allclose(float(got["loss_sum"]),
                                   float(want["loss_sum"]), rtol=1e-5)
    got = transformer._xent(torch.from_numpy(logits),
                            torch.from_numpy(labels), torch.from_numpy(mask))
    want = ref_model._xent(jnp.asarray(logits), jnp.asarray(labels),
                           jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_padded_eval_counts_match_reference(smoke):
    """52 procedural examples in batches of 16 (the last has 12 padded
    rows): the port's evaluate() against the reference's preprocess,
    forward and classification_counts summed over the same batches."""
    cfg, params, tree = smoke
    source = CIFARSource("cifar10", seed=0, resolution=32, eval_size=52)
    vit = _port_vit(tree)
    got = Evaluator(vit.cfg, vit, preproc=source.preproc,
                    device="cpu").evaluate(source.eval_batches(16))
    want = {"top1": 0, "top5": 0, "count": 0, "loss_sum": 0.0}
    for host in source.eval_batches(16):
        batch = ref_augment.device_preprocess(
            {k: jnp.asarray(v) for k, v in host.items()}, source.preproc,
            cfg.image_size)
        m = ref_counts(_ref_logits(cfg, params, batch), batch["labels"],
                       batch["mask"])
        for key in want:
            want[key] += m[key].item()
    assert got["eval_count"] == want["count"] == 52
    assert got["eval_top1_count"] == want["top1"]
    assert got["eval_top5_count"] == want["top5"]
    np.testing.assert_allclose(got["eval_loss"], want["loss_sum"] / 52,
                               rtol=1e-5)


def test_state_dict_keys_are_reference_paths(smoke):
    _, _, tree = smoke
    vit = _port_vit(tree)
    sd = vit.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == _flat_shapes(tree)
    # a port-initialised model has the same layout and loads the weights
    port = transformer.ViT(vit.cfg, transformer.init_params(
        vit.cfg, seed=0, device="cpu"))
    port.load_state_dict(params_from_numpy(tree))


def test_full_width_param_shapes_match_reference():
    """vit-b16 at full width, built on the meta device: every param's key
    and shape equal the reference's ``jax.eval_shape(init_params)``."""
    ref_cfg = ref_configs.get_config("vit-b16")
    want = jax.eval_shape(lambda k: ref_model.init_params(ref_cfg, k),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    params = transformer.init_params(configs.get_config("vit-b16"),
                                     device="meta")
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        _flat_shapes(want)
    assert all(v.dtype == torch.float32 for v in params.values())


def test_init_is_seeded_and_truncated():
    cfg = configs.get_smoke_config("vit-b16")
    a = transformer.init_params(cfg, seed=3, device="cpu")
    b = transformer.init_params(cfg, seed=3, device="cpu")
    c = transformer.init_params(cfg, seed=4, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["stack.attn.wq"], c["stack.attn.wq"])
    w = a["stack.mlp.w_up"]                          # fan_in d_model
    assert float(w.abs().max()) <= 2.0 / cfg.d_model ** 0.5
    assert float(a["embed.pos"].abs().max()) <= 2.0 * 0.02


def test_cast_params_bf16_view():
    cfg = configs.get_smoke_config("vit-b16")
    vit = transformer.ViT(cfg, transformer.init_params(cfg, device="cpu"))
    ev = Evaluator(cfg, vit, ecfg=EngineConfig(cast_params_bf16=True),
                   device="cpu")
    view = ev._compute_params()
    for key, p in vit.params().items():
        want = torch.bfloat16 if p.ndim >= 2 else torch.float32
        assert view[key].dtype == want, key
    with pytest.raises(ValueError, match="preproc"):
        ev._preprocess_batch({"images": torch.zeros((1, 32, 32, 3),
                                                    dtype=torch.uint8)})
