"""Port parity for train-time augmentation (``repro_torch.data.augment``):
the apply half against the reference's ``augment_batch`` on the
reference's own draws (recomputed with ``jax.random`` on its key splits,
``src/repro/data/augment.py:142, 166, 209``), within 1e-6; the
properties of ``tests/test_augment_props.py`` on the port's own draws
(hypothesis); and the purity of the stream in (seed, step, microbatch).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("hypothesis")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.data import augment as ref_augment  # noqa: E402
from repro.data import datasets as ref_datasets  # noqa: E402
from repro_torch.data.augment import AugmentConfig, AugmentDraws, \
    MixDraws, augment_batch, draw_augment, draw_beta, step_seed  # noqa: E402
from repro_torch.data.datasets import CIFARSource  # noqa: E402
from repro_torch.data.pipeline import DataPipeline, batch_seed  # noqa: E402

TOL = 1e-6
SETTINGS = dict(max_examples=20, deadline=None)
N = 8


def _acfg(**kw):
    return AugmentConfig(num_classes=10, **kw)


def _ref_draws(rng, n, res, acfg):
    """The reference's draws for one microbatch, from its key splits."""
    k_crop, k_flip, k_mix = jax.random.split(rng, 3)
    crop = flip = mix = None
    if acfg.crop_pad:
        crop = torch.from_numpy(np.array(jax.random.randint(
            k_crop, (n, 2), 0, 2 * acfg.crop_pad + 1))).long()
    if acfg.flip:
        flip = torch.from_numpy(np.array(
            jax.random.bernoulli(k_flip, 0.5, (n,))))
    if acfg.mixing:
        k_lam_mix, k_lam_cut, k_apply, k_switch, k_perm, k_box = \
            jax.random.split(k_mix, 6)
        use_cutmix = bool(jax.random.bernoulli(k_switch, acfg.switch_prob)) \
            and acfg.cutmix_alpha > 0.0 if acfg.mixup_alpha > 0.0 \
            else acfg.cutmix_alpha > 0.0
        kx, ky = jax.random.split(k_box)
        a_mix, a_cut = acfg.mixup_alpha or 1.0, acfg.cutmix_alpha or 1.0
        mix = MixDraws(
            perm=torch.from_numpy(np.array(
                jax.random.permutation(k_perm, n))).long(),
            use_cutmix=use_cutmix,
            lam_mix=float(jax.random.beta(k_lam_mix, a_mix, a_mix)),
            lam_cut=float(jax.random.beta(k_lam_cut, a_cut, a_cut)),
            box_y=int(jax.random.randint(ky, (), 0, res)),
            box_x=int(jax.random.randint(kx, (), 0, res)),
            apply=bool(jax.random.bernoulli(k_apply, acfg.mix_prob)))
    return AugmentDraws(crop, flip, mix)


def _batch(seed, uint8=True, n=N):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, 32, 32, 3)).astype(np.uint8) if uint8 \
        else rng.normal(0, 1, (n, 32, 32, 3)).astype(np.float32)
    return {"images": images,
            "labels": rng.integers(0, 10, (n,)).astype(np.int32)}


RECIPES = {
    "default": {},
    "mixup": dict(cutmix_alpha=0.0, mix_prob=1.0),
    "cutmix": dict(mixup_alpha=0.0, mix_prob=1.0),
    "switch": dict(switch_prob=1.0, mix_prob=1.0),
    "geometric": dict(mixup_alpha=0.0, cutmix_alpha=0.0),
    "no crop": dict(crop_pad=0, flip=False, mix_prob=1.0),
}


@pytest.mark.parametrize("recipe", list(RECIPES))
@pytest.mark.parametrize("res,uint8", [(32, True), (64, True), (32, False)])
def test_apply_matches_reference_on_its_draws(recipe, res, uint8):
    src = ref_datasets.CIFARSource("cifar10", eval_size=8)
    port_pre = CIFARSource("cifar10", eval_size=8).preproc
    acfg = _acfg(**RECIPES[recipe])
    ref_acfg = ref_augment.AugmentConfig(**dataclasses.asdict(acfg))
    for seed in range(4):
        host = _batch(seed, uint8)
        key = jax.random.fold_in(jax.random.PRNGKey(7), seed)
        want = ref_augment.augment_batch(
            key, {k: jnp.asarray(v) for k, v in host.items()}, ref_acfg,
            preproc=src.preproc if uint8 else None, resolution=res)
        draws = _ref_draws(key, N, res, acfg)
        got = augment_batch(draws, {k: torch.from_numpy(v) for k, v in
                                    host.items()}, acfg,
                            preproc=port_pre if uint8 else None,
                            resolution=res)
        assert got["images"].shape == (N, res, res, 3)
        assert got["images"].dtype == torch.float32
        np.testing.assert_allclose(got["images"].numpy(),
                                   np.asarray(want["images"]), atol=TOL,
                                   rtol=0, err_msg=f"{recipe} seed {seed}")
        assert got["labels"].dtype == (torch.float32 if acfg.mixing
                                       else torch.int32)
        np.testing.assert_allclose(got["labels"].numpy(),
                                   np.asarray(want["labels"]), atol=TOL)


@pytest.mark.parametrize("rows", [slice(0, 2), slice(2, 4), slice(6, 8),
                                  torch.tensor([5, 1])])
def test_rows_of_a_microbatch_are_the_whole_apply_sliced(rows):
    """A rank applies the global microbatch's draws to its own rows; a
    partner row another rank owns comes from the global microbatch. So
    the rows come out bitwise as the whole microbatch's apply."""
    pre = CIFARSource("cifar10", eval_size=8).preproc
    acfg = _acfg(mix_prob=1.0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    for seed in range(6):
        draws = draw_augment(torch.Generator().manual_seed(seed), N, 64,
                             acfg)
        whole = augment_batch(draws, batch, acfg, preproc=pre, resolution=64)
        part = augment_batch(draws, batch, acfg, preproc=pre, resolution=64,
                             rows=rows)
        for k in ("images", "labels"):
            assert torch.equal(part[k], whole[k][rows]), (seed, k)


def test_augment_config_matches_reference():
    ref = {f.name: f.default for f in
           dataclasses.fields(ref_augment.AugmentConfig)}
    got = {f.name: f.default for f in dataclasses.fields(AugmentConfig)}
    assert got == ref
    with pytest.raises(ValueError, match="positive"):
        AugmentConfig(num_classes=0).validate()
    with pytest.raises(ValueError, match="crop_pad"):
        _acfg(crop_pad=-1).validate()


@pytest.mark.parametrize("a", [0.2, 1.0, 3.0])
def test_beta_draws_have_the_beta_moments(a):
    gen = torch.Generator().manual_seed(0)
    x = np.array([draw_beta(gen, a) for _ in range(4000)])
    assert ((x >= 0) & (x <= 1)).all()
    assert abs(x.mean() - 0.5) < 0.03
    var = 1.0 / (4.0 * (2.0 * a + 1.0))
    assert abs(x.var() - var) < 0.15 * var


# --- the properties of tests/test_augment_props.py, on the port ----------

def _draw(seed, step, microbatch, n, res, acfg):
    gen = torch.Generator().manual_seed(step_seed(seed, step, microbatch))
    return draw_augment(gen, n, res, acfg)


@settings(**SETTINGS)
@given(seed=st.integers(0, 2 ** 16), epoch=st.integers(0, 3),
       index=st.integers(0, 3), step=st.integers(0, 50),
       microbatch=st.integers(0, 3))
def test_augmentation_deterministic_under_cursor_contract(
        seed, epoch, index, step, microbatch):
    """Same (seed, epoch, index, step, microbatch) => same augmented
    batch, with every object rebuilt between the two draws: a resumed run
    replays the stream."""
    def draw():
        src = CIFARSource("cifar10", seed=seed, eval_size=8)
        pipe = DataPipeline(global_batch=4, seed=seed, source=src,
                            epoch_size=16)
        batch = {k: torch.from_numpy(v) for k, v in
                 pipe.batch_at(epoch, index).items()}
        return augment_batch(_draw(seed, step, microbatch, 4, 32, _acfg()),
                             batch, _acfg(), preproc=src.preproc,
                             resolution=32)
    a, b = draw(), draw()
    assert torch.equal(a["images"], b["images"])
    assert torch.equal(a["labels"], b["labels"])
    assert a["images"].dtype == torch.float32


def test_uint8_batch_without_preproc_raises():
    batch = {"images": torch.zeros((4, 32, 32, 3), dtype=torch.uint8),
             "labels": torch.zeros((4,), dtype=torch.int32)}
    draws = _draw(0, 0, 0, 4, 32, _acfg())
    with pytest.raises(ValueError, match="needs preproc"):
        augment_batch(draws, batch, _acfg())


@settings(**SETTINGS)
@given(seed=st.integers(0, 2 ** 16),
       mixup=st.sampled_from([0.0, 0.2, 1.0]),
       cutmix=st.sampled_from([0.0, 1.0]),
       switch=st.sampled_from([0.0, 0.5, 1.0]))
def test_mix_label_convexity(seed, mixup, cutmix, switch):
    """Soft labels are a convex combination of the pair's one-hots: rows
    sum to 1, lie in [0, 1], and are supported only on the two classes
    that were mixed."""
    if mixup == 0.0 and cutmix == 0.0:
        return
    acfg = _acfg(mixup_alpha=mixup, cutmix_alpha=cutmix, switch_prob=switch,
                 mix_prob=1.0, crop_pad=0, flip=False)
    gen = torch.Generator().manual_seed(seed)
    images = torch.randn((8, 32, 32, 3), generator=gen)
    labels = torch.randint(0, 10, (8,), generator=gen)
    out = augment_batch(draw_augment(gen, 8, 32, acfg),
                        {"images": images, "labels": labels}, acfg)
    soft = out["labels"].double().numpy()
    assert soft.shape == (8, 10)
    np.testing.assert_allclose(soft.sum(-1), 1.0, atol=1e-5)
    assert (soft >= -1e-6).all() and (soft <= 1.0 + 1e-6).all()
    for row, lab in zip(soft, labels.numpy()):
        nz = np.flatnonzero(row > 1e-6)
        assert len(nz) <= 2, (row, nz)
        if len(nz) == 2:
            assert lab in nz, (row, lab, nz)


@settings(**SETTINGS)
@given(seed=st.integers(0, 2 ** 16), pad=st.sampled_from([0, 2, 4]))
def test_flip_crop_label_invariance(seed, pad):
    """With mixing disabled the labels pass through hard and bitwise, and
    image shapes are kept; with no padding a crop and flip only permute
    each row's columns."""
    acfg = _acfg(mixup_alpha=0.0, cutmix_alpha=0.0, crop_pad=pad)
    gen = torch.Generator().manual_seed(seed)
    images = torch.randn((6, 32, 32, 3), generator=gen)
    labels = torch.randint(0, 10, (6,), generator=gen, dtype=torch.int32)
    out = augment_batch(draw_augment(gen, 6, 32, acfg),
                        {"images": images, "labels": labels}, acfg)
    assert out["images"].shape == images.shape
    assert out["labels"].dtype == labels.dtype
    assert torch.equal(out["labels"], labels)
    if pad == 0:
        a = np.sort(out["images"].numpy(), axis=2)
        b = np.sort(images.numpy(), axis=2)
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_stream_is_pure_in_seed_step_and_microbatch():
    """The same (seed, step, microbatch) gives the same draws in a fresh
    generator; changing any of the three changes them; and the seed is
    not the data pipeline's batch seed of the same numbers."""
    acfg = _acfg()

    def key(d):
        return (d.crop.tolist(), d.flip.tolist(), d.mix.perm.tolist(),
                d.mix.lam_mix, d.mix.lam_cut, d.mix.box_y, d.mix.box_x,
                d.mix.apply, d.mix.use_cutmix)
    base = key(_draw(3, 5, 1, N, 224, acfg))
    assert key(_draw(3, 5, 1, N, 224, acfg)) == base
    for other in ((4, 5, 1), (3, 6, 1), (3, 5, 0)):
        assert key(_draw(*other, N, 224, acfg)) != base, other
    assert step_seed(3, 5, 1) != batch_seed(3, 5, 1)
    assert 0 <= step_seed(2 ** 40, 10 ** 6, 7) < 2 ** 31
