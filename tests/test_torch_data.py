"""Port parity for the host data path and its on-device finish: the
procedural and pickle-backed CIFAR eval splits, the padded eval batches and
the preprocess must match ``repro.data`` byte for byte (uint8) or to 1e-6
(the normalised fp32 images)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import pickle  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import augment as ref_augment  # noqa: E402
from repro.data import datasets as ref_datasets  # noqa: E402
from repro_torch.data import augment, datasets  # noqa: E402


def _assert_batches_identical(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("name,seed,eval_size", [
    ("cifar10", 0, 52), ("cifar100", 3, 52), ("cifar10", 5, None)])
def test_procedural_eval_split_is_byte_identical(name, seed, eval_size):
    ref = ref_datasets.CIFARSource(name, seed=seed, eval_size=eval_size)
    port = datasets.CIFARSource(name, seed=seed, eval_size=eval_size)
    assert port.procedural and ref.procedural
    assert port.eval_size == ref.eval_size
    assert port.preproc.__dict__ == ref.preproc.__dict__
    _assert_batches_identical(port.eval_batches(16), ref.eval_batches(16))


@pytest.mark.parametrize("batch", [8, 37, 50])
def test_padded_eval_batches_match_reference(batch):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (37, 4, 4, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, (37,)).astype(np.int32)
    got = list(datasets.padded_eval_batches(images, labels, batch))
    _assert_batches_identical(
        got, ref_datasets.padded_eval_batches(images, labels, batch))
    last = got[-1]
    n_real = 37 - batch * (len(got) - 1)
    assert last["images"].shape[0] == batch
    assert last["mask"].sum() == n_real
    assert not last["images"][n_real:].any()


def _write_cifar(root, name, rng):
    def batch(n, key):
        return {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                key.encode(): list(rng.integers(0, 100, (n,)))}
    if name == "cifar10":
        d = root / "cifar-10-batches-py"
        d.mkdir()
        files = {f"data_batch_{i}": batch(6, "labels") for i in range(1, 6)}
        files["test_batch"] = batch(11, "labels")
    else:
        d = root / "cifar-100-python"
        d.mkdir()
        files = {"train": batch(6, "fine_labels"),
                 "test": batch(11, "fine_labels")}
    for fname, content in files.items():
        with open(d / fname, "wb") as f:
            pickle.dump(content, f)


@pytest.mark.parametrize("name", ["cifar10", "cifar100"])
def test_pickle_eval_split_matches_reference(tmp_path, name):
    _write_cifar(tmp_path, name, np.random.default_rng(1))
    ref = ref_datasets.CIFARSource(name, data_dir=str(tmp_path), eval_size=7)
    port = datasets.CIFARSource(name, data_dir=str(tmp_path), eval_size=7)
    assert not port.procedural
    _assert_batches_identical(port.eval_batches(4), ref.eval_batches(4))


def test_data_dir_without_batches_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="does not contain"):
        datasets.CIFARSource("cifar10", data_dir=str(tmp_path))


def test_host_normalize_and_quantize_match_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (5, 8, 8, 3)).astype(np.float32)
    stats = (datasets.CIFAR10_MEAN, datasets.CIFAR10_STD)
    u8 = datasets.quantize_images(x, *stats)
    np.testing.assert_array_equal(u8, ref_datasets.quantize_images(x, *stats))
    np.testing.assert_array_equal(datasets.normalize_images(u8, *stats),
                                  ref_datasets.normalize_images(u8, *stats))


@pytest.mark.parametrize("resolution", [32, 64])
def test_device_preprocess_matches_reference(resolution):
    src = datasets.CIFARSource("cifar100", seed=1, eval_size=6)
    host = next(src.eval_batches(6))
    got = augment.device_preprocess(
        {k: torch.from_numpy(v) for k, v in host.items()}, src.preproc,
        resolution)
    want = ref_augment.device_preprocess(
        {k: jnp.asarray(v) for k, v in host.items()}, src.preproc,
        resolution)
    assert got["images"].dtype == torch.float32
    assert tuple(got["images"].shape) == (6, resolution, resolution, 3)
    np.testing.assert_allclose(got["images"].numpy(),
                               np.asarray(want["images"]), atol=1e-6)
    np.testing.assert_allclose(
        got["images"].numpy(),
        datasets.normalize_images(np.repeat(np.repeat(
            host["images"], resolution // 32, 1), resolution // 32, 2),
            src.mean, src.std), atol=1e-5)


def test_float_batch_passes_through_untouched():
    batch = {"images": torch.zeros((2, 32, 32, 3))}
    assert augment.device_preprocess(batch, None, 32) is batch


def test_uint8_without_preproc_raises():
    batch = {"images": torch.zeros((2, 32, 32, 3), dtype=torch.uint8)}
    with pytest.raises(ValueError, match="uint8"):
        augment.device_preprocess(batch, None, 32)


def test_upsample_rejects_non_integer_factor():
    with pytest.raises(ValueError, match="integer multiple"):
        augment.upsample(torch.zeros((1, 32, 32, 3), dtype=torch.uint8), 48)
