"""Port parity for the host data path and its on-device finish: the
procedural and pickle-backed CIFAR train and eval splits, the padded eval
batches, the ``DataPipeline`` cursor and the preprocess must match
``repro.data`` byte for byte (uint8 and the synthetic fp32 stream) or to
1e-6 (the normalised fp32 images)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import pickle  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import augment as ref_augment  # noqa: E402
from repro.data import datasets as ref_datasets  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.data import synthetic as ref_synthetic  # noqa: E402
from repro_torch.data import augment, datasets, pipeline, \
    synthetic  # noqa: E402


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


CURSORS = [(0, 0, 0), (0, 0, 3), (7, 2, 1), (123, 5, 0)]   # seed, epoch, i


def test_batch_seed_matches_reference():
    for seed, epoch, i in CURSORS + [(2 ** 40, 3, 9)]:
        assert pipeline.batch_seed(seed, epoch, i) == \
            ref_pipeline.batch_seed(seed, epoch, i)


@pytest.mark.parametrize("seed,epoch,index", CURSORS)
def test_synthetic_stream_batch_at_is_byte_identical(seed, epoch, index):
    kw = dict(global_batch=6, seed=seed, resolution=32, epoch_size=24)
    ref = ref_pipeline.DataPipeline(kind="image",
                                    dataset=ref_synthetic.DATASETS["cifar10"],
                                    **kw)
    port = pipeline.DataPipeline(dataset=synthetic.DATASETS["cifar10"], **kw)
    assert port.steps_per_epoch == ref.steps_per_epoch == 4
    _assert_batches_identical([port.batch_at(epoch, index)],
                              [ref.batch_at(epoch, index)])
    assert port.batch_at(epoch, index)["images"].dtype == np.float32
    np.testing.assert_array_equal(
        synthetic.make_image_batch(synthetic.DATASETS["cifar100"], 3,
                                   seed=seed, resolution=16)["images"],
        ref_synthetic.make_image_batch(ref_synthetic.DATASETS["cifar100"], 3,
                                       seed=seed, resolution=16)["images"])


@pytest.mark.parametrize("name", ["cifar10", "cifar100"])
@pytest.mark.parametrize("seed,epoch,index", CURSORS[1:])
def test_procedural_source_batch_at_is_byte_identical(name, seed, epoch,
                                                      index):
    kw = dict(seed=seed, train_size=64)
    ref_src = ref_datasets.CIFARSource(name, **kw)
    src = datasets.CIFARSource(name, **kw)
    assert src.train_size == ref_src.train_size == 64
    ref = ref_pipeline.DataPipeline(kind="image", global_batch=8,
                                    source=ref_src, seed=seed)
    port = pipeline.DataPipeline(global_batch=8, source=src, seed=seed)
    assert port.steps_per_epoch == ref.steps_per_epoch == 8
    got = port.batch_at(epoch, index)
    assert got["images"].dtype == np.uint8 and got["images"].shape == \
        (8, 32, 32, 3)
    _assert_batches_identical([got], [ref.batch_at(epoch, index)])


def test_procedural_train_size_default():
    src = datasets.CIFARSource("cifar10")
    assert src.train_size == datasets.PROCEDURAL_TRAIN_SIZE == \
        ref_datasets.PROCEDURAL_TRAIN_SIZE == 4096


@pytest.mark.parametrize("name", ["cifar10", "cifar100"])
@pytest.mark.parametrize("frac", [1.0, 0.5])
def test_pickle_source_batch_at_is_byte_identical(tmp_path, name, frac):
    _write_cifar(tmp_path, name, np.random.default_rng(4))
    kw = dict(data_dir=str(tmp_path), seed=2, train_size=20)
    ref_src = ref_datasets.CIFARSource(name, **kw)
    src = datasets.CIFARSource(name, **kw)
    assert src.train_size == ref_src.train_size == min(20, len(
        src._train_labels))
    ref = ref_pipeline.DataPipeline(kind="image", global_batch=4,
                                    source=ref_src, seed=2,
                                    weak_scaling_frac=frac)
    port = pipeline.DataPipeline(global_batch=4, source=src, seed=2,
                                 weak_scaling_frac=frac)
    assert port.sample_pool == ref.sample_pool
    assert port.epoch_size == ref.epoch_size
    _assert_batches_identical(
        [port.batch_at(e, i) for e in (0, 1) for i in range(
            port.steps_per_epoch)],
        [ref.batch_at(e, i) for e in (0, 1) for i in range(
            ref.steps_per_epoch)])


def test_train_batch_pool_is_checked():
    src = datasets.CIFARSource("cifar10", train_size=32)
    for pool in (0, 33):
        with pytest.raises(ValueError, match="sample pool"):
            src.train_batch(4, seed=0, pool=pool)
    assert datasets._check_pool(None, 32) == 32


def test_weak_scaling_restricts_the_pool(tmp_path):
    """Disk mode: with a quarter of the split, every drawn example comes
    from its first quarter."""
    _write_cifar(tmp_path, "cifar10", np.random.default_rng(5))
    src = datasets.CIFARSource("cifar10", data_dir=str(tmp_path))
    pipe = pipeline.DataPipeline(global_batch=4, source=src,
                                 weak_scaling_frac=0.25)
    assert pipe.sample_pool == 30 // 4 and pipe.epoch_size == 30 // 4
    pool = src._train_images[:pipe.sample_pool].reshape(pipe.sample_pool, -1)
    for img in pipe.batch_at(0, 0)["images"]:
        assert (pool == img.reshape(1, -1)).all(axis=1).any()
    with pytest.raises(ValueError, match="weak_scaling_frac"):
        pipeline.DataPipeline(global_batch=4, source=src,
                              weak_scaling_frac=0.0)


def test_cursor_contract():
    pipe = pipeline.DataPipeline(global_batch=4, seed=1, resolution=8,
                                 dataset=synthetic.DATASETS["cifar10"],
                                 epoch_size=12)
    assert pipe.steps_per_epoch == 3
    assert pipe.next_cursor(0, 0) == (0, 1)
    assert pipe.next_cursor(0, 2) == (1, 0)
    for bad in (-1, 3):
        with pytest.raises(IndexError, match="out of range"):
            pipe.batch_at(0, bad)
    assert len(list(pipe.batches(epoch=2, start=1))) == 2
    a, b = pipe.batch_at(0, 1), pipe.batch_at(1, 1)
    assert not np.array_equal(a["images"], b["images"])
    np.testing.assert_array_equal(a["images"], pipe.batch_at(0, 1)["images"])


def test_local_shard():
    pipe = pipeline.DataPipeline(global_batch=6, resolution=8,
                                 dataset=synthetic.DATASETS["cifar10"])
    batch = pipe.batch_at(0, 0)
    parts = [pipe.local_shard(batch, r, 3) for r in range(3)]
    np.testing.assert_array_equal(
        np.concatenate([p["labels"] for p in parts]), batch["labels"])
    assert parts[1]["images"].shape == (2, 8, 8, 3)
    with pytest.raises(ValueError, match="not divisible"):
        pipe.local_shard(batch, 0, 4)


def test_make_source():
    assert datasets.make_source("synthetic") is None
    src = datasets.make_source("cifar100", seed=3, train_size=10,
                               eval_size=5)
    assert src.name == "cifar100" and src.train_size == 10 and \
        src.eval_size == 5
