"""Port parity for the sharded streaming source
(``repro_torch.data.streaming``): the reference's streaming tests
(``tests/test_streaming.py``) on the port; the shard directories of both
packages hold equal arrays and manifests and read the same batches through
either package's ``ShardedSource``; and ``--shard-dir`` in the CLI."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import json  # noqa: E402
import os  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.data.datasets import CIFARSource, make_source  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.data.streaming import MANIFEST, SCHEMA, ShardedSource, \
    main as streaming_main, write_shards  # noqa: E402

SEED = 11
TRAIN, EVAL, SHARD = 300, 90, 64


def _source():
    return CIFARSource("cifar10", seed=SEED, train_size=TRAIN,
                       eval_size=EVAL)


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("shards"))
    write_shards(d, _source(), shard_size=SHARD)
    return d


@pytest.fixture(scope="module")
def ref_shard_dir(tmp_path_factory):
    from repro.data import datasets as ref_datasets
    from repro.data.streaming import write_shards as ref_write
    d = str(tmp_path_factory.mktemp("ref_shards"))
    ref_write(d, ref_datasets.CIFARSource("cifar10", seed=SEED,
                                          train_size=TRAIN, eval_size=EVAL),
              shard_size=SHARD)
    return d


# --- the reference's streaming tests, on the port ---------------------------

def test_manifest_and_shard_layout(shard_dir):
    with open(os.path.join(shard_dir, MANIFEST)) as f:
        m = json.load(f)
    assert m["schema"] == SCHEMA == "repro-shards/v1"
    tr = m["splits"]["train"]
    assert tr["total"] == TRAIN
    assert tr["sizes"] == [64, 64, 64, 64, 44]      # 300 over 64-shards
    for name in tr["shards"]:
        with np.load(os.path.join(shard_dir, name)) as z:
            assert z["images"].dtype == np.uint8
            assert z["images"].shape[1:] == (32, 32, 3)
            assert z["labels"].dtype == np.int32
    ss = ShardedSource(shard_dir, seed=SEED)
    assert ss.train_size == TRAIN and ss.eval_size == EVAL
    assert ss.preproc == _source().preproc


def test_rebuilt_source_replays_identical_stream_across_shards(shard_dir):
    """A pipeline over a fresh ShardedSource (cold cache) replays the same
    batches at every cursor; a batch of 128 over shards of 64 always
    gathers across a shard boundary."""
    def mk():
        return DataPipeline(global_batch=128, seed=5,
                            source=ShardedSource(shard_dir, seed=5))
    p1, p2 = mk(), mk()
    assert p1.steps_per_epoch == TRAIN // 128
    for e, i in ((0, 0), (0, 1), (3, 0)):
        a, b = p1.batch_at(e, i), p2.batch_at(e, i)
        np.testing.assert_array_equal(a["images"], b["images"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
    assert not np.array_equal(p1.batch_at(0, 0)["images"],
                              p1.batch_at(0, 1)["images"])


def test_stream_invariant_to_shard_geometry(shard_dir, tmp_path):
    other = str(tmp_path / "resharded")
    write_shards(other, _source(), shard_size=37)
    a = ShardedSource(shard_dir).train_batch(64, seed=99)
    b = ShardedSource(other).train_batch(64, seed=99)
    np.testing.assert_array_equal(a["images"], b["images"])
    np.testing.assert_array_equal(a["labels"], b["labels"])
    # ...and equal to the in-RAM examples the shards were written from
    src = _source()
    idx = np.random.default_rng(99).integers(0, TRAIN, (64,))
    imgs, labs = src._procedural_examples(
        np.random.default_rng((SEED, 0x5A4D)), TRAIN)
    np.testing.assert_array_equal(a["images"], imgs[idx])
    np.testing.assert_array_equal(a["labels"], labs[idx])


def test_eval_batches_cross_shards_with_padding(shard_dir):
    ss = ShardedSource(shard_dir)
    batches = list(ss.eval_batches(64))
    assert len(batches) == 2 == ss.num_eval_batches(64)
    for b in batches:
        assert b["images"].shape == (64, 32, 32, 3)
        assert b["images"].dtype == np.uint8
    np.testing.assert_array_equal(batches[0]["mask"], np.ones(64))
    assert batches[1]["mask"].sum() == EVAL - 64
    assert np.all(batches[1]["images"][EVAL - 64:] == 0)
    got = np.concatenate([b["labels"][b["mask"] > 0] for b in batches])
    np.testing.assert_array_equal(got, _source()._eval_labels)


def test_train_size_bound_and_weak_scaling_pool(shard_dir):
    ss = ShardedSource(shard_dir, train_size=100)
    assert ss.train_size == 100
    b = ss.train_batch(32, seed=7, pool=SHARD)
    # pool 64 is the first shard: every drawn example lives there
    with np.load(os.path.join(shard_dir, "train-00000.npz")) as z:
        first = z["images"]
    for img in b["images"]:
        assert any(np.array_equal(img, a) for a in first)
    assert ss.shard_loads == 1
    with pytest.raises(ValueError, match="out of range"):
        ss.train_batch(4, seed=0, pool=101)


def test_missing_or_bad_manifest_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="shards.json"):
        ShardedSource(str(tmp_path))
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / MANIFEST).write_text(json.dumps({"schema": "other/v9"}))
    with pytest.raises(ValueError, match="unsupported shard manifest"):
        ShardedSource(str(bad))


def test_non_multiple_resolution_rejected(shard_dir):
    with pytest.raises(ValueError, match="not an integer multiple"):
        ShardedSource(shard_dir, resolution=48)


# --- across the two packages ---------------------------------------------

def _arrays(d):
    with open(os.path.join(d, MANIFEST)) as f:
        m = json.load(f)
    out = {}
    for split in m["splits"].values():
        for name in split["shards"]:
            with np.load(os.path.join(d, name)) as z:
                out[name] = {k: z[k] for k in z.files}
    return m, out


def test_both_writers_write_equal_arrays_and_manifests(shard_dir,
                                                       ref_shard_dir):
    m, arrays = _arrays(shard_dir)
    ref_m, ref_arrays = _arrays(ref_shard_dir)
    assert m == ref_m
    assert arrays.keys() == ref_arrays.keys()
    for name, leaves in ref_arrays.items():
        for key, want in leaves.items():
            got = arrays[name][key]
            assert got.dtype == want.dtype and got.tobytes() == \
                want.tobytes(), (name, key)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_either_directory_reads_the_same_in_both_packages(
        writer, shard_dir, ref_shard_dir):
    from repro.data import pipeline as ref_pipeline
    from repro.data.streaming import ShardedSource as RefSharded
    d = shard_dir if writer == "port" else ref_shard_dir
    port = DataPipeline(global_batch=96, seed=4,
                        source=ShardedSource(d, seed=4))
    ref = ref_pipeline.DataPipeline(kind="image", global_batch=96, seed=4,
                                    source=RefSharded(d, seed=4))
    for cursor in ((0, 0), (0, 2), (5, 1)):
        got, want = port.batch_at(*cursor), ref.batch_at(*cursor)
        for key in want:
            assert got[key].dtype == want[key].dtype
            assert got[key].tobytes() == want[key].tobytes(), key
    got = list(ShardedSource(d).eval_batches(32))
    want = list(RefSharded(d).eval_batches(32))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            assert g[key].tobytes() == w[key].tobytes(), key


def test_make_source_prefers_the_shard_dir(shard_dir):
    src = make_source("synthetic", shard_dir=shard_dir, seed=SEED)
    assert isinstance(src, ShardedSource) and src.train_size == TRAIN
    assert make_source("synthetic") is None


def test_streaming_cli_writes_a_shard_directory(tmp_path, capsys):
    m = streaming_main(["--out", str(tmp_path), "--train-size", "70",
                        "--eval-size", "20", "--shard-size", "32"])
    assert "wrote" in capsys.readouterr().out
    assert m["splits"]["train"]["sizes"] == [32, 32, 6]
    assert ShardedSource(str(tmp_path)).eval_size == 20


def test_shard_dir_in_the_cli(shard_dir, capsys):
    from repro_torch.launch import train as cli
    rows = cli.main(["--smoke", "--steps", "3", "--batch", "8",
                     "--log-every", "1", "--eval-every", "3",
                     "--eval-batch", "32", "--seed", str(SEED),
                     "--shard-dir", shard_dir, "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"[train] dataset=cifar10 shards train={TRAIN} eval={EVAL}" in out
    train = [r for r in rows if "loss" in r]
    assert [r["step"] for r in train] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and r["step_ok"] == 1 for r in train)
    assert rows[-1]["eval_count"] == EVAL
    # the same stream with and without the prefetcher
    again = cli.main(["--smoke", "--steps", "3", "--batch", "8",
                      "--log-every", "1", "--seed", str(SEED),
                      "--shard-dir", shard_dir, "--device", "cpu",
                      "--no-prefetch"])
    assert [r["loss"] for r in again] == [r["loss"] for r in train]
