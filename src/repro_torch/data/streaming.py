"""Sharded streaming dataset source (``repro/data/streaming.py``):
npz shards behind the ``batch_at(epoch, index)`` cursor contract.

An in-RAM :class:`~repro_torch.data.datasets.CIFARSource` stops scaling at
ImageNet-class inputs. This module stores a dataset as a directory of
fixed-size **uint8 npz shards** plus a JSON manifest and serves batches by
global example index through a small LRU shard cache, so resident memory
is ``cache_shards * shard_size`` examples whatever the dataset's size.
The format is the reference's ``repro-shards/v1``: a directory written by
either package reads in the other and yields the same batches.

Layout (``shards.json`` + ``{split}-{NNNNN}.npz``)::

    shards.json                 manifest: schema tag, dataset identity,
                                normalisation stats, per-split shard
                                names and sizes (the global index -> shard
                                map is the running sum of the sizes)
    train-00000.npz ...         images (N, r, r, 3) uint8, labels (N,) i32
    eval-00000.npz ...

Determinism: ``train_batch(batch, seed=...)`` draws global indices from
``default_rng(seed)`` as the in-RAM disk source does, so a batch is pure in
``seed`` and does not depend on the shard geometry: the same examples
re-sharded at another ``shard_size`` replay the same stream.

``python -m repro_torch.data.streaming --out DIR ...`` writes a shard set
from a :class:`CIFARSource` (procedural unless ``--data-dir`` holds the
real pickles).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from collections import OrderedDict
from typing import Iterator, Optional

import numpy as np

from repro_torch.data.datasets import CIFARSource, Preproc, _check_pool, \
    padded_eval_batches
from repro_torch.data.synthetic import DATASETS, DatasetSpec

SCHEMA = "repro-shards/v1"
MANIFEST = "shards.json"
DEFAULT_SHARD_SIZE = 1024


def _write_split(out_dir: str, split: str, images: np.ndarray,
                 labels: np.ndarray, shard_size: int):
    names, sizes = [], []
    for i, lo in enumerate(range(0, len(labels), shard_size)):
        hi = min(lo + shard_size, len(labels))
        name = f"{split}-{i:05d}.npz"
        np.savez(os.path.join(out_dir, name),
                 images=np.ascontiguousarray(images[lo:hi], np.uint8),
                 labels=np.asarray(labels[lo:hi], np.int32))
        names.append(name)
        sizes.append(hi - lo)
    return {"shards": names, "sizes": sizes, "total": int(len(labels))}


def write_shards(out_dir: str, source: CIFARSource, *,
                 shard_size: int = DEFAULT_SHARD_SIZE) -> dict:
    """Write a CIFARSource's splits as a shard directory; returns the
    manifest. A procedural source has no stored train split: it is drawn
    once here from ``default_rng((seed, 0x5A4D))``, so two writers with
    the same seed write the same examples."""
    if shard_size < 1:
        raise ValueError(f"shard_size must be >= 1: {shard_size}")
    os.makedirs(out_dir, exist_ok=True)
    if source.procedural:
        rng = np.random.default_rng((source.seed, 0x5A4D))
        train_images, train_labels = source._procedural_examples(
            rng, source.train_size)
    else:
        train_images = source._train_images
        train_labels = source._train_labels
    manifest = {
        "schema": SCHEMA,
        "dataset": source.name,
        "num_classes": source.spec.num_classes,
        "resolution": source.native_resolution,
        "mean": list(source.mean),
        "std": list(source.std),
        "splits": {
            "train": _write_split(out_dir, "train", train_images,
                                  train_labels, shard_size),
            "eval": _write_split(out_dir, "eval", source._eval_images,
                                 source._eval_labels, shard_size),
        },
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ShardedSource:
    """A shard directory as a data source with ``CIFARSource``'s interface
    (``train_batch``/``eval_batches``/``preproc``/``spec``/sizes), so the
    pipeline, the engine and the eval loop run on it unchanged.

    Shards load lazily through an LRU cache of ``cache_shards`` entries; a
    gathered batch groups its indices by shard and loads each touched
    shard once. ``shard_loads`` counts the loads (cache misses), for the
    read amplification of a with-replacement batch.
    """

    def __init__(self, shard_dir: str, *, seed: int = 0,
                 resolution: Optional[int] = None,
                 train_size: Optional[int] = None,
                 eval_size: Optional[int] = None, cache_shards: int = 4):
        path = os.path.join(shard_dir, MANIFEST)
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"--shard-dir {shard_dir!r} has no {MANIFEST}; write one "
                f"with `python -m repro_torch.data.streaming --out "
                f"{shard_dir}`")
        with open(path) as f:
            m = json.load(f)
        if m.get("schema") != SCHEMA:
            raise ValueError(
                f"unsupported shard manifest schema {m.get('schema')!r} "
                f"in {path} (expected {SCHEMA!r})")
        self.dir = shard_dir
        self.name = m["dataset"]
        self.seed = seed
        self.spec: DatasetSpec = DATASETS.get(
            self.name,
            DatasetSpec(self.name, m["num_classes"], 0, m["resolution"]))
        self.native_resolution = int(m["resolution"])
        self.resolution = resolution or max(self.spec.resolution,
                                            self.native_resolution)
        if self.resolution % self.native_resolution:
            raise ValueError(
                f"model resolution {self.resolution} not an integer "
                f"multiple of the native {self.native_resolution}px grid")
        self.mean = tuple(m["mean"])
        self.std = tuple(m["std"])
        self.procedural = False
        self._splits = m["splits"]
        # start offset of each shard: the exclusive running sum of sizes
        self._starts = {
            split: np.concatenate(
                [[0], np.cumsum(s["sizes"])[:-1]]).astype(np.int64)
            for split, s in self._splits.items()}
        self.train_size = min(train_size or self._splits["train"]["total"],
                              self._splits["train"]["total"])
        self.eval_size = min(eval_size or self._splits["eval"]["total"],
                             self._splits["eval"]["total"])
        self._cache: OrderedDict = OrderedDict()
        self._cache_shards = max(1, cache_shards)
        self.shard_loads = 0

    @property
    def preproc(self) -> Preproc:
        return Preproc(mean=self.mean, std=self.std,
                       native_resolution=self.native_resolution)

    def _shard(self, split: str, i: int):
        key = (split, i)
        if key in self._cache:
            self._cache.move_to_end(key)
            return self._cache[key]
        name = self._splits[split]["shards"][i]
        with np.load(os.path.join(self.dir, name)) as z:
            pair = (np.asarray(z["images"], np.uint8),
                    np.asarray(z["labels"], np.int32))
        self.shard_loads += 1
        self._cache[key] = pair
        if len(self._cache) > self._cache_shards:
            self._cache.popitem(last=False)
        return pair

    def _gather(self, split: str, idx: np.ndarray):
        """Examples at global indices ``idx``, in that order, loading each
        touched shard once."""
        idx = np.asarray(idx, np.int64)
        starts = self._starts[split]
        sid = np.searchsorted(starts, idx, side="right") - 1
        r = self.native_resolution
        images = np.empty((len(idx), r, r, 3), np.uint8)
        labels = np.empty((len(idx),), np.int32)
        for s in np.unique(sid):
            imgs, labs = self._shard(split, int(s))
            sel = sid == s
            local = idx[sel] - starts[s]
            images[sel] = imgs[local]
            labels[sel] = labs[local]
        return images, labels

    def train_batch(self, batch: int, *, seed: int,
                    pool: Optional[int] = None) -> dict:
        """Pure in ``seed`` and independent of the shard geometry: indices
        are drawn over the global example range, as the in-RAM disk source
        draws them, then resolved through the shard map. ``pool``
        restricts the sampled range (§IV-A weak scaling)."""
        rng = np.random.default_rng(seed)
        limit = _check_pool(pool, self.train_size)
        idx = rng.integers(0, limit, (batch,))
        images, labels = self._gather("train", idx)
        return {"images": images, "labels": labels}

    def eval_batches(self, batch: int) -> Iterator[dict]:
        """The eval split in order at one static padded batch shape, one
        gathered chunk per batch, so only the shards under the current
        window are resident."""
        for lo in range(0, self.eval_size, batch):
            hi = min(lo + batch, self.eval_size)
            images, labels = self._gather("eval", np.arange(lo, hi))
            yield from padded_eval_batches(images, labels, batch)

    def num_eval_batches(self, batch: int) -> int:
        return -(-self.eval_size // batch)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="write a repro-shards/v1 shard directory from a "
                    "CIFAR source (procedural unless --data-dir holds "
                    "the real pickles)")
    ap.add_argument("--out", required=True, help="shard directory to write")
    ap.add_argument("--dataset", default="cifar10",
                    choices=["cifar10", "cifar100"])
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-size", type=int, default=None)
    ap.add_argument("--eval-size", type=int, default=None)
    ap.add_argument("--shard-size", type=int, default=DEFAULT_SHARD_SIZE)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    src = CIFARSource(args.dataset, data_dir=args.data_dir, seed=args.seed,
                      train_size=args.train_size, eval_size=args.eval_size)
    m = write_shards(args.out, src, shard_size=args.shard_size)
    tr, ev = m["splits"]["train"], m["splits"]["eval"]
    print(f"wrote {args.out}: {len(tr['shards'])} train shards "
          f"({tr['total']} examples) + {len(ev['shards'])} eval shards "
          f"({ev['total']} examples), shard_size={args.shard_size} in "
          f"{time.perf_counter() - t0:.2f}s")
    return m


if __name__ == "__main__":
    main()
