"""CIFAR-10/100 train and test sources (host side, numpy, uint8).

``repro.data.datasets``, byte-identical to it: images stay uint8 at the
native 32 px grid on the host, and the upsample to the model resolution
plus the normalisation run on the device
(``data/augment.py::device_preprocess``) from the source's :class:`Preproc`.

Two backing stores behind one interface:

- **Disk** (``data_dir`` holds the python-pickle batches): the train and
  test splits of ``cifar-10-batches-py`` or ``cifar-100-python``, loaded
  once as raw uint8.
- **Procedural** (no ``data_dir``; never downloads): train batches are
  pure in the batch seed (the class-conditional generator, quantised to
  uint8 through the inverse normalisation); the eval split is fixed, drawn
  from ``default_rng((seed, 0xE7A1))``.

``train_batch(batch, seed=...)`` is pure in ``seed`` (the pipeline derives
it from the data cursor), and ``pool`` restricts the sampled index pool for
weak scaling. The final non-divisible eval batch is zero-padded to the
static batch shape with a ``mask`` leaf (1 = real example).
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from repro_torch.data.synthetic import DATASETS, DatasetSpec, \
    class_conditional_images

# canonical per-channel statistics (pytorch-image-models conventions)
CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2470, 0.2435, 0.2616)
CIFAR100_MEAN = (0.5071, 0.4865, 0.4409)
CIFAR100_STD = (0.2673, 0.2564, 0.2762)

_STATS = {"cifar10": (CIFAR10_MEAN, CIFAR10_STD),
          "cifar100": (CIFAR100_MEAN, CIFAR100_STD)}

PROCEDURAL_EVAL_SIZE = 500
PROCEDURAL_TRAIN_SIZE = 4096


@dataclass(frozen=True)
class Preproc:
    """What the device needs to finish a uint8 batch: the normalisation
    statistics and the native pixel grid the images are stored at."""
    mean: tuple
    std: tuple
    native_resolution: int


def _pickle_load(path: str) -> dict:
    # only the CIFAR distribution files the user points --data-dir at
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    return {k.decode() if isinstance(k, bytes) else k: v
            for k, v in d.items()}


def _find_cifar_files(name: str, data_dir: str):
    """(train_files, test_file, label_key) under ``data_dir`` or the
    subdirectory the archive unpacks into; None when absent."""
    sub = "cifar-10-batches-py" if name == "cifar10" else "cifar-100-python"
    for root in (os.path.join(data_dir, sub), data_dir):
        if name == "cifar10":
            train = [os.path.join(root, f"data_batch_{i}")
                     for i in range(1, 6)]
            test = os.path.join(root, "test_batch")
            key = "labels"
        else:
            train = [os.path.join(root, "train")]
            test = os.path.join(root, "test")
            key = "fine_labels"
        if all(os.path.isfile(p) for p in train) and os.path.isfile(test):
            return train, test, key
    return None


def _load_split(files, label_key: str):
    imgs, labels = [], []
    for path in files:
        d = _pickle_load(path)
        data = np.asarray(d["data"], np.uint8)
        # (N, 3072) row-major CHW -> (N, 32, 32, 3) HWC
        imgs.append(data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        labels.append(np.asarray(d[label_key], np.int64))
    return np.concatenate(imgs), np.concatenate(labels)


def normalize_images(u8, mean, std):
    """uint8 HWC -> float32 ``(x/255 - mean) / std``: the host-side oracle
    for the device's fused normalise."""
    x = np.asarray(u8, np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) \
        / np.asarray(std, np.float32)


def quantize_images(x, mean, std):
    """Inverse of :func:`normalize_images`: normalised fp32 -> uint8."""
    u = (np.asarray(x, np.float32) * np.asarray(std, np.float32)
         + np.asarray(mean, np.float32)) * 255.0
    return np.clip(np.rint(u), 0, 255).astype(np.uint8)


def padded_eval_batches(images: np.ndarray, labels: np.ndarray,
                        batch: int) -> Iterator[dict]:
    """Iterate a finite split in order at one static batch shape; the last
    non-divisible batch is zero-padded and its ``mask`` is 0 there."""
    n = len(labels)
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        m = hi - lo
        img = images[lo:hi]
        lab = labels[lo:hi]
        mask = np.ones((batch,), np.float32)
        if m < batch:
            pad = batch - m
            img = np.concatenate(
                [img, np.zeros((pad,) + img.shape[1:], img.dtype)])
            lab = np.concatenate([lab, np.zeros((pad,), lab.dtype)])
            mask[m:] = 0.0
        yield {"images": img, "labels": lab, "mask": mask}


def _check_pool(pool: Optional[int], size: int) -> int:
    if pool is None:
        return size
    if not 0 < pool <= size:
        raise ValueError(
            f"sample pool {pool} out of range for a split of {size} "
            f"examples")
    return pool


class CIFARSource:
    """CIFAR-10/100 train and test splits, uint8 at the native 32 px grid."""

    def __init__(self, name: str = "cifar10", *,
                 data_dir: Optional[str] = None, seed: int = 0,
                 resolution: Optional[int] = None,
                 train_size: Optional[int] = None,
                 eval_size: Optional[int] = None):
        if name not in _STATS:
            raise ValueError(f"unknown CIFAR dataset {name!r}; "
                             f"expected one of {sorted(_STATS)}")
        self.spec: DatasetSpec = DATASETS[name]
        self.name = name
        self.seed = seed
        self.native_resolution = 32
        self.resolution = resolution or self.spec.resolution
        if self.resolution % self.native_resolution:
            raise ValueError(
                f"model resolution {self.resolution} not an integer "
                f"multiple of the native {self.native_resolution}px "
                f"CIFAR grid")
        self.mean, self.std = _STATS[name]

        found = _find_cifar_files(name, data_dir) if data_dir else None
        if data_dir and found is None:
            # an explicit data_dir without the batches is a user error,
            # never a quiet switch to procedural data
            sub = "cifar-10-batches-py" if name == "cifar10" \
                else "cifar-100-python"
            raise FileNotFoundError(
                f"--data-dir {data_dir!r} does not contain the {name} "
                f"pickle batches (expected {sub}/ there or the batch "
                f"files directly); unset it to use the procedural "
                f"generator")
        self.procedural = found is None
        if found is not None:
            train_files, test_file, key = found
            ti, tl = _load_split(train_files, key)
            ei, el = _load_split([test_file], key)
            self._train_images = ti[:train_size or None]
            self._train_labels = tl.astype(np.int32)[:train_size or None]
            self._eval_images = ei[:eval_size or None]
            self._eval_labels = el.astype(np.int32)[:eval_size or None]
        else:
            self._train_images = self._train_labels = None
            self._train_size = train_size or PROCEDURAL_TRAIN_SIZE
            self._eval_images, self._eval_labels = self._procedural_examples(
                np.random.default_rng((self.seed, 0xE7A1)),
                eval_size or PROCEDURAL_EVAL_SIZE)

    def _procedural_examples(self, rng: np.random.Generator, n: int):
        """Class-conditional uint8 images at the native 32 px grid."""
        x, labels = class_conditional_images(self.spec, n, rng,
                                             resolution=32)
        return quantize_images(x, self.mean, self.std), labels

    @property
    def preproc(self) -> Preproc:
        return Preproc(mean=self.mean, std=self.std,
                       native_resolution=self.native_resolution)

    @property
    def train_size(self) -> int:
        if self.procedural:
            return self._train_size
        return len(self._train_labels)

    def train_batch(self, batch: int, *, seed: int,
                    pool: Optional[int] = None) -> dict:
        """One un-augmented uint8 train batch, pure in ``seed``: disk mode
        draws a with-replacement sample of the first ``pool`` examples,
        procedural mode synthesises the batch from the seed (``pool`` only
        validates there). The draw order is the reference's
        (``datasets.py:289-312``)."""
        rng = np.random.default_rng(seed)
        _check_pool(pool, self.train_size)
        if self.procedural:
            images, labels = self._procedural_examples(rng, batch)
        else:
            idx = rng.integers(0, pool or len(self._train_labels), (batch,))
            images, labels = self._train_images[idx], self._train_labels[idx]
        return {"images": images, "labels": labels}

    @property
    def eval_size(self) -> int:
        return len(self._eval_labels)

    def eval_batches(self, batch: int) -> Iterator[dict]:
        """The test split in order, uint8 at the native grid, padded."""
        return padded_eval_batches(self._eval_images, self._eval_labels,
                                   batch)


def make_source(dataset: str, *, data_dir: Optional[str] = None,
                seed: int = 0, resolution: Optional[int] = None,
                train_size: Optional[int] = None,
                eval_size: Optional[int] = None,
                shard_dir: Optional[str] = None):
    """``None`` for the synthetic fp32 stream, a :class:`CIFARSource`
    otherwise (the switch ``launch/train.py`` flips on ``--dataset``).
    ``shard_dir`` takes precedence: it names a shard directory
    (``data/streaming.py``) and returns a ``ShardedSource``, which streams
    shards instead of holding a split in RAM."""
    if shard_dir:
        from repro_torch.data.streaming import ShardedSource
        return ShardedSource(shard_dir, seed=seed, resolution=resolution,
                             train_size=train_size, eval_size=eval_size)
    if dataset == "synthetic":
        return None
    return CIFARSource(dataset, data_dir=data_dir, seed=seed,
                       resolution=resolution, train_size=train_size,
                       eval_size=eval_size)
