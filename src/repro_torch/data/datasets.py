"""CIFAR-10/100 evaluation source (host side, numpy, uint8).

The eval half of ``repro.data.datasets``, byte-identical to it: images stay
uint8 at the native 32 px grid on the host, and the upsample to the model
resolution plus the normalisation run on the device
(``data/augment.py::device_preprocess``) from the source's :class:`Preproc`.

Two backing stores behind one interface:

- **Disk** (``data_dir`` holds the python-pickle batches): the test split
  of ``cifar-10-batches-py`` or ``cifar-100-python``. The directory must
  hold the train files too, as the reference requires, so the same
  ``--data-dir`` is accepted by both packages; the train split is read by
  the training slice, not here.
- **Procedural** (no ``data_dir``; never downloads): a fixed eval split
  drawn from ``default_rng((seed, 0xE7A1))`` through the class-conditional
  generator and quantised to uint8 through the inverse normalisation.

The final non-divisible eval batch is zero-padded to the static batch
shape with a ``mask`` leaf (1 = real example).
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


class CIFARSource:
    """CIFAR-10/100 eval split, uint8 at the native 32 px grid."""

    def __init__(self, name: str = "cifar10", *,
                 data_dir: Optional[str] = None, seed: int = 0,
                 resolution: Optional[int] = None,
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
            _, test_file, key = found
            ei, el = _load_split([test_file], key)
            self._eval_images = ei
            self._eval_labels = el.astype(np.int32)
            if eval_size:
                self._eval_images = self._eval_images[:eval_size]
                self._eval_labels = self._eval_labels[:eval_size]
        else:
            n_eval = eval_size or PROCEDURAL_EVAL_SIZE
            x, labels = class_conditional_images(
                self.spec, n_eval, np.random.default_rng((self.seed, 0xE7A1)),
                resolution=32)
            self._eval_images = quantize_images(x, self.mean, self.std)
            self._eval_labels = labels

    @property
    def preproc(self) -> Preproc:
        return Preproc(mean=self.mean, std=self.std,
                       native_resolution=self.native_resolution)

    @property
    def eval_size(self) -> int:
        return len(self._eval_labels)

    def eval_batches(self, batch: int) -> Iterator[dict]:
        """The test split in order, uint8 at the native grid, padded."""
        return padded_eval_batches(self._eval_images, self._eval_labels,
                                   batch)
