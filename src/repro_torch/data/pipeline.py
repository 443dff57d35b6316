"""The host data pipeline's cursor contract (``repro/data/pipeline.py``).

Batches are cursor-addressable: ``batch_at(epoch, index)`` is a pure
function of ``(seed, epoch, index)``, so the TrainState data cursor
``(epoch, batch_index)`` names an exact batch. Weak scaling (the paper's
§IV-A protocol) shrinks the epoch and restricts the sampled index pool.
Batches stay numpy on the host; the engine moves them to the device. The
two-stage ``Prefetcher`` is not ported yet, so a ``data`` fault raised at
``batch_at``'s fault site ends the attempt, as on the reference's
``--no-prefetch`` path.
``kind="token"`` is the LM stream (``make_token_batch``) behind the same
cursor contract.

Data parallelism: every rank builds the same global batch from the cursor,
splits it into the reference's global microbatches
(``split_microbatches``) and takes its contiguous rows of each
(:func:`rank_rows`). ``local_shard`` followed by
a split would average to the same gradient, but put other rows in each
microbatch, and so give augmentation (Mixup/CutMix pair rows within a
global microbatch) another stream.
"""
from __future__ import annotations

import math
import struct
import zlib
from typing import Iterator, Optional, Tuple

from repro_torch.data.synthetic import DatasetSpec, make_image_batch, \
    make_token_batch
from repro_torch.resilience import faults as _faults


def batch_seed(seed: int, epoch: int, i: int) -> int:
    """Stable 31-bit batch seed: crc32 over the packed tuple, the same in
    every process (Python's ``hash`` is salted per process)."""
    return zlib.crc32(struct.pack("<qqq", seed, epoch, i)) % (2 ** 31)


class DataPipeline:
    def __init__(self, *, global_batch: int, kind: str = "image",
                 seed: int = 0, dataset: Optional[DatasetSpec] = None,
                 vocab: int = 0, seq_len: int = 0,
                 resolution: Optional[int] = None,
                 weak_scaling_frac: float = 1.0, epoch_size: int = 0,
                 source=None):
        """``kind="image"``: batches from ``source`` (a :class:`CIFARSource`:
        uint8 at the native grid, from its train split) or, without one,
        the spec-shaped pre-normalised fp32 synthetic stream.
        ``kind="token"``: (global_batch, seq_len) int32 tokens below
        ``vocab``. ``weak_scaling_frac`` is the fraction of the split used:
        it shortens the epoch and restricts the pool batches sample from."""
        if kind not in ("image", "token"):
            raise ValueError(f"kind must be 'image' or 'token': {kind!r}")
        if source is not None and kind != "image":
            raise ValueError("dataset sources only back the image kind")
        if not 0.0 < weak_scaling_frac <= 1.0:
            raise ValueError(
                f"weak_scaling_frac must be in (0, 1]: {weak_scaling_frac}")
        self.kind = kind
        self.global_batch = global_batch
        self.seed = seed
        self.vocab = vocab
        self.seq_len = seq_len
        self.dataset = source.spec if source is not None else dataset
        self.source = source
        self.resolution = source.resolution if source is not None \
            else resolution
        n = epoch_size or (source.train_size if source is not None
                           else self.dataset.num_images
                           if self.dataset else 50_000)
        self.epoch_size = int(n * weak_scaling_frac)
        self.sample_pool = None
        if source is not None and weak_scaling_frac < 1.0:
            self.sample_pool = max(1, int(source.train_size
                                          * weak_scaling_frac))

    @property
    def steps_per_epoch(self) -> int:
        return max(1, math.floor(self.epoch_size / self.global_batch))

    def batch_at(self, epoch: int, index: int) -> dict:
        """The batch at data cursor ``(epoch, index)``, pure in
        ``(self.seed, epoch, index)``."""
        if not 0 <= index < self.steps_per_epoch:
            raise IndexError(
                f"batch_index {index} out of range for epoch of "
                f"{self.steps_per_epoch} steps")
        _faults.check("data", index)    # chaos harness (no-op in prod)
        seed = batch_seed(self.seed, epoch, index)
        if self.kind == "token":
            return make_token_batch(self.vocab, self.global_batch,
                                    self.seq_len, seed=seed)
        if self.source is not None:
            return self.source.train_batch(self.global_batch, seed=seed,
                                           pool=self.sample_pool)
        return make_image_batch(self.dataset, self.global_batch, seed=seed,
                                resolution=self.resolution)

    def next_cursor(self, epoch: int, index: int) -> Tuple[int, int]:
        """Cursor of the batch after ``(epoch, index)``; rolls the real
        epoch counter, so batch seeds never repeat across epochs."""
        index += 1
        if index >= self.steps_per_epoch:
            return epoch + 1, 0
        return epoch, index

    def batches(self, epoch: int = 0, start: int = 0) -> Iterator[dict]:
        for i in range(start, self.steps_per_epoch):
            yield self.batch_at(epoch, i)

    def local_shard(self, batch: dict, rank: int, world: int) -> dict:
        """The per-process slice of a global batch; a batch the world does
        not divide raises instead of being truncated."""
        def slc(x):
            if x.shape[0] % world:
                raise ValueError(
                    f"global batch dimension {x.shape[0]} not divisible "
                    f"by world size {world}; the remainder would be "
                    f"silently dropped")
            per = x.shape[0] // world
            return x[rank * per:(rank + 1) * per]
        return {k: slc(v) for k, v in batch.items()}


def rank_rows(n: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s contiguous rows of a global microbatch of ``n``
    rows: ``[rank * n / world, (rank + 1) * n / world)``. A microbatch the
    world does not divide raises."""
    if n % world:
        raise ValueError(
            f"global microbatch of {n} rows not divisible by world size "
            f"{world}: DeepSpeed's train_batch_size = micro_batch_per_gpu * "
            f"gradient_accumulation_steps * dp_world is violated")
    per = n // world
    return slice(rank * per, (rank + 1) * per)

