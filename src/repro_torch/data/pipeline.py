"""The host data pipeline: the cursor contract and the two-stage
prefetcher (``repro/data/pipeline.py``).

Batches are cursor-addressable: ``batch_at(epoch, index)`` is a pure
function of ``(seed, epoch, index)``, so the TrainState data cursor
``(epoch, batch_index)`` names an exact batch. Weak scaling (the paper's
§IV-A protocol) shrinks the epoch and restricts the sampled index pool.
``kind="token"`` is the LM stream (``make_token_batch``) behind the same
cursor contract. Batches are numpy on the host (uint8 images from a
dataset source: 4x fewer bytes to copy than fp32).

:class:`Prefetcher` (``DataPipeline.prefetch``) overlaps the host work
with the running step: a ``data-synth`` thread builds host batches and
rolls the cursor, a ``data-transfer`` thread moves them to the device,
each behind a ``depth``-deep queue. On a ``cuda`` device the transfer
copies every leaf into pinned host memory and starts a ``non_blocking``
copy on a side stream of that device, then records an event there; the
consumer's stream waits on the event before the step reads the batch. A
transient source error (``OSError``, the fault harness's
``TransientError``) is retried in the synthesis thread with
``DEFAULT_DATA_BACKOFF``; a persistent one reaches the consumer.

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
import queue
import struct
import threading
import warnings
import weakref
import zlib
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.synthetic import DatasetSpec, make_image_batch, \
    make_token_batch
from repro_torch.resilience import faults as _faults
from repro_torch.resilience.backoff import BackoffPolicy

# the synthesis stage's retry of transient source errors: a flaky read
# resolves behind the prefetch overlap, and the consumer sees only
# persistent failures
DEFAULT_DATA_BACKOFF = BackoffPolicy(max_attempts=3, base_delay=0.05,
                                     multiplier=2.0, max_delay=0.5,
                                     jitter=0.5)


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

    def prefetch(self, epoch: int = 0, index: int = 0, *, device="cuda",
                 depth: int = 2,
                 retry: Optional[BackoffPolicy] = DEFAULT_DATA_BACKOFF
                 ) -> "Prefetcher":
        """Background prefetcher onto ``device`` from cursor ``(epoch,
        index)`` (e.g. a restored state's), rolling epochs forever.
        ``depth`` bounds the batches in flight at each of its two stages;
        transient source errors are retried per ``retry`` (None: none)."""
        return Prefetcher(self, epoch, index, device=device, depth=depth,
                          retry=retry)

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



def pinned_copy(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """``x`` copied into pinned host memory, then to ``device`` without
    blocking the host, on the current stream of ``device``. Counts each
    copy in ``pinned_copy.copies`` (the host analogue of a kernel
    wrapper's launch counter)."""
    host = torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
    out = host.to(device, non_blocking=True)
    pinned_copy.copies += 1
    return out


pinned_copy.copies = 0


def transfer(batch: dict, device: torch.device, stream=None):
    """Move a host batch to ``device``: ``(tensors, event)``. On ``cuda``
    each leaf goes through :func:`pinned_copy` on ``stream``, and the
    returned event, recorded there after the last copy, marks the batch
    complete; on the CPU the leaves are wrapped as tensors and the event
    is None."""
    if device.type != "cuda":
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}, None
    with torch.cuda.stream(stream):
        out = {k: pinned_copy(v, device) for k, v in batch.items()}
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


class Prefetcher:
    """N-deep background batch prefetcher in two pipelined stages.

    Stage 1 (the ``data-synth`` thread) builds host batches and rolls the
    cursor; stage 2 (``data-transfer``) moves them to ``device``
    (:func:`transfer`: pinned copies on a side stream of ``device`` on
    ``cuda``). Each stage sits behind a ``depth``-deep queue, so the step
    consumes batch k while k+1 is copied and batches up to k+1+depth are
    built. ``next()`` yields ``(cursor, batch, next_cursor)``: the
    position of the yielded batch, and the cursor a checkpoint taken after
    the step that consumes it must record. Before it returns, the
    consumer's current stream waits on the batch's copy event and every
    tensor is recorded on that stream, so the caching allocator does not
    hand the memory back to the side stream while the step still reads
    it.

    It iterates forever (epochs roll); ``close()`` (or the context
    manager) stops both threads. Transient synthesis errors (``OSError``,
    the fault harness's ``TransientError`` included) are retried with
    ``retry``'s backoff, whose sleeps wait on the stop event; persistent
    errors, a failed pin or copy included, re-raise on the consumer as
    ``RuntimeError("data prefetch thread failed")``.

    Lifecycle: every producer-side ``put`` gives up once the consumer has
    closed, so a producer that fails on a full queue is never stranded.
    ``close()`` is idempotent, joins both threads and warns with the
    pending cursor when one outlives ``JOIN_TIMEOUT`` (a hung source).
    ``__next__`` after ``close()`` raises ``StopIteration``. The threads
    hold only a weak reference to the prefetcher, so dropping the last
    reference without ``close()`` still stops them through ``__del__``.
    """

    JOIN_TIMEOUT = 5.0

    def __init__(self, pipe: DataPipeline, epoch: int = 0, index: int = 0,
                 *, device="cuda", depth: int = 2,
                 retry: Optional[BackoffPolicy] = DEFAULT_DATA_BACKOFF):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1: {depth}")
        device = torch.device(device)
        stream = None
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "prefetch to 'cuda' requested but torch sees no GPU; "
                    "pass device='cpu' to prefetch to the CPU")
            # the current device is per thread: name the card explicitly,
            # and make the side stream here, on it
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            stream = torch.cuda.Stream(device=device)
        self.device = device
        self.depth = depth
        self._host_q: queue.Queue = queue.Queue(maxsize=depth)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        # the cursor the synthesis stage is producing (for close()'s
        # warning), a list so the thread needs no reference to self
        self._cursor_box = [int(epoch), int(index)]
        # the threads get a weak reference: a bound method would keep the
        # prefetcher alive from the thread's own frame, and __del__ could
        # never stop them
        ref = weakref.ref(self)
        self._synth_thread = threading.Thread(
            target=_synth_loop,
            args=(ref, pipe, self._host_q, self._stop, int(epoch),
                  int(index), retry, self._cursor_box),
            name="data-synth", daemon=True)
        self._xfer_thread = threading.Thread(
            target=_xfer_loop,
            args=(ref, self._host_q, self._q, self._stop, device, stream),
            name="data-transfer", daemon=True)
        self._threads = (self._synth_thread, self._xfer_thread)
        for t in self._threads:
            t.start()

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                kind, item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration("prefetcher closed")
                if not any(t.is_alive() for t in self._threads):
                    if self._error is not None:
                        raise RuntimeError(
                            "data prefetch thread failed") from self._error
                    raise StopIteration("prefetch thread exited")
        if kind == "error":
            raise RuntimeError("data prefetch thread failed") from item
        cursor, batch, nxt, event = item
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in batch.values():
                t.record_stream(current)
        return cursor, batch, nxt

    def _drain(self):
        for q in (self._host_q, self._q):
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

    def close(self):
        """Idempotent: stop both stages, unblock a pending put by
        draining, and join the threads; a thread still alive after
        ``JOIN_TIMEOUT`` is a hung producer, reported with its cursor."""
        self._stop.set()
        self._drain()
        for t in self._threads:
            t.join(timeout=self.JOIN_TIMEOUT)
        self._drain()       # anything put between the drain and the exit
        hung = [t.name for t in self._threads if t.is_alive()]
        if hung:
            warnings.warn(
                f"Prefetcher.close(): {', '.join(hung)} still alive "
                f"{self.JOIN_TIMEOUT:.0f}s after the join — the thread is "
                f"leaked (pending cursor (epoch {self._cursor_box[0]}, "
                f"batch {self._cursor_box[1]})); the data source or "
                f"device transfer is likely hung there",
                RuntimeWarning, stacklevel=2)

    def __del__(self):
        try:
            if not self._stop.is_set():
                self.close()
        except Exception:   # noqa: BLE001 — tolerant at interpreter exit
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _stop_aware_put(q: queue.Queue, stop: threading.Event, msg) -> bool:
    """Put that gives up (drops the message) once the consumer has
    closed, instead of blocking forever on a full queue."""
    while not stop.is_set():
        try:
            q.put(msg, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _deliver_error(ref, q, stop, exc):
    """Record the error on the owner (weakly) and hand it down the
    pipeline with a stop-aware put."""
    owner = ref()
    if owner is not None and owner._error is None:
        owner._error = exc
    del owner           # no strong reference while parked in the put
    _stop_aware_put(q, stop, ("error", exc))


def _synth_loop(ref, pipe: DataPipeline, host_q: queue.Queue,
                stop: threading.Event, epoch: int, index: int,
                retry: Optional[BackoffPolicy], cursor_box):
    """Stage 1: build host batches, roll the cursor, hand them on. The
    backoff sleeps wait on the stop event, so ``close()`` during a retry
    returns at once."""
    def fetch(e, i):
        if retry is None:
            return pipe.batch_at(e, i)
        return retry.retry(
            lambda: pipe.batch_at(e, i), retryable=(OSError,),
            sleep=lambda d: stop.wait(d),
            on_retry=lambda a, d, exc: print(
                f"[data] transient source error at ({e}, {i}) attempt "
                f"{a + 1} ({exc}); retrying in {d:.2f}s", flush=True))

    try:
        while not stop.is_set():
            cursor_box[0], cursor_box[1] = epoch, index
            batch = fetch(epoch, index)
            item = ((epoch, index), batch, pipe.next_cursor(epoch, index))
            if not _stop_aware_put(host_q, stop, ("ok", item)):
                return
            epoch, index = item[2]
    except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
        _deliver_error(ref, host_q, stop, e)


def _xfer_loop(ref, host_q: queue.Queue, dev_q: queue.Queue,
               stop: threading.Event, device: torch.device, stream):
    """Stage 2: move host batches to ``device`` (:func:`transfer`), so the
    copy of batch k+1 overlaps both the step on batch k and the synthesis
    of k+2."""
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)   # a new thread starts on cuda:0
        while not stop.is_set():
            try:
                kind, item = host_q.get(timeout=0.1)
            except queue.Empty:
                continue
            if kind == "error":
                # forward the synthesis failure and end the stage
                _stop_aware_put(dev_q, stop, ("error", item))
                return
            cursor, batch, nxt = item
            batch, event = transfer(batch, device, stream)
            if not _stop_aware_put(dev_q, stop,
                                   ("ok", (cursor, batch, nxt, event))):
                return
    except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
        _deliver_error(ref, dev_q, stop, e)
