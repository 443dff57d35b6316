"""Elastic sharded checkpointing in the reference's format
``repro-elastic-ckpt/v2`` (``repro/checkpoint/checkpoint.py``), byte for
byte: a step saved by the JAX package restores here, and a step saved
here restores, and verifies, there.

One directory per step, committed by a single atomic rename performed by
process 0:

    step_00000010/
      manifest.json        merged manifest: union of every process's shards
      manifest-p00.json    process 0's per-process manifest (kept for audit)
      manifest-p01.json    process 1's per-process manifest
      shards-p00.npz       process 0's shards (raw bytes, one uint8 member
      shards-p01.npz       each, crc32 in the manifest)

A tree is a dict (nested dicts flatten to ``/``-joined keys, as the
reference's pytree paths do) whose leaves are:

* :class:`Sharded` — this process's chunk of a leaf that the data-parallel
  ranks split into equal contiguous chunks along one dimension (rank r of
  W holds chunk r, ``NamedSharding``'s layout over a ``data`` axis): the
  process writes that chunk, with its ``[start, stop)`` index ranges,
  ``spec`` (``"data"`` at the split dimension) and ``mesh`` ``{"data": W,
  "model": 1}``;
* :class:`Blocks` — this process's blocks of a leaf laid out over a data x
  pipe mesh (pipeline parallelism: a stage holds its chunks' layers, each
  perhaps split over its data group), each written with its own index
  ranges; a process whose blocks another one writes passes none;
* a ``torch.Tensor`` — a replicated leaf, written by process 0 only;
* a numpy array or scalar — a host leaf (step counters, rng), written by
  process 0 only.

A process is a rank of the default process group (``torch.distributed``),
or process 0 of 1 without one; :func:`simulate_processes` overrides both
for tests. bf16 leaves go as raw bytes, as the reference writes them, and
dtypes are named as numpy (and ``ml_dtypes``) name them; the port keeps its
own name table, so it needs no ``ml_dtypes``.

Commit protocol (the merge barrier), over the shared filesystem and no
collective:

1. every process stages into its own private ``step_N.tmp-pNN/`` dir —
   shard npz first, then ``manifest-pNN.json`` written atomically LAST, so
   the per-process manifest's presence marks that stage as complete;
2. process 0 waits (bounded by ``MERGE_BARRIER_TIMEOUT``; raises
   :class:`CheckpointBarrierTimeout` naming the stragglers) until all
   ``processes`` per-process manifests exist;
3. process 0 merges them (:func:`merge_manifests`), validating that every
   leaf's shard union covers its logical element count EXACTLY — the
   ``saved_bytes == logical_bytes`` invariant;
4. process 0 moves every stage's files into ``step_N.tmp``, writes the
   merged ``manifest.json``, and performs the ONE ``os.rename`` commit.

Restore is **elastic and lazy**: ``shardings`` names, for each leaf, the
dimension the restoring layout splits over the ranks (or None: whole), or
the list of blocks (index ranges) this process holds, stacked along the
leading dimension (a pipeline stage's chunks), and
each process assembles only its own block from the manifest shards whose
index ranges INTERSECT it — at any world size and ZeRO stage, whatever
layout wrote the step. :func:`last_restore_stats` reports the bytes read.
Template mismatches are never tolerated: missing/unexpected leaf paths
raise ``KeyError``, shape/dtype mismatches ``ValueError``.

Hardened IO as the reference's: crc32 per shard checked on every read
(:class:`CheckpointCorruptError`), save IO retried with jittered backoff
(`repro_torch.resilience.backoff`), npz handles closed deterministically,
:func:`restore_latest_valid` falling back past torn or corrupt steps, and
:func:`gc_checkpoints` never deleting the newest valid step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import threading
import time
import zlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.resilience import faults as _faults
from repro_torch.resilience.backoff import BackoffPolicy

FORMAT = "repro-elastic-ckpt/v2"
LEGACY_FORMATS = ("repro-elastic-ckpt/v1",)

# save-side IO retry: a handful of quick attempts — a checkpoint that
# cannot land within this budget is a real outage, not a blip
DEFAULT_IO_BACKOFF = BackoffPolicy(max_attempts=4, base_delay=0.05,
                                   multiplier=2.0, max_delay=1.0,
                                   jitter=0.5)

# merge barrier: how long process 0 waits for every per-process manifest
# before declaring the save torn (module attribute so tests can tighten it)
MERGE_BARRIER_TIMEOUT = 120.0
_BARRIER_POLL = 0.05


class CheckpointCorruptError(ValueError):
    """Checkpoint bytes fail verification (checksum mismatch, unreadable
    shard file, missing manifest) — the restore-fallback trigger."""


class CheckpointBarrierTimeout(RuntimeError):
    """Process 0 gave up waiting for another process's per-process
    manifest at the merge barrier. Deliberately NOT an OSError: the
    save-side IO retry must not re-run a full barrier wait."""


@dataclasses.dataclass(frozen=True)
class Sharded:
    """This process's chunk ``local`` of a leaf split over the ranks into
    equal contiguous chunks along ``dim``."""
    local: torch.Tensor
    dim: int


@dataclasses.dataclass(frozen=True)
class Blocks:
    """This process's blocks of a leaf of logical ``shape`` and ``dtype``:
    ``parts`` ``[(ranges, tensor)]``, each tensor the block at its ``[start,
    stop)`` index ranges (empty where another process writes the leaf).
    ``spec`` (the mesh axis of each dimension, or None) and ``mesh``
    (``{axis: extent}``) go into the manifest as they are."""
    shape: tuple
    dtype: torch.dtype
    parts: tuple
    spec: tuple
    mesh: dict


# ---------------------------------------------------------------------------
# dtypes: numpy's names (bfloat16 as ml_dtypes names it), no ml_dtypes
# ---------------------------------------------------------------------------

_TORCH = {"float32": torch.float32, "float64": torch.float64,
          "float16": torch.float16, "bfloat16": torch.bfloat16,
          "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
          "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}
_NAMES = {v: k for k, v in _TORCH.items()}


def _dtype_name(dtype) -> str:
    """The manifest's name of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _NAMES:
            raise ValueError(f"no checkpoint dtype name for {dtype}")
        return _NAMES[dtype]
    return np.dtype(dtype).name


def _carrier(name: str) -> np.dtype:
    """The numpy dtype that holds a leaf's bytes: its own, or int16 for
    bfloat16 (which numpy lacks)."""
    return np.dtype(np.int16) if name == "bfloat16" else np.dtype(name)


def _leaf_dtype(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return _dtype_name(leaf.dtype)
    return np.asarray(leaf).dtype.name


# ---------------------------------------------------------------------------
# multi-process seams: real values in production, patchable for simulation
# ---------------------------------------------------------------------------

_SIM: Optional[tuple] = None    # (process_index, process_count)


def _dist_on() -> bool:
    return dist.is_available() and dist.is_initialized()


def _process_index() -> int:
    if _SIM is not None:
        return _SIM[0]
    return dist.get_rank() if _dist_on() else 0


def _process_count() -> int:
    if _SIM is not None:
        return _SIM[1]
    return dist.get_world_size() if _dist_on() else 1


@contextlib.contextmanager
def simulate_processes(process_index: int, process_count: int):
    """Pretend this process is ``process_index`` of ``process_count``: save
    writes only that process's chunks (and host leaves only as process 0),
    and restore assembles that process's blocks. Test-only — never nest
    with live async saves from a different simulated process."""
    global _SIM
    if not 0 <= process_index < process_count:
        raise ValueError(
            f"process_index {process_index} outside [0, {process_count})")
    prev = _SIM
    _SIM = (int(process_index), int(process_count))
    try:
        yield
    finally:
        _SIM = prev


# ---------------------------------------------------------------------------
# small shared helpers
# ---------------------------------------------------------------------------

def _flatten(tree, prefix: str = "") -> list:
    """[(key, leaf)] in insertion order; nested dicts join with ``/``."""
    out = []
    for name, leaf in tree.items():
        key = f"{prefix}{name}"
        if isinstance(leaf, dict):
            out += _flatten(leaf, key + "/")
        else:
            out.append((key, leaf))
    return out


def _unflatten(like, values: dict, prefix: str = ""):
    return {name: _unflatten(leaf, values, f"{prefix}{name}/")
            if isinstance(leaf, dict) else values[f"{prefix}{name}"]
            for name, leaf in like.items()}


def _range_count(ranges) -> int:
    return int(np.prod([b - a for a, b in ranges]))


def _intersect(a, b) -> Optional[tuple]:
    """Intersection of two ``[start, stop)`` range lists, or None when
    empty. NOTE: the scalar-leaf intersection is the empty tuple ``()``
    (falsy but a REAL full overlap) — callers must test ``is None``."""
    out = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(int(a0), int(b0)), min(int(a1), int(b1))
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


def _chunk_ranges(shape, dim: Optional[int], proc: int, procs: int) -> list:
    """``[start, stop)`` of chunk ``proc`` of ``procs`` along ``dim`` (the
    whole leaf when ``dim`` is None)."""
    ranges = [[0, int(d)] for d in shape]
    if dim is not None:
        if shape[dim] % procs:
            raise ValueError(f"dimension {dim} of {tuple(shape)} not "
                             f"divisible by {procs} processes")
        n = shape[dim] // procs
        ranges[dim] = [proc * n, (proc + 1) * n]
    return ranges


def _entry_process(entry: dict) -> int:
    """Owning process of a manifest shard entry; legacy v1 entries carry
    no ``process`` field, so fall back to the shard filename."""
    if "process" in entry:
        return int(entry["process"])
    m = re.match(r"shards-p(\d+)\.npz$", entry.get("file", ""))
    return int(m.group(1)) if m else 0


class _NpzCache:
    """Open-npz cache that CLOSES every handle deterministically:
    restore/verify scans over many steps must not accumulate open
    ``NpzFile``s."""

    def __init__(self, d: str):
        self._d = d
        self._open: dict = {}

    def get(self, fname: str):
        if fname not in self._open:
            self._open[fname] = np.load(os.path.join(self._d, fname))
        return self._open[fname]

    def close(self):
        files, self._open = list(self._open.values()), {}
        for f in files:
            try:
                f.close()
            except Exception:   # noqa: BLE001 — torn zip close is fine
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# save: snapshot (device -> host copy) then write (host only)
# ---------------------------------------------------------------------------

def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy that owns its memory: on the CPU ``.cpu()`` and
    ``.numpy()`` are views of the live tensor, which the train step
    updates in place."""
    return t.detach().to("cpu", copy=True).contiguous()


def _snapshot(tree) -> dict:
    """Host-side copy of every chunk this PROCESS owns — the double buffer
    an async save serializes from; the copies are finished when it
    returns. Replicated and host leaves are owned by process 0 only (every
    process claiming them would break ``saved_bytes == logical_bytes``).
    The process index/count are captured HERE: the async writer thread
    must not consult the seams."""
    proc, procs = _process_index(), _process_count()
    mesh = {"data": procs, "model": 1}
    snap = {"mesh": None, "leaves": {}, "process": proc, "processes": procs}
    for key, leaf in _flatten(tree):
        if isinstance(leaf, Blocks):
            shape, spec = list(leaf.shape), list(leaf.spec)
            shards = [([list(r) for r in ranges], _host_copy(x), proc)
                      for ranges, x in leaf.parts]
            snap["leaves"][key] = {"dtype": _dtype_name(leaf.dtype),
                                   "shape": shape, "spec": spec,
                                   "shards": shards}
            snap["mesh"] = snap["mesh"] or dict(leaf.mesh)
            continue
        if isinstance(leaf, Sharded):
            t = leaf.local
            shape = list(t.shape)
            shape[leaf.dim] *= procs
            spec = [None] * len(shape)
            spec[leaf.dim] = "data"
            shards = [(_chunk_ranges(shape, leaf.dim, proc, procs),
                       _host_copy(t), proc)]
        elif isinstance(leaf, torch.Tensor):
            t, shape, spec = leaf, list(leaf.shape), [None] * leaf.ndim
            shards = [(_chunk_ranges(shape, None, 0, 1), _host_copy(t), 0)] \
                if proc == 0 else []
        else:                           # host numpy / python scalar leaf
            t = np.array(leaf, copy=True)
            shape, spec = list(t.shape), None
            shards = [(_chunk_ranges(shape, None, 0, 1), t, 0)] \
                if proc == 0 else []
        if spec is not None and snap["mesh"] is None:
            snap["mesh"] = mesh
        snap["leaves"][key] = {"dtype": _leaf_dtype(t), "shape": shape,
                               "spec": spec, "shards": shards}
    return snap


def _raw(data) -> np.ndarray:
    """A leaf's bytes as a flat uint8 array (no copy)."""
    if isinstance(data, torch.Tensor):
        return data.reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(data).reshape(-1).view(np.uint8)


def _write_snapshot(ckpt_dir: str, step: int, snap: dict) -> str:
    """Serialize a snapshot into this process's PRIVATE staging dir
    ``step_N.tmp-pNN/`` (shard npz first, per-process manifest atomically
    last — the stage-complete marker), then, on process 0 only, run the
    merge-barrier commit. Idempotent — a retried attempt rebuilds the
    staging dir from scratch."""
    _faults.check("ckpt_write", step)   # chaos harness (no-op in prod)
    proc, procs = snap["process"], snap["processes"]
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    stage = f"{final}.tmp-p{proc:02d}"
    if os.path.isdir(stage):
        shutil.rmtree(stage)
    os.makedirs(stage)
    shard_file = f"shards-p{proc:02d}.npz"
    arrays, leaves = {}, {}
    slot = 0
    for key, meta in snap["leaves"].items():
        entries = []
        for ranges, data, dev in meta["shards"]:
            k = f"a{slot}"
            slot += 1
            # raw bytes: npz cannot serialize bfloat16
            arrays[k] = _raw(data)
            entries.append({"file": shard_file, "key": k,
                            "shape": list(data.shape), "index": ranges,
                            "device": dev, "process": proc,
                            "crc32": zlib.crc32(arrays[k])})
        leaves[key] = {"dtype": meta["dtype"], "shape": meta["shape"],
                       "spec": meta["spec"], "shards": entries}
    np.savez(os.path.join(stage, shard_file), **arrays)
    manifest = {"format": FORMAT, "step": step, "process": proc,
                "processes": procs, "mesh": snap["mesh"], "leaves": leaves}
    mpath = os.path.join(stage, f"manifest-p{proc:02d}.json")
    mtmp = mpath + ".part"
    with open(mtmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(mtmp, mpath)             # barrier poll never sees torn JSON
    if proc != 0:
        return final                    # process 0 commits for everyone
    path = _commit_step(ckpt_dir, step, procs)
    _faults.corrupt_committed(path, step)   # chaos harness (no-op in prod)
    return path


def _await_manifests(ckpt_dir: str, step: int, processes: int) -> dict:
    """Merge barrier: block until every process's ``manifest-pNN.json``
    exists (bounded by ``MERGE_BARRIER_TIMEOUT``, read at call time so
    tests can tighten it). Returns {process: manifest path}."""
    paths = {
        p: os.path.join(ckpt_dir, f"step_{step:08d}.tmp-p{p:02d}",
                        f"manifest-p{p:02d}.json")
        for p in range(processes)}
    deadline = time.monotonic() + MERGE_BARRIER_TIMEOUT
    while True:
        missing = sorted(p for p, mp in paths.items()
                         if not os.path.isfile(mp))
        if not missing:
            return paths
        if time.monotonic() >= deadline:
            raise CheckpointBarrierTimeout(
                f"step {step}: timed out after {MERGE_BARRIER_TIMEOUT}s "
                f"waiting for per-process manifests from process(es) "
                f"{missing} of {processes} — save is torn, not committed")
        time.sleep(_BARRIER_POLL)


def merge_manifests(manifests: list) -> dict:
    """Merge per-process manifests into the committed ``manifest.json``.

    Validates: unique process ids covering ``0..processes-1``, identical
    format/step, identical leaf key sets (``KeyError``), per-leaf
    dtype/shape/spec agreement across processes, and — the
    ``saved_bytes == logical_bytes`` invariant — that every leaf's shard
    union covers its logical element count EXACTLY (``ValueError`` listing
    every offender: under-coverage means a lost shard, over-coverage means
    duplicate ownership)."""
    if not manifests:
        raise ValueError("no per-process manifests to merge")
    by_proc: dict = {}
    for m in manifests:
        p = int(m["process"])
        if p in by_proc:
            raise ValueError(
                f"duplicate per-process manifest for process {p}")
        by_proc[p] = m
    procs = {int(m["processes"]) for m in manifests}
    steps = {int(m["step"]) for m in manifests}
    fmts = {m.get("format") for m in manifests}
    if len(procs) != 1 or len(steps) != 1 or len(fmts) != 1:
        raise ValueError(
            f"per-process manifests disagree on processes={sorted(procs)} "
            f"step={sorted(steps)} format={sorted(map(str, fmts))}")
    processes, step, fmt = procs.pop(), steps.pop(), fmts.pop()
    expected = set(range(processes))
    if set(by_proc) != expected:
        raise ValueError(
            f"step {step}: per-process manifests cover processes "
            f"{sorted(by_proc)} but the save declared {processes} "
            f"process(es) {sorted(expected)}")
    key_sets = {p: set(m["leaves"]) for p, m in by_proc.items()}
    base_keys = key_sets[0]
    for p, keys in sorted(key_sets.items()):
        if keys != base_keys:
            raise KeyError(
                f"step {step}: process {p} manifest leaf keys disagree "
                f"with process 0 — only in p{p}: "
                f"{sorted(keys - base_keys)}; only in p0: "
                f"{sorted(base_keys - keys)}")
    mesh = next((m["mesh"] for _, m in sorted(by_proc.items())
                 if m.get("mesh")), None)
    leaves: dict = {}
    errors = []
    for key in sorted(base_keys):
        metas = [(p, by_proc[p]["leaves"][key]) for p in sorted(by_proc)]
        _, base = metas[0]
        for p, meta in metas[1:]:
            if (meta["dtype"], meta["shape"], meta["spec"]) != (
                    base["dtype"], base["shape"], base["spec"]):
                errors.append(
                    f"  {key}: process {p} disagrees with process 0 on "
                    f"dtype/shape/spec ({meta['dtype']}/{meta['shape']}/"
                    f"{meta['spec']} vs {base['dtype']}/{base['shape']}/"
                    f"{base['spec']})")
        shards = [e for _, meta in metas for e in meta["shards"]]
        logical = int(np.prod(base["shape"]))
        covered = sum(_range_count(e["index"]) for e in shards)
        if covered != logical:
            kind = ("incomplete — a process lost shards"
                    if covered < logical else
                    "duplicate/overlapping — e.g. a host leaf written by "
                    "more than one process")
            errors.append(
                f"  {key}: merged shards cover {covered} of {logical} "
                f"elements ({kind}); saved_bytes == logical_bytes "
                f"invariant violated")
        leaves[key] = {"dtype": base["dtype"], "shape": base["shape"],
                       "spec": base["spec"], "shards": shards}
    if errors:
        raise ValueError(
            f"step {step}: per-process manifest merge failed:\n"
            + "\n".join(errors))
    return {"format": fmt, "step": step, "processes": processes,
            "mesh": mesh, "leaves": leaves}


def _commit_step(ckpt_dir: str, step: int, processes: int) -> str:
    """Process-0-only commit: await every per-process manifest, merge and
    validate, collect all stages into one ``step_N.tmp``, write the merged
    manifest, and atomically rename into place."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest_paths = _await_manifests(ckpt_dir, step, processes)
    manifests = []
    for p in sorted(manifest_paths):
        with open(manifest_paths[p]) as f:
            manifests.append(json.load(f))
    merged = merge_manifests(manifests)
    tmp = final + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    for p in sorted(manifest_paths):
        stage = f"{final}.tmp-p{p:02d}"
        for name in (f"shards-p{p:02d}.npz", f"manifest-p{p:02d}.json"):
            src = os.path.join(stage, name)
            if os.path.exists(src):
                os.replace(src, os.path.join(tmp, name))
        shutil.rmtree(stage, ignore_errors=True)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(merged, f, indent=1)
    if os.path.isdir(final):
        shutil.rmtree(final)            # re-save of the same step
    os.rename(tmp, final)
    return final


def _write_with_retry(ckpt_dir: str, step: int, snap: dict,
                      retry: Optional[BackoffPolicy]) -> str:
    """Write, retrying transient IO failures (OSError) with backoff;
    persistent failures — including merge-validation ``ValueError``s and
    :class:`CheckpointBarrierTimeout` — propagate immediately."""
    if retry is None:
        return _write_snapshot(ckpt_dir, step, snap)
    return retry.retry(
        lambda: _write_snapshot(ckpt_dir, step, snap),
        retryable=(OSError,),
        on_retry=lambda a, d, e: print(
            f"[ckpt] save step {step} attempt {a + 1} failed ({e}); "
            f"retrying in {d:.2f}s", flush=True))


def save_checkpoint(ckpt_dir: str, step: int, tree, *,
                    retry: Optional[BackoffPolicy] = DEFAULT_IO_BACKOFF,
                    keep_last_k: int = 0) -> str:
    """Synchronous save of this process's part of ``tree``. Transient IO
    errors are retried per ``retry``; ``keep_last_k`` > 0 runs retention
    GC after the commit (process 0 only)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    snap = _snapshot(tree)
    path = _write_with_retry(ckpt_dir, step, snap, retry)
    if keep_last_k and snap["process"] == 0:
        gc_checkpoints(ckpt_dir, keep_last_k)
    return path


class AsyncCheckpointer:
    """Double-buffered async saver with a bounded in-flight count.

    ``save`` copies this process's chunks to host memory synchronously (so
    the caller may update the live tensors as soon as it returns) and
    hands serialization to a background thread; when ``max_in_flight``
    writes are already pending it blocks on the oldest — backpressure
    instead of unbounded host-memory growth. ``wait()`` drains and
    re-raises the first background failure; failures also FAIL FAST on the
    next ``save`` (before and after the backpressure wait).

    Background writes retry transient IO errors with ``retry`` and run
    retention GC when ``keep_last_k`` > 0, on process 0 only. ``close()``
    drains WITHOUT raising (a stored failure is logged) for teardown paths
    where an exception is already in flight; ``__exit__`` closes on an
    exceptional exit and waits (re-raising) on a clean one.
    """

    def __init__(self, max_in_flight: int = 2,
                 retry: Optional[BackoffPolicy] = DEFAULT_IO_BACKOFF,
                 keep_last_k: int = 0):
        if max_in_flight < 1:
            raise ValueError(f"max_in_flight must be >= 1: {max_in_flight}")
        self._max = max_in_flight
        self._retry = retry
        self._keep_last_k = keep_last_k
        self._pending: list = []
        self._errors: list = []
        self._lock = threading.Lock()

    def _raise_if_failed(self):
        with self._lock:
            if self._errors:
                err = self._errors[0]
                raise RuntimeError(
                    f"async checkpoint save failed: {err!r}") from err

    def save(self, ckpt_dir: str, step: int, tree) -> str:
        self._raise_if_failed()
        while True:
            self._pending = [t for t in self._pending if t.is_alive()]
            if len(self._pending) < self._max:
                break
            self._pending[0].join()
        self._raise_if_failed()
        os.makedirs(ckpt_dir, exist_ok=True)
        snap = _snapshot(tree)          # device -> host, before returning

        def run():
            try:
                _write_with_retry(ckpt_dir, step, snap, self._retry)
                if self._keep_last_k and snap["process"] == 0:
                    gc_checkpoints(ckpt_dir, self._keep_last_k)
            except BaseException as e:  # noqa: BLE001 — surfaced in wait()
                with self._lock:
                    self._errors.append(e)

        t = threading.Thread(target=run, name=f"ckpt-save-{step}",
                             daemon=True)
        self._pending.append(t)
        t.start()
        return os.path.join(ckpt_dir, f"step_{step:08d}")

    def wait(self):
        for t in self._pending:
            t.join()
        self._pending.clear()
        self._raise_if_failed()

    def close(self):
        """Drain in-flight saves without raising; a stored background
        failure is LOGGED, never silently discarded."""
        for t in self._pending:
            t.join()
        self._pending.clear()
        with self._lock:
            errors, self._errors = self._errors, []
        for err in errors:
            print(f"[ckpt] WARNING: async checkpoint save failed "
                  f"(surfaced at close): {err!r}", flush=True)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is not None:
            self.close()
        else:
            self.wait()
        return False

    def __del__(self):
        try:
            if self._pending or self._errors:
                self.close()
        except Exception:   # noqa: BLE001 — interpreter-shutdown tolerant
            pass


# ---------------------------------------------------------------------------
# restore: strict template match, lazy shard-overlap read, target layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RestoreStats:
    """Byte/entry accounting for one restore. ``read_bytes`` counts each
    npz member at most once; ``partition_bytes`` is the host memory
    assembled for this process's blocks."""
    logical_bytes: int = 0
    read_bytes: int = 0
    partition_bytes: int = 0
    entries_total: int = 0
    entries_read: int = 0


_LAST_RESTORE_STATS: Optional[RestoreStats] = None


def last_restore_stats() -> Optional[RestoreStats]:
    """Stats of the most recent :func:`restore_checkpoint` on this
    process (None before any restore)."""
    return _LAST_RESTORE_STATS


class _LeafReader:
    """Per-leaf member reader: decodes each npz member at most once
    (checksum-verified) and counts read entries/bytes."""

    def __init__(self, d: str, cache: _NpzCache, carrier, stats: RestoreStats,
                 context: str):
        self._d = d
        self._cache = cache
        self._carrier = carrier
        self._stats = stats
        self._context = context
        self._members: dict = {}

    def member(self, entry: dict) -> np.ndarray:
        mk = (entry["file"], entry["key"])
        if mk not in self._members:
            raw = _read_shard_bytes(self._d, entry, self._cache,
                                    context=self._context)
            self._stats.entries_read += 1
            self._stats.read_bytes += len(raw)
            self._members[mk] = np.frombuffer(
                raw, self._carrier).reshape(entry["shape"])
        return self._members[mk]


def _assemble_block(key: str, meta: dict, ranges, reader: _LeafReader
                    ) -> np.ndarray:
    """Assemble ONE contiguous block (``[start, stop)`` per dim) of a
    leaf from the manifest shards that intersect it — non-overlapping
    shards are never read."""
    block = np.empty(tuple(b - a for a, b in ranges), _carrier(meta["dtype"]))
    covered = 0
    for e in meta["shards"]:
        inter = _intersect(e["index"], ranges)
        if inter is None:               # () is a REAL scalar overlap
            continue
        sub = reader.member(e)
        src = tuple(slice(lo - a0, hi - a0)
                    for (lo, hi), (a0, _) in zip(inter, e["index"]))
        dst = tuple(slice(lo - r0, hi - r0)
                    for (lo, hi), (r0, _) in zip(inter, ranges))
        block[dst] = sub[src]
        covered += _range_count(inter)
    want = _range_count(ranges)
    if covered != want:
        raise ValueError(
            f"leaf {key}: shards cover {covered} of {want} elements of "
            f"block {ranges} (incomplete or overlapping shard map)")
    return block


def _load_manifest(d: str) -> dict:
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    fmt = manifest.get("format")
    if fmt != FORMAT and fmt not in LEGACY_FORMATS:
        raise ValueError(
            f"checkpoint {d} has format {fmt!r}; this "
            f"restorer reads {FORMAT!r} (and legacy "
            f"{list(LEGACY_FORMATS)}) — refusing to reinterpret shard "
            f"bytes across format versions")
    return manifest


def _validate_template(d: str, leaves_meta: dict, like_items: list) -> None:
    """The strict template contract: ``KeyError`` on leaf-path mismatch,
    ``ValueError`` (all offenders, both sides printed) on shape/dtype
    mismatch or incomplete logical shard coverage."""
    like_keys = [k for k, _ in like_items]
    missing = sorted(set(like_keys) - set(leaves_meta))
    unexpected = sorted(set(leaves_meta) - set(like_keys))
    if missing or unexpected:
        raise KeyError(
            f"checkpoint {d} does not match the restore template — "
            f"missing from checkpoint: {missing or '[]'}; "
            f"unexpected in checkpoint: {unexpected or '[]'}")
    errors = []
    for key, leaf in like_items:
        meta = leaves_meta[key]
        want_shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
        want_dtype = _leaf_dtype(leaf)
        got_shape, got_dtype = tuple(meta["shape"]), meta["dtype"]
        if got_shape != want_shape or got_dtype != want_dtype:
            errors.append(
                f"  {key}: checkpoint shape={got_shape} "
                f"dtype={got_dtype} vs template shape={want_shape} "
                f"dtype={want_dtype}")
        covered = sum(_range_count(e["index"]) for e in meta["shards"])
        if covered != int(np.prod(got_shape)):
            errors.append(
                f"  {key}: shards cover {covered} of "
                f"{int(np.prod(got_shape))} elements (incomplete or "
                f"overlapping shard map)")
    if errors:
        raise ValueError(
            f"checkpoint {d} incompatible with restore template:\n"
            + "\n".join(errors))


def _as_leaf(block: np.ndarray, template, name: str):
    """A torch tensor (CPU) where the template is one, else numpy."""
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(block).view(_TORCH[name])
    return block


def _restore_blocks(ckpt_dir: str, step: int, like, shardings) -> tuple:
    """This process's block of every template leaf: ``({key: (ranges,
    leaf)}, stats)``; ``shardings`` maps a key to the dimension split over
    the processes (absent or None: the whole leaf)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest = _load_manifest(d)
    leaves_meta = manifest["leaves"]
    like_items = _flatten(like)
    _validate_template(d, leaves_meta, like_items)
    shardings = shardings or {}
    unknown = sorted(set(shardings) - {k for k, _ in like_items})
    if unknown:
        raise KeyError(f"shardings name leaves not in the template: "
                       f"{unknown}")
    proc, procs = _process_index(), _process_count()
    stats = RestoreStats()
    out = {}
    with _NpzCache(d) as cache:
        for key, template in like_items:
            meta = leaves_meta[key]
            carrier = _carrier(meta["dtype"])
            shape = tuple(meta["shape"])
            stats.logical_bytes += int(np.prod(shape)) * carrier.itemsize
            stats.entries_total += len(meta["shards"])
            reader = _LeafReader(d, cache, carrier, stats, key)
            spec = shardings.get(key)
            if isinstance(spec, (list, tuple)):
                # explicit blocks, stacked along the leading dimension
                ranges = [[list(r) for r in rs] for rs in spec]
                block = np.concatenate(
                    [_assemble_block(key, meta, rs, reader)
                     for rs in ranges], 0)
            else:
                ranges = _chunk_ranges(shape, spec, proc, procs)
                block = _assemble_block(key, meta, ranges, reader)
            stats.partition_bytes += block.nbytes
            out[key] = (ranges, _as_leaf(block, template, meta["dtype"]))
    return out, stats


def restore_checkpoint(ckpt_dir: str, step: int, like, shardings=None):
    """Restore into the structure of ``like`` (a dict of template leaves:
    tensors, e.g. on the ``meta`` device, or numpy arrays; values
    ignored). A torch template leaf comes back as a CPU tensor, a numpy one
    as numpy.

    With ``shardings`` (``{key: dim or None}``, the restoring layout), each
    leaf split on a dimension comes back as this process's chunk of it, of
    ``_process_count()`` equal chunks, and only the manifest shards that
    intersect that chunk are read — per-process IO and memory are
    O(local partition). :func:`last_restore_stats` reports the accounting.

    Raises ``KeyError`` when the checkpoint and template disagree on leaf
    paths, and ``ValueError`` (all offenders listed, both sides printed)
    on any shape/dtype mismatch or incomplete shard coverage."""
    global _LAST_RESTORE_STATS
    blocks, stats = _restore_blocks(ckpt_dir, step, like, shardings)
    _LAST_RESTORE_STATS = stats
    return _unflatten(like, {k: leaf for k, (_, leaf) in blocks.items()})


def restore_local_shards(ckpt_dir: str, step: int, like, shardings
                         ) -> Tuple[dict, RestoreStats]:
    """THIS process's lazy restore plan, materialized: ``({leaf_key:
    [(device, ranges, block)]}, stats)`` with ``device`` the process (one
    rank per process) and ``ranges`` the block's ``((start, stop), ...)``
    — the multi-process test surface; production restores go through
    :func:`restore_checkpoint`."""
    if shardings is None:
        raise ValueError("restore_local_shards requires target shardings")
    blocks, stats = _restore_blocks(ckpt_dir, step, like, shardings)
    proc = _process_index()
    return {k: [(proc, tuple(map(tuple, ranges)), leaf)]
            for k, (ranges, leaf) in blocks.items()}, stats


def _read_shard_bytes(d: str, entry: dict, npz_cache: _NpzCache, *,
                      context: str) -> bytes:
    """One shard's raw bytes, checksum-verified against the manifest.
    Unreadable files (torn zip, IO error) and crc mismatches both raise
    :class:`CheckpointCorruptError` — the fallback-restore trigger."""
    try:
        raw = npz_cache.get(entry["file"])[entry["key"]].tobytes()
    except Exception as e:  # noqa: BLE001 — any read failure = corrupt
        raise CheckpointCorruptError(
            f"checkpoint {d}: shard file {entry['file']!r} "
            f"(leaf {context}, key {entry['key']}) unreadable: "
            f"{e!r}") from e
    if "crc32" in entry and zlib.crc32(raw) != entry["crc32"]:
        raise CheckpointCorruptError(
            f"checkpoint {d}: shard {entry['key']} of leaf {context} "
            f"fails crc32 verification (manifest {entry['crc32']}, "
            f"bytes {zlib.crc32(raw)}) — torn or corrupt write")
    return raw


def verify_checkpoint(ckpt_dir: str, step: int) -> None:
    """Full integrity check of one step: manifest present with the right
    format, every shard file readable, every per-shard crc32 matching.
    Raises :class:`CheckpointCorruptError` (or ``FileNotFoundError`` for
    a missing manifest); returns None when the checkpoint is sound."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest_path = os.path.join(d, "manifest.json")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise
    except Exception as e:  # noqa: BLE001 — torn manifest = corrupt
        raise CheckpointCorruptError(
            f"checkpoint {d}: manifest unreadable: {e!r}") from e
    fmt = manifest.get("format")
    if fmt != FORMAT and fmt not in LEGACY_FORMATS:
        raise CheckpointCorruptError(
            f"checkpoint {d}: format {fmt!r} != {FORMAT!r}")
    with _NpzCache(d) as npz_cache:
        for key, meta in manifest["leaves"].items():
            for e in meta["shards"]:
                _read_shard_bytes(d, e, npz_cache, context=key)


def list_steps(ckpt_dir: str) -> list:
    """All committed step numbers, ascending. A step counts only when
    its ``manifest.json`` exists — staging dirs and manifest-less torn
    directories are skipped, not tripped on."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(m.group(1)) for name in os.listdir(ckpt_dir)
        if (m := re.match(r"step_(\d+)$", name))
        and os.path.isfile(os.path.join(ckpt_dir, name, "manifest.json")))


def latest_step(ckpt_dir: str) -> int:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else -1


def latest_valid_step(ckpt_dir: str, before: Optional[int] = None) -> int:
    """Newest step that passes :func:`verify_checkpoint` (optionally
    strictly below ``before``); -1 when none does."""
    for step in reversed(list_steps(ckpt_dir)):
        if before is not None and step >= before:
            continue
        if _is_valid(ckpt_dir, step):
            return step
    return -1


def restore_latest_valid(ckpt_dir: str, like, shardings=None
                         ) -> Tuple[object, int]:
    """Restore of the newest VALID checkpoint: steps are tried
    newest-first, each integrity-verified (checksums) before restore; a
    torn or corrupt step is reported and skipped. Template mismatches
    still propagate — a config error must never be "fixed" by rolling
    back to an older checkpoint that happens to match.

    Returns ``(tree, step)``; raises ``FileNotFoundError`` when no valid
    checkpoint exists at all."""
    steps = list_steps(ckpt_dir)
    for step in reversed(steps):
        try:
            verify_checkpoint(ckpt_dir, step)
        except (CheckpointCorruptError, OSError) as e:
            print(f"[ckpt] step {step} failed verification ({e}); "
                  f"falling back to the previous checkpoint", flush=True)
            continue
        return restore_checkpoint(ckpt_dir, step, like,
                                  shardings=shardings), step
    raise FileNotFoundError(
        f"no valid checkpoint in {ckpt_dir!r} "
        f"({len(steps)} step dir(s) present, all failed verification)"
        if steps else f"no checkpoint step_* directories in {ckpt_dir!r}")


def gc_checkpoints(ckpt_dir: str, keep_last_k: int) -> list:
    """Retention GC: delete all but the newest ``keep_last_k`` committed
    steps — EXCEPT the newest step that verifies, which is never deleted
    even when older than the retention window. Returns the step numbers
    whose removal actually SUCCEEDED: a failed rmtree is warned about and
    excluded."""
    if keep_last_k < 1:
        raise ValueError(f"keep_last_k must be >= 1: {keep_last_k}")
    steps = list_steps(ckpt_dir)
    if len(steps) <= keep_last_k:
        return []
    keep = set(steps[-keep_last_k:])
    if not any(_is_valid(ckpt_dir, s)
               for s in sorted(keep, reverse=True)):
        newest_valid = latest_valid_step(ckpt_dir)
        if newest_valid >= 0:
            keep.add(newest_valid)
    deleted = []
    for step in steps:
        if step in keep:
            continue
        path = os.path.join(ckpt_dir, f"step_{step:08d}")
        try:
            shutil.rmtree(path)
        except OSError as e:
            print(f"[ckpt] WARNING: retention gc failed to delete step "
                  f"{step} ({path}): {e!r}; keeping it in the listing",
                  flush=True)
            continue
        if os.path.isdir(path):
            print(f"[ckpt] WARNING: retention gc left step {step} "
                  f"({path}) on disk; keeping it in the listing",
                  flush=True)
            continue
        deleted.append(step)
    return deleted


def _is_valid(ckpt_dir: str, step: int) -> bool:
    try:
        verify_checkpoint(ckpt_dir, step)
        return True
    except (CheckpointCorruptError, OSError):
        return False


def checkpoint_size_report(ckpt_dir: str, step: int) -> dict:
    """Byte accounting from the manifest (no array loads): total logical
    bytes, total saved shard bytes (== logical iff no replica was written
    twice), per-device and per-process owned bytes, and the file sizes."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest = _load_manifest(d)
    logical = saved = 0
    per_device: dict = {}
    per_process: dict = {}
    for meta in manifest["leaves"].values():
        itemsize = _carrier(meta["dtype"]).itemsize
        logical += int(np.prod(meta["shape"])) * itemsize
        for e in meta["shards"]:
            nbytes = _range_count(e["index"]) * itemsize
            saved += nbytes
            per_device[e["device"]] = per_device.get(e["device"], 0) + nbytes
            p = _entry_process(e)
            per_process[p] = per_process.get(p, 0) + nbytes
    files = {name: os.path.getsize(os.path.join(d, name))
             for name in os.listdir(d)}
    return {"logical_bytes": logical, "saved_bytes": saved,
            "per_device_bytes": per_device,
            "per_process_bytes": per_process, "file_bytes": files}


def per_process_restore_bytes(ckpt_dir: str, step: int) -> dict:
    """Per-process RESTORE bytes for a same-layout restore, from the
    merged manifest alone: a shard covering its whole leaf is replicated
    (every process reads it), a partial shard is read by its owner."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest = _load_manifest(d)
    processes = int(manifest.get("processes", 1))
    out = {p: 0 for p in range(processes)}
    for meta in manifest["leaves"].values():
        itemsize = _carrier(meta["dtype"]).itemsize
        logical = int(np.prod(meta["shape"]))
        for e in meta["shards"]:
            count = _range_count(e["index"])
            nbytes = count * itemsize
            if count == logical:        # replicated: every process reads it
                for p in out:
                    out[p] += nbytes
            else:
                p = _entry_process(e)
                out[p] = out.get(p, 0) + nbytes
    return out
