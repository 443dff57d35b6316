"""Deterministic fault injection for chaos-testing the training stack (a
copy of ``repro/resilience/faults.py``; ``poison_batch`` takes the train
loop's device tensors or a host numpy batch).

A :class:`FaultPlan` is a seed-driven, explicitly-enumerable list of
faults — each one names a *kind*, the step it fires at, and (for IO
faults) whether it is transient or permanent. Instrumented call sites
across the stack consult the installed plan and are exact no-ops when
none is installed (the production fast path):

  kind          fires at (site)                          effect
  ------------  ---------------------------------------  ----------------
  nan_grad      ``poison_batch`` in the train loop       floats -> NaN, so
                (launch/train.py, before the step)       loss/grads blow up
                                                         and the engine's
                                                         anomaly guard trips
  ckpt_write    ``check("ckpt_write")`` in               TransientError
                ``checkpoint._write_snapshot``           (retried by the
                                                         backoff wrapper) or
                                                         PermanentFault
  ckpt_corrupt  ``corrupt_committed`` after the          flips bytes in every
                merge-barrier checkpoint commit          committed shard file
                                                         (checksum verify
                                                         catches it; restore
                                                         falls back)
  data          ``check("data")`` in                     TransientError or
                ``DataPipeline.batch_at``                PermanentFault (no
                                                         Prefetcher retries
                                                         it yet: the attempt
                                                         ends)
  preempt       ``preempt_due`` in the train loop        SIGTERM to the own
                                                         process (exercises
                                                         the emergency-save
                                                         + supervisor path)

Faults fire **once**: each firing is appended to a JSONL fault log, and
installing a plan with the same log path marks already-fired faults as
consumed — so a supervised run relaunched after a fault does NOT replay
it (``preempt@5`` kills the run exactly once, not on every resume that
re-executes step 5). The log doubles as the chaos-run audit artifact.

Data parallelism: every rank installs the same plan, so each fault fires
on every rank at the same step; only the rank made with ``writer=True``
(rank 0) appends to the log, and every rank reads it when the plan is
made.

Steps are deterministic: given explicitly (``FaultPlan.parse``,
``--inject-faults "nan_grad@3,preempt@5"``) or drawn from a seeded RNG
(``FaultPlan.seeded`` / the ``kind@rand`` spec form) — the same seed
always yields the same chaos schedule.
"""
from __future__ import annotations

import json
import os
import random
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.resilience.backoff import TransientError

KINDS = ("nan_grad", "ckpt_write", "ckpt_corrupt", "data", "preempt")
_ALIASES = {"nan": "nan_grad", "sigterm": "preempt", "ckpt": "ckpt_write"}


class PermanentFault(RuntimeError):
    """A planned failure that does NOT resolve on retry (within this
    process); retry wrappers must propagate it immediately."""


@dataclass
class Fault:
    kind: str
    step: int
    mode: str = "transient"         # transient | permanent (IO kinds)
    count: int = 2                  # transient raises before success
    remaining: int = field(init=False)
    fired: bool = field(default=False, init=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")
        if self.mode not in ("transient", "permanent"):
            raise ValueError(f"unknown fault mode {self.mode!r}")
        if self.count < 1:
            raise ValueError(f"fault count must be >= 1: {self.count}")
        # permanent: raise on every attempt until the process dies;
        # non-IO kinds are one-shot regardless of mode
        self.remaining = (self.count if self.mode == "transient" else -1) \
            if self.kind in ("ckpt_write", "data") else 1

    @property
    def exhausted(self) -> bool:
        return self.remaining == 0


class FaultPlan:
    """A thread-safe set of planned faults plus the fired-fault log.
    ``writer``: whether this process appends to the log (rank 0 of a
    data-parallel world; every rank reads it)."""

    def __init__(self, faults: Sequence[Fault], log_path: Optional[str]
                 = None, *, writer: bool = True):
        self.faults: List[Fault] = list(faults)
        self.log_path = log_path
        self.writer = writer
        self._lock = threading.RLock()
        if log_path and os.path.exists(log_path):
            self._consume_from_log(log_path)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def parse(cls, spec: str, *, seed: int = 0,
              max_step: Optional[int] = None,
              log_path: Optional[str] = None,
              writer: bool = True) -> "FaultPlan":
        """``kind@step[:mode[:count]]`` comma-separated; ``@rand`` draws
        the step from ``random.Random(seed)`` over ``[1, max_step)`` —
        deterministic per seed. E.g.
        ``"nan_grad@3,ckpt_write@4:transient:2,preempt@rand"``."""
        rng = random.Random(seed)
        faults = []
        for tok in filter(None, (t.strip() for t in spec.split(","))):
            head, _, tail = tok.partition(":")
            kind, at, step_s = head.partition("@")
            kind = _ALIASES.get(kind.strip(), kind.strip())
            if not at:
                raise ValueError(f"fault token {tok!r} needs kind@step")
            if step_s == "rand":
                if not max_step or max_step < 2:
                    raise ValueError(
                        f"{tok!r}: @rand needs max_step >= 2 (got "
                        f"{max_step})")
                step = rng.randrange(1, max_step)
            else:
                step = int(step_s)
            mode, count = "transient", 2
            if tail:
                parts = tail.split(":")
                mode = parts[0] or "transient"
                if len(parts) > 1:
                    count = int(parts[1])
            faults.append(Fault(kind, step, mode, count))
        return cls(faults, log_path=log_path, writer=writer)

    @classmethod
    def seeded(cls, seed: int, max_step: int,
               kinds: Sequence[str] = ("nan_grad", "ckpt_corrupt",
                                       "preempt"),
               log_path: Optional[str] = None,
               writer: bool = True) -> "FaultPlan":
        """One fault per kind at a seed-deterministic step in
        ``[1, max_step)`` — the acceptance-criteria chaos schedule."""
        rng = random.Random(seed)
        return cls([Fault(_ALIASES.get(k, k), rng.randrange(1, max_step))
                    for k in kinds], log_path=log_path, writer=writer)

    # ------------------------------------------------------------------
    # fired-fault log (once-only across supervisor restarts + artifact)
    # ------------------------------------------------------------------

    def _consume_from_log(self, path: str):
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue            # torn final line of a killed run
                for flt in self.faults:
                    if flt.kind == rec.get("kind") and \
                            flt.step == rec.get("step"):
                        flt.remaining = 0
                        flt.fired = True

    def _log(self, flt: Fault, detail: str):
        flt.fired = True
        if not self.log_path or not self.writer:
            return
        rec = {"kind": flt.kind, "step": flt.step, "mode": flt.mode,
               "detail": detail, "pid": os.getpid(),
               "time": round(time.time(), 3)}
        os.makedirs(os.path.dirname(self.log_path) or ".", exist_ok=True)
        with open(self.log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _match(self, kind: str, step: int) -> Optional[Fault]:
        for flt in self.faults:
            if flt.kind == kind and flt.step == step and not flt.exhausted:
                return flt
        return None

    # ------------------------------------------------------------------
    # injection sites
    # ------------------------------------------------------------------

    def check(self, kind: str, step: int):
        """IO-fault site (``ckpt_write`` / ``data``): raise the planned
        failure, or pass through. Transient faults raise
        :class:`TransientError` ``count`` times then resolve; permanent
        faults raise :class:`PermanentFault` until the process dies."""
        with self._lock:
            flt = self._match(kind, step)
            if flt is None:
                return
            if flt.mode == "permanent":
                if not flt.fired:
                    self._log(flt, "permanent failure injected")
                raise PermanentFault(
                    f"injected permanent {kind} fault at step {flt.step}")
            flt.remaining -= 1
            detail = (f"transient failure "
                      f"({flt.count - flt.remaining}/{flt.count})")
            if flt.remaining == 0:
                self._log(flt, detail + " — will resolve on retry")
            raise TransientError(
                f"injected transient {kind} fault at step {flt.step} "
                f"({detail})")

    def poison_batch(self, batch: dict, step: int, *, resolution: int = 0
                     ) -> dict:
        """``nan_grad`` site: return the batch (numpy arrays on the host,
        or torch tensors on their device) with every float leaf poisoned
        to NaN, once per planned step: the retry after the guard skips the
        update sees the clean batch again. A uint8 image batch carries no
        float leaf to poison, so its images become a float32 NaN batch at
        ``resolution`` (the model input size) on the images' device;
        ``device_preprocess`` passes float batches through untouched, so
        the NaN still reaches the loss and trips the guard."""
        with self._lock:
            flt = self._match("nan_grad", step)
            if flt is None:
                return batch
            flt.remaining = 0
            self._log(flt, "batch poisoned to NaN")
        floats = [k for k, v in batch.items() if _is_float(v)]
        out = {k: v * float("nan") if k in floats else v
               for k, v in batch.items()}
        img = batch.get("images")
        if not floats and img is not None and _is_uint8(img):
            shape = tuple(img.shape)
            if resolution:
                shape = shape[:1] + (resolution, resolution) + shape[3:]
            out["images"] = torch.full(
                shape, float("nan"), dtype=torch.float32,
                device=img.device) if isinstance(img, torch.Tensor) \
                else np.full(shape, np.nan, np.float32)
        return out

    def corrupt_committed(self, ckpt_path: str, step: int):
        """``ckpt_corrupt`` site: after the merge-barrier commit, flip
        bytes inside EVERY per-process shard file of the committed step —
        a torn/bit-rotted checkpoint that LOOKS complete (merged manifest
        present) but fails checksum verification on restore, regardless of
        which process's shards a lazy restore happens to read."""
        with self._lock:
            flt = self._match("ckpt_corrupt", step)
            if flt is None:
                return
            flt.remaining = 0
            shards = sorted(n for n in os.listdir(ckpt_path)
                            if n.startswith("shards-"))
            if not shards:
                return
            for name in shards:
                target = os.path.join(ckpt_path, name)
                size = os.path.getsize(target)
                if size == 0:
                    continue
                with open(target, "r+b") as f:
                    f.seek(max(0, size // 2))
                    f.write(b"\xde\xad\xbe\xef" * 4)
            self._log(flt, f"corrupted {', '.join(shards)}")

    def preempt_due(self, step: int) -> bool:
        """``preempt`` site: deliver SIGTERM to this process (the real
        signal — the emergency-save handler path is what's under test).
        Returns True when the signal was sent."""
        with self._lock:
            flt = self._match("preempt", step)
            if flt is None:
                return False
            flt.remaining = 0
            self._log(flt, "SIGTERM delivered to own process")
        os.kill(os.getpid(), signal.SIGTERM)
        return True

    # ------------------------------------------------------------------
    # installation (module-level active plan — threading a plan through
    # every signature in the stack would couple all layers to this one)
    # ------------------------------------------------------------------

    def install(self) -> "FaultPlan":
        global _ACTIVE
        _ACTIVE = self
        return self

    def uninstall(self):
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    def __repr__(self):
        return ("FaultPlan(" + ", ".join(
            f"{f.kind}@{f.step}:{f.mode}" + ("!" if f.fired else "")
            for f in self.faults) + ")")


_ACTIVE: Optional[FaultPlan] = None


def _is_float(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.is_floating_point()
    return np.issubdtype(np.asarray(v).dtype, np.floating)


def _is_uint8(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.dtype == torch.uint8
    return np.asarray(v).dtype == np.uint8


def active() -> Optional[FaultPlan]:
    return _ACTIVE


# module-level shims: exact no-ops when no plan is installed, so the
# instrumented hot paths cost one None check in production
def check(kind: str, step: int):
    if _ACTIVE is not None:
        _ACTIVE.check(kind, step)


def poison_batch(batch: dict, step: int, *, resolution: int = 0) -> dict:
    if _ACTIVE is None:
        return batch
    return _ACTIVE.poison_batch(batch, step, resolution=resolution)


def corrupt_committed(ckpt_path: str, step: int):
    if _ACTIVE is not None:
        _ACTIVE.corrupt_committed(ckpt_path, step)


def preempt_due(step: int) -> bool:
    return _ACTIVE is not None and _ACTIVE.preempt_due(step)
