"""Jittered-exponential backoff — the ONE retry policy shared by
checkpoint IO (`repro_torch.checkpoint`) and the auto-resume supervisor
(`repro_torch.resilience.supervisor`); a copy of
``repro/resilience/backoff.py``, kept here so the port needs nothing of
the JAX package (the data ``Prefetcher``, its third user there, is not
ported yet).

The policy is a frozen value object so call sites can log it, tests can
enumerate its delay schedule without sleeping, and property tests can
check the invariants every consumer relies on (the reference's
``tests/test_backoff_props.py``; ``tests/test_torch_resilience.py`` holds
this copy's schedules equal to the reference's):

  * the UNJITTERED schedule is monotone non-decreasing and capped at
    ``max_delay`` (``base_delay * multiplier**k`` clipped);
  * every jittered delay lies within ``raw * (1 ± jitter)`` of its
    unjittered value (and never below 0);
  * exactly ``max_attempts`` attempts are made, with ``max_attempts - 1``
    sleeps between them;
  * the schedule is a pure function of ``seed`` — two policies with the
    same seed produce the identical delay sequence (the determinism the
    fault-injection harness needs for reproducible chaos runs).
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple


class TransientError(OSError):
    """An error the caller believes will resolve on retry (injected by
    the fault harness; also the marker real IO layers may raise).
    Subclasses OSError so the default retry predicates treat any IO
    error — injected or real — the same way."""


@dataclass(frozen=True)
class BackoffPolicy:
    """``max_attempts`` total tries; delay before retry k (0-based) is
    ``min(base_delay * multiplier**k, max_delay)`` scaled by a uniform
    jitter in ``[1 - jitter, 1 + jitter]``."""
    max_attempts: int = 4
    base_delay: float = 0.05
    multiplier: float = 2.0
    max_delay: float = 2.0
    jitter: float = 0.5

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1: {self.max_attempts}")
        if self.base_delay < 0 or self.max_delay < self.base_delay:
            raise ValueError(
                f"need 0 <= base_delay <= max_delay: "
                f"base={self.base_delay} max={self.max_delay}")
        if self.multiplier < 1:
            raise ValueError(f"multiplier must be >= 1: {self.multiplier}")
        if not 0 <= self.jitter < 1:
            raise ValueError(f"jitter must be in [0, 1): {self.jitter}")

    def raw_delay(self, attempt: int) -> float:
        """Unjittered delay after 0-based ``attempt`` — monotone
        non-decreasing, capped at ``max_delay``."""
        return min(self.base_delay * self.multiplier ** attempt,
                   self.max_delay)

    def delays(self, seed: Optional[int] = None) -> Iterator[float]:
        """The ``max_attempts - 1`` inter-attempt delays. Deterministic
        under a fixed ``seed`` (unseeded -> fresh entropy per call)."""
        rng = random.Random(seed)
        for k in range(self.max_attempts - 1):
            raw = self.raw_delay(k)
            yield raw * (1 + self.jitter * (2 * rng.random() - 1))

    def retry(self, fn: Callable, *, retryable: Tuple[type, ...]
              = (OSError,), seed: Optional[int] = None,
              sleep: Callable[[float], None] = time.sleep,
              on_retry: Optional[Callable] = None):
        """Call ``fn()`` up to ``max_attempts`` times, sleeping a jittered
        delay between attempts. Only ``retryable`` exceptions are retried
        — anything else (a PERSISTENT failure) propagates immediately,
        and the last retryable failure propagates once attempts are
        exhausted. ``on_retry(attempt, delay, exc)`` observes each retry
        (logging hook)."""
        delays = self.delays(seed)
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except retryable as e:  # noqa: PERF203 — retry loop
                if attempt + 1 >= self.max_attempts:
                    raise
                delay = next(delays)
                if on_retry is not None:
                    on_retry(attempt, delay, e)
                sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover
