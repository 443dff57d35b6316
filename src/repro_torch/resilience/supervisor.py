"""Auto-resume supervisor: keep a training run alive, unattended (a copy
of ``repro/resilience/supervisor.py`` that relaunches the port's CLI).

Two halves, matching the two halves of surviving preemption:

* **Inside the training process** — :func:`install_preemption_handler`
  hooks SIGTERM/SIGINT into a :class:`PreemptionFlag` the train loop
  polls between steps. On the first signal the loop performs a
  best-effort emergency checkpoint save and exits with
  :data:`RESTARTABLE_EXIT` (75, ``EX_TEMPFAIL`` — "failure that is
  expected to clear"); a second signal falls through to the default
  handler and kills the process outright (the scheduler always wins).

* **Outside it** — :func:`supervise` relaunches the training command
  until it exits 0, with capped restarts and jittered-exponential
  backoff between attempts (`repro_torch.resilience.backoff`). Children
  are separate processes (fresh CUDA context, fresh device state — a wedged
  accelerator context never survives into the retry) and resume from
  the newest VALID checkpoint because the relaunched command carries
  ``--resume`` and restore falls back past torn/corrupt steps
  (`repro_torch.checkpoint`). ``launch/train.py --supervise --max-restarts N``
  is the CLI wiring.

The supervisor forwards SIGTERM/SIGINT to the child and stops
restarting once it has been told to shut down itself — preempting the
supervisor preempts the tree.
"""
from __future__ import annotations

import signal
import subprocess
import sys
import time
from typing import Callable, List, Optional

from repro_torch.resilience.backoff import BackoffPolicy

# EX_TEMPFAIL: the run was interrupted (preemption/emergency save), not
# wrong — the supervisor treats every nonzero exit as restartable, but
# this one is also "expected", so it is logged as preemption not crash
RESTARTABLE_EXIT = 75

DEFAULT_RESTART_BACKOFF = BackoffPolicy(
    max_attempts=64,            # the restart CAP is max_restarts, not this
    base_delay=0.5, multiplier=2.0, max_delay=30.0, jitter=0.5)


class PreemptionFlag:
    """Set by the signal handler, polled by the train loop."""

    def __init__(self):
        self.signum: Optional[int] = None

    @property
    def triggered(self) -> bool:
        return self.signum is not None


def install_preemption_handler(signals=(signal.SIGTERM, signal.SIGINT)
                               ) -> PreemptionFlag:
    """Install one-shot handlers: first delivery sets the flag (the loop
    does the emergency save), and the default disposition is restored so
    a second delivery terminates immediately."""
    flag = PreemptionFlag()

    def handler(signum, frame):
        del frame
        flag.signum = signum
        for s in signals:
            signal.signal(s, signal.SIG_DFL)
        # one write (every rank of a world prints it): unbuffered, print()
        # writes the text and its newline apart, and another process's
        # line can land between them
        print(f"[supervisor] caught signal {signum}: finishing step, "
              f"emergency-saving, then exiting {RESTARTABLE_EXIT}\n",
              end="", flush=True)

    for s in signals:
        signal.signal(s, handler)
    return flag


def supervise(cmd: List[str], *, max_restarts: int = 3,
              backoff: BackoffPolicy = DEFAULT_RESTART_BACKOFF,
              seed: Optional[int] = None,
              sleep: Callable[[float], None] = time.sleep,
              popen: Callable = subprocess.Popen,
              log: Callable[[str], None] = None) -> int:
    """Run ``cmd`` until it exits 0, relaunching on any nonzero exit (or
    death-by-signal) up to ``max_restarts`` times with backoff delays
    between attempts. Returns the final exit code (0 on success, the
    child's last code when the restart budget is exhausted, or 128+sig
    when the supervisor itself was told to stop).

    ``sleep``/``popen``/``log`` are injectable for deterministic tests.
    """
    if max_restarts < 0:
        raise ValueError(f"max_restarts must be >= 0: {max_restarts}")
    log = log or (lambda m: print(f"[supervisor] {m}", flush=True))
    delays = backoff.delays(seed)
    stop = {"signum": None}
    child = {"proc": None}

    def forward(signum, frame):
        del frame
        stop["signum"] = signum
        if child["proc"] is not None and child["proc"].poll() is None:
            child["proc"].send_signal(signum)

    prev = {s: signal.signal(s, forward)
            for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        for attempt in range(max_restarts + 1):
            log(f"launch attempt {attempt + 1}/{max_restarts + 1}: "
                + " ".join(cmd))
            proc = popen(cmd)
            child["proc"] = proc
            rc = proc.wait()
            child["proc"] = None
            if rc == 0:
                log("run completed cleanly")
                return 0
            why = "preempted (emergency save)" if rc == RESTARTABLE_EXIT \
                else f"died with signal {-rc}" if rc < 0 \
                else f"crashed (exit {rc})"
            if stop["signum"] is not None:
                log(f"child {why}; supervisor was signalled "
                    f"({stop['signum']}) — not restarting")
                return 128 + stop["signum"]
            if attempt >= max_restarts:
                log(f"child {why}; restart budget ({max_restarts}) "
                    f"exhausted — giving up")
                return rc if rc > 0 else 128 - rc
            delay = next(delays, backoff.max_delay)
            log(f"child {why}; restarting from the newest valid "
                f"checkpoint in {delay:.2f}s "
                f"({max_restarts - attempt} restarts left)")
            sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover
    finally:
        for s, h in prev.items():
            signal.signal(s, h)


def child_argv(argv: List[str]) -> List[str]:
    """The relaunch command for a supervised training run: the
    supervisor's own argv minus the supervision flags, plus ``--resume``
    (idempotent) so every attempt restores the newest valid checkpoint."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "--supervise":
            continue
        if a == "--max-restarts":
            skip = True
            continue
        if a.startswith("--max-restarts="):
            continue
        out.append(a)
    if "--resume" not in out:
        out.append("--resume")
    return [sys.executable, "-m", "repro_torch.launch.train"] + out
