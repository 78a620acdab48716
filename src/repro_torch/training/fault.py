"""Fault tolerance + straggler mitigation for the train loop: the port's
copy of ``repro.training.fault`` (pure Python).

  * :class:`StragglerMonitor` — per-step wall-time EWMA + deviation; flags
    steps beyond ``threshold`` sigma (on real multi-host deployments the
    flagged host is reported for drain/replace; here it also feeds the
    test-suite's mitigation assertions).
  * :class:`FailureInjector` — deterministic fault schedule for tests and
    the fault-tolerance example: raises simulated preemptions at chosen
    steps.
  * :func:`run_with_restarts` — supervisor loop: runs the trainer, catches
    (simulated or real) worker failures, restores from the newest committed
    checkpoint and replays the data stream deterministically.  On elastic
    shrink the restore path re-shards the checkpoint onto the surviving
    mesh (checkpoints are stored unsharded — see checkpoint.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


class SimulatedFailure(RuntimeError):
    """A worker preemption / node loss injected by the test harness."""


@dataclass
class FailureInjector:
    fail_at_steps: tuple[int, ...] = ()
    fired: set = field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected node failure at step {step}")


@dataclass
class StragglerMonitor:
    """EWMA step-time tracker; flags straggling steps/hosts."""

    alpha: float = 0.1
    threshold: float = 3.0  # sigma
    mean: float = 0.0
    var: float = 0.0
    steps: int = 0
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """-> True when this step straggled."""
        self.steps += 1
        if self.steps == 1:
            self.mean = dt
            self.var = 0.0
            return False
        straggle = False
        std = max(self.var, 1e-12) ** 0.5
        if dt > self.mean + self.threshold * std and dt > 1.5 * self.mean:
            straggle = True
            self.flagged.append((step, dt))
        # EWMA update (skip straggler samples so one hiccup doesn't mask
        # the next)
        if not straggle:
            delta = dt - self.mean
            self.mean += self.alpha * delta
            self.var = (1 - self.alpha) * (self.var
                                           + self.alpha * delta * delta)
        return straggle

    @property
    def p50_estimate(self) -> float:
        return self.mean


def run_with_restarts(make_trainer, total_steps: int, max_restarts: int = 10,
                      on_restart=None):
    """Supervisor: (re)build the trainer and run to ``total_steps``,
    restoring from checkpoints across failures.

    ``make_trainer(attempt) -> trainer`` must return an object with
    ``.resume() -> start_step`` and ``.run(start_step, total_steps)``.
    """
    attempt = 0
    while True:
        trainer = make_trainer(attempt)
        start = trainer.resume()
        try:
            trainer.run(start, total_steps)
            return trainer
        except SimulatedFailure as e:
            attempt += 1
            if attempt > max_restarts:
                raise RuntimeError("restart budget exhausted") from e
            if on_restart is not None:
                on_restart(attempt, e)
            time.sleep(0.01)  # backoff placeholder
