"""Fault tolerance: straggler detection, failure injection, restart loop,
copied from the reference's ``train/ft.py`` onto the port's checkpoints.

At 1000+ nodes the failure model is "some step will die / stall every few
hours".  The pieces here:

* ``StragglerMonitor`` — rolling-median step timing; a step slower than
  ``threshold x median`` is flagged (at pod scale the action is to page the
  scheduler / trigger preemptive checkpoint; here we record + callback).
* ``run_with_restarts`` — the crash-safe training driver: on any step
  exception it restores the latest complete checkpoint and resumes.  Because
  the data pipeline is a pure function of (seed, step) and checkpoints are
  atomic, the post-restart trajectory is bit-identical to an uninterrupted
  run (tests/test_torch_train.py holds it bit for bit).
* ``FailureInjector`` — deterministic fault injection for tests/drills.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch.train import checkpoint as ckpt

__all__ = ["StragglerMonitor", "FailureInjector", "run_with_restarts"]


class StragglerMonitor:
    def __init__(self, threshold: float = 3.0, window: int = 32,
                 min_seconds: float = 0.05,
                 on_straggler: Callable[[int, float, float], None] | None = None):
        self.threshold = threshold
        self.window = window
        self.min_seconds = min_seconds
        self.on_straggler = on_straggler
        self.times: list[float] = []
        self.flagged: list[int] = []

    def record(self, step: int, seconds: float) -> bool:
        hist = self.times[-self.window:]
        is_straggler = False
        if len(hist) >= 8:
            med = sorted(hist)[len(hist) // 2]
            if seconds > self.threshold * med and seconds > self.min_seconds:
                is_straggler = True
                self.flagged.append(step)
                if self.on_straggler:
                    self.on_straggler(step, seconds, med)
        self.times.append(seconds)
        return is_straggler


@dataclasses.dataclass
class FailureInjector:
    """Raise at the given steps — once each (simulated node failure)."""
    fail_at: tuple[int, ...] = ()
    _fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")


def run_with_restarts(*, total_steps: int, ckpt_dir: str, make_state,
                      restore_state, step_fn, save_every: int = 10,
                      keep: int = 3, max_restarts: int = 10,
                      injector: FailureInjector | None = None,
                      monitor: StragglerMonitor | None = None):
    """Crash-safe driver.

    make_state() -> fresh state pytree (step 0);
    restore_state(step, template) -> state at ``step`` (from checkpoint);
    step_fn(step, state) -> (state, metrics) — one training step.

    Returns (state, history list of (step, metrics), n_restarts).
    """
    restarts = 0
    history: list = []
    while True:
        last = ckpt.latest_step(ckpt_dir)
        if last is None:
            state, step = make_state(), 0
        else:
            state, step = restore_state(last, make_state()), last
        try:
            while step < total_steps:
                t0 = time.monotonic()
                if injector is not None:
                    injector.maybe_fail(step)
                state, metrics = step_fn(step, state)
                dt = time.monotonic() - t0
                if monitor is not None:
                    monitor.record(step, dt)
                history.append((step, metrics))
                step += 1
                if step % save_every == 0 or step == total_steps:
                    ckpt.save(ckpt_dir, step, state, keep=keep)
            return state, history, restarts
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            # fall through: restore from the latest complete checkpoint
