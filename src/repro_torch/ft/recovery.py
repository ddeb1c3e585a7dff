"""Recovery manager: checkpoint/restart (port of the single-device part of
``repro/ft/recovery.py``; restoring onto another mesh waits for
ROADMAP.md queue A item 9b, training under a mesh).

The contract with the train loop:

    rm = RecoveryManager(ckpt, make_state=..., make_data=..., max_restarts=3)
    final_state = rm.run(step_fn, num_steps)

* ``make_state()`` builds a fresh TrainState (cold start, and the template
  a checkpoint is restored into).
* ``make_data(start_step)`` rebuilds the deterministic data iterator at an
  arbitrary step (``data.DataPipeline`` is step-addressed, so a restart
  replays the exact stream).
* On an exception from ``step_fn`` the manager restores the latest
  checkpoint, rebuilds the iterator at that step and resumes, up to
  ``max_restarts`` times; then the exception propagates. ``Exception``
  only: an interrupt or exit is never retried.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Iterator, Optional

from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.ft.watchdog import StepWatchdog

log = logging.getLogger("repro_torch.ft")


class RecoveryManager:
    def __init__(self, ckpt: CheckpointManager, *,
                 make_state: Callable[[], Any],
                 make_data: Callable[[int], Iterator],
                 max_restarts: int = 3,
                 watchdog: Optional[StepWatchdog] = None,
                 on_restart: Optional[Callable[[int, BaseException], None]] = None):
        self.ckpt = ckpt
        self.make_state = make_state
        self.make_data = make_data
        self.max_restarts = max_restarts
        self.watchdog = watchdog or StepWatchdog()
        self.on_restart = on_restart
        self.restarts = 0
        self.metrics_log: list = []

    def _bootstrap(self):
        """Fresh state, or the latest checkpoint restored into it."""
        state = self.make_state()
        latest = self.ckpt.latest_step()
        if latest is None:
            return 0, state
        step, restored = self.ckpt.restore_into(state, latest)
        log.info("restored checkpoint at step %d", step)
        return step, restored

    def run(self, step_fn: Callable[[Any, Dict], Any], num_steps: int, *,
            hooks: Optional[Callable[[int, Any, Dict], None]] = None):
        """Run to ``num_steps`` global steps with restart-on-failure."""
        while True:
            try:
                return self._run_once(step_fn, num_steps, hooks)
            except Exception as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    log.error("max restarts exceeded (%d)", self.max_restarts)
                    raise
                if self.on_restart is not None:
                    self.on_restart(self.restarts, e)
                log.warning("step failed (%s: %s); restart %d/%d from latest "
                            "checkpoint", type(e).__name__, e, self.restarts,
                            self.max_restarts)
                self.ckpt.wait()

    def _run_once(self, step_fn, num_steps, hooks):
        start_step, state = self._bootstrap()
        data = self.make_data(start_step)
        step = start_step
        saved = None
        try:
            for batch in data:
                if step >= num_steps:
                    break
                self.watchdog.start_step()
                state, metrics = step_fn(state, batch)
                dur, slow = self.watchdog.end_step()
                if slow:
                    log.warning("straggler step %d: %.3fs (median %.3fs)",
                                step, dur, self.watchdog.median)
                step += 1
                self.metrics_log.append((step, metrics))
                if hooks is not None:
                    hooks(step, state, metrics)
                if self.ckpt.save(step, state, metadata={"wall": time.time()}):
                    saved = step
        finally:
            # always stop the prefetch thread: a restart would otherwise
            # leak one live producer per attempt
            close = getattr(data, "close", None)
            if close is not None:
                close()
        if saved != step:      # the last step's state is not on disk yet
            self.ckpt.save(step, state, metadata={"wall": time.time()}, force=True)
        self.ckpt.wait()
        return state
