"""Recovery manager: checkpoint/restart with elastic mesh resharding (port
of ``repro/ft/recovery.py``).

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

``elastic_restore`` is the cross-mesh path: a checkpoint holds the
one-device format whatever mesh wrote it, and is cut to the blocks of a
*different* mesh's ranks (``ft.checkpoint.place``), or kept whole for one
device.

Under a mesh (``shardings=``, a ``distributed.sharding.TrainShardings``;
the manager's ``CheckpointManager`` takes the same) the reference's single
controller becomes one manager per rank, and a failure on one rank must
bring every rank back to the same checkpoint step without leaving the
others blocked in a collective. The ranks agree on a flag twice a step
(``world_all_true``): after each fetched its batch (a data-pipeline error
is rank-local) and after the step, its hooks and its watchdog (rank-local
too). A rank that failed raises its exception, the others
``PeerStepFailed``, and all restart together from the latest checkpoint.
The step itself is collective: an error inside it that only one rank
meets leaves the others waiting in the step's collectives, so a fault to
recover from belongs before or after it.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Iterator, Optional

from repro_torch.distributed.sharding import world_all_true
from repro_torch.ft.checkpoint import CheckpointManager, place, restore_into
from repro_torch.ft.watchdog import StepWatchdog

log = logging.getLogger("repro_torch.ft")


def elastic_restore(root, template, shardings, *, step: Optional[int] = None):
    """Restore a checkpoint onto (possibly) a different mesh.

    template: a whole (one-device) tree of the saved structure, whose
    tensors are filled in place; shardings: the new mesh's
    ``TrainShardings``, or None for one device. -> (step, the rank's
    state)."""
    step, host_tree = restore_into(template, root, step)
    return step, place(host_tree, shardings)


class PeerStepFailed(RuntimeError):
    """Another rank of the mesh failed this step; this one restarts with
    it."""


class RecoveryManager:
    def __init__(self, ckpt: CheckpointManager, *,
                 make_state: Callable[[], Any],
                 make_data: Callable[[int], Iterator],
                 max_restarts: int = 3,
                 watchdog: Optional[StepWatchdog] = None,
                 shardings: Any = None,
                 on_restart: Optional[Callable[[int, BaseException], None]] = None):
        self.ckpt = ckpt
        self.make_state = make_state
        self.make_data = make_data
        self.max_restarts = max_restarts
        self.watchdog = watchdog or StepWatchdog()
        self.shardings = shardings
        if shardings is not None and ckpt.shardings is None:
            ckpt.shardings = shardings
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

    def _agree(self, err: Optional[Exception]) -> None:
        """Under a mesh: raise on every rank if any rank failed (its own
        exception where it failed, ``PeerStepFailed`` elsewhere)."""
        if self.shardings is not None:
            if not world_all_true(err is None, self.shardings.mesh):
                raise err or PeerStepFailed("a peer rank failed this step")
        elif err is not None:
            raise err

    def _run_once(self, step_fn, num_steps, hooks):
        start_step, state = self._bootstrap()
        data = self.make_data(start_step)
        batches = iter(data)
        step = start_step
        saved = None
        try:
            while step < num_steps:
                err = None
                try:
                    batch = next(batches)
                except StopIteration:
                    break
                except Exception as e:
                    err = e
                self._agree(err)
                self.watchdog.start_step()
                state, metrics = step_fn(state, batch)
                try:
                    dur, slow = self.watchdog.end_step()
                    if slow:
                        log.warning("straggler step %d: %.3fs (median %.3fs)",
                                    step, dur, self.watchdog.median)
                    step += 1
                    self.metrics_log.append((step, metrics))
                    if hooks is not None:
                        hooks(step, state, metrics)
                except Exception as e:
                    err = e
                self._agree(err)
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
