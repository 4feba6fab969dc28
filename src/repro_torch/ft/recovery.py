"""Checkpoint/restart recovery of a training loop with deterministic data
replay (port of ``repro.ft.recovery``).

The failure model: a step raises (an injected fault, a device error) or
its loss is not finite; the loop restores the newest complete checkpoint
and replays from its step.  Replay is exact because the batch is a pure
function of the step (``repro_torch.data.pipeline``) and the step's
kernels are deterministic (the flash backward has no atomics), so a run
with faults ends bitwise where a run without them does.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Callable, Dict, Optional

from ..checkpoint import CheckpointManager

logger = logging.getLogger("repro_torch.ft")

__all__ = ["FaultInjector", "ResilientLoop"]


class FaultInjector:
    """Deterministic fault schedule for tests and demos: raise at the
    given steps, once each."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected fault at step {step}")


class ResilientLoop:
    """Run a train step with checkpoint/restart semantics.

    ``step_fn(state, batch) -> (state, metrics)`` (it may update the state
    in place), ``batch_fn(step) -> batch`` (pure in step).
    """

    def __init__(self, step_fn: Callable, batch_fn: Callable,
                 manager: CheckpointManager, *, checkpoint_every: int = 50,
                 max_restores: int = 8,
                 fault_injector: Optional[FaultInjector] = None,
                 straggler=None):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.manager = manager
        self.checkpoint_every = checkpoint_every
        self.max_restores = max_restores
        self.faults = fault_injector
        self.straggler = straggler
        self.restores = 0

    def run(self, state, *, start_step: int = 0, num_steps: int = 100,
            shardings=None, log_every: int = 0) -> Dict:
        """Returns ``{"state", "metrics", "restores", "step"}``.
        ``shardings`` places a restored state (elastic restore onto the
        current mesh, :meth:`CheckpointManager.restore_latest`)."""
        step = start_step
        metrics = {}
        while step < start_step + num_steps:
            try:
                if self.faults is not None:
                    self.faults.maybe_fail(step)
                t0 = time.perf_counter()
                batch = self.batch_fn(step)
                state, metrics = self.step_fn(state, batch)
                loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at {step}")
                if self.straggler is not None:
                    self.straggler.record(step, time.perf_counter() - t0)
                step += 1
                if log_every and step % log_every == 0:
                    logger.info("step %d loss %.4f", step, loss)
                if step % self.checkpoint_every == 0:
                    self.manager.save(state, step)
            except (RuntimeError, FloatingPointError) as e:
                self.restores += 1
                logger.warning("fault at step %d (%s); restoring (%d/%d)",
                               step, e, self.restores, self.max_restores)
                if self.restores > self.max_restores:
                    raise
                restored, ckpt_step = self.manager.restore_latest(
                    state, shardings=shardings)
                if restored is None:
                    raise RuntimeError("no checkpoint to restore") from e
                state, step = restored, ckpt_step
        self.manager.save(state, step, blocking=True)
        return {"state": state, "metrics": metrics,
                "restores": self.restores, "step": step}
