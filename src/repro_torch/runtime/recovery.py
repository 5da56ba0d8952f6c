"""NaN/failure recovery loop: checkpoint-restart as a library function.
The port of the JAX package's `runtime/recovery.py`, its control flow
line for line.

run_resilient_loop drives any step function with:
  * periodic async checkpoints,
  * NaN/Inf loss detection -> roll back to the last checkpoint and skip
    the offending data step (the pipeline is stateless per step, so
    "skip" is sound and deterministic),
  * injected-fault hooks for tests (fail_at),
  * straggler monitoring via runtime.straggler.

This is the single-process core of the behaviour a multi-host launcher
replicates per host; see launch/train.py for the wiring.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.checkpoint import latest_step
from repro_torch.runtime.straggler import StepMonitor


@dataclasses.dataclass
class RecoveryPolicy:
    ckpt_every: int = 50
    max_rollbacks: int = 3
    skip_bad_step: bool = True


def run_resilient_loop(state, step_fn: Callable, data_fn: Callable,
                       *, num_steps: int, manager: CheckpointManager,
                       policy: RecoveryPolicy = RecoveryPolicy(),
                       monitor: StepMonitor | None = None,
                       fail_at: set[int] | None = None,
                       start_step: int = 0,
                       log: Callable[[str], None] = print):
    """Drives `state = step_fn(state, data_fn(step))` with recovery.

    Returns (state, history dict). `fail_at` injects a synthetic NaN loss
    at the given steps exactly once each (consumed), for testing. A
    rollback restores onto the devices and dtypes of the live state's
    leaves (`CheckpointManager.restore_latest` with it as the template).
    """
    fail_at = set(fail_at or ())
    rollbacks = 0
    skip: set[int] = set()
    history = {"loss": [], "rollbacks": 0, "skipped": [],
               "straggler_events": 0}
    # Checkpoint label semantics: "resume from this step". Guarantee a
    # restore point exists before the first step.
    if latest_step(manager.ckpt_dir) is None:
        manager.save(start_step, state, blocking=True)
    step = start_step
    while step < num_steps:
        if step in skip:
            step += 1
            continue
        if monitor:
            monitor.start()
        batch = data_fn(step)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        if step in fail_at:
            fail_at.discard(step)
            loss = float("nan")
        if monitor:
            ev = monitor.stop(step)
            if ev:
                history["straggler_events"] += 1
                log(f"[straggler] step {step}: {ev.duration:.3f}s vs "
                    f"median {ev.median:.3f}s")
        if math.isnan(loss) or math.isinf(loss):
            rollbacks += 1
            history["rollbacks"] = rollbacks
            if rollbacks > policy.max_rollbacks:
                raise RuntimeError(f"exceeded {policy.max_rollbacks} "
                                   "rollbacks; aborting")
            log(f"[recovery] non-finite loss at step {step}; restoring")
            state, meta = manager.restore_latest(state)
            if policy.skip_bad_step:
                skip.add(step)
                history["skipped"].append(step)
            step = int(meta["step"])  # label == resume step
            continue
        history["loss"].append(loss)
        if (step + 1) % policy.ckpt_every == 0 or step + 1 == num_steps:
            manager.save(step + 1, state, metadata={"loss": loss})
        step += 1
    manager.wait()
    return state, history
