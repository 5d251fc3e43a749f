"""Elastic execution: failure detection, straggler mitigation, restart from
checkpoint (the port of ``repro/runtime/elastic.py``).

On a real fleet the runtime watches per-step heartbeats; when a host dies
(or a pod is reclaimed by the WaterWise scheduler for migration), training
restarts from the latest atomic checkpoint. This module provides the
control-plane pieces that are hardware-independent and therefore fully
testable on the CPU:

  StepWatchdog      deadline per step; a straggling/hung step raises and
                    triggers restart-from-checkpoint (synchronous SPMD makes
                    one straggler everyone's straggler — detect & evict).
  FailureInjector   deterministic fault schedule for tests/simulations.
  run_elastic       the restart loop: run → (maybe) crash → restore → rerun,
                    preserving exactly-once step accounting.

The restore re-shards every leaf onto the current mesh where
``shardings`` says how (``checkpoint.restore_checkpoint``), so a job can
resume on another mesh shape, as the reference's does; otherwise each
tensor leaf comes back onto the device its leaf in the running state lies
on.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.runtime.sharding import is_dtensor


class StepWatchdog:
    """Flags steps that exceed ``deadline_s`` (straggler mitigation)."""

    def __init__(self, deadline_s: float):
        self.deadline_s = deadline_s
        self.history: List[float] = []

    def observe(self, step_time_s: float) -> bool:
        self.history.append(step_time_s)
        return step_time_s > self.deadline_s

    @property
    def p50(self) -> float:
        h = sorted(self.history)
        return h[len(h) // 2] if h else 0.0


@dataclasses.dataclass
class FailureInjector:
    """Deterministic crash schedule: fail right after the listed steps."""
    fail_after_steps: tuple = ()
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_after_steps and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")


def _like(restored, state):
    """``restored`` (numpy leaves, and bf16 CPU tensors where the state is
    bf16) in ``state``'s leaf types: a tensor leaf comes back as a tensor on
    that leaf's device, a Python int or float (AdamW's step count) as one;
    dicts, lists, tuples and named tuples keep their kind."""
    if isinstance(state, dict):
        return {k: _like(restored[k], state[k]) for k in state}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_like(r, s) for r, s in zip(restored, state)))
    if isinstance(state, (list, tuple)):
        return type(state)(_like(r, s) for r, s in zip(restored, state))
    if isinstance(restored, torch.Tensor) and is_dtensor(restored):
        return restored
    if isinstance(state, torch.Tensor):
        return torch.as_tensor(restored).to(state.device)
    if isinstance(state, (int, float)) and not isinstance(state, bool):
        return type(state)(restored)
    return restored


def run_elastic(state, step_fn: Callable, batch_fn: Callable, *,
                num_steps: int, ckpt_dir: str, ckpt_every: int = 10,
                shardings=None, injector: Optional[FailureInjector] = None,
                watchdog: Optional[StepWatchdog] = None,
                max_restarts: int = 10) -> Dict:
    """Run ``num_steps`` of ``state = step_fn(state, batch, step)`` with
    checkpoint/restart. ``state`` is a tree of dicts, lists and tuples
    whose leaves are tensors, DTensors or arrays; ``shardings`` (as
    ``restore_checkpoint`` takes it: (mesh, placements) leaves) places
    each restored leaf on the current mesh. With DTensor leaves every rank
    runs this loop in step, with the same failures.
    Returns dict(state, restarts, steps_run), and beside them ``causes``
    (each restart's exception, as text) and ``commits`` (the
    checkpointer's records: step, bytes, copy and write seconds)."""
    ckpt = AsyncCheckpointer(ckpt_dir, every=ckpt_every)
    causes = []
    restarts = 0
    step = 0
    steps_run = 0
    while step < num_steps:
        try:
            t0 = time.perf_counter()
            state = step_fn(state, batch_fn(step), step)
            dt = time.perf_counter() - t0
            if watchdog is not None and watchdog.observe(dt):
                raise TimeoutError(f"straggling step {step}: {dt:.3f}s")
            steps_run += 1
            step += 1
            ckpt.maybe_save(step, state)
            if injector is not None:
                injector.check(step)
        except (RuntimeError, TimeoutError) as err:
            causes.append(f"{type(err).__name__}: {err}")
            restarts += 1
            if restarts > max_restarts:
                raise
            ckpt.wait()
            last = latest_step(ckpt_dir)
            if last is not None:
                state = _like(restore_checkpoint(ckpt_dir, last, state,
                                                 shardings), state)
                step = last
            else:
                step = 0
    ckpt.wait()
    return dict(state=state, restarts=restarts, steps_run=steps_run,
                causes=causes, commits=ckpt.commits)
