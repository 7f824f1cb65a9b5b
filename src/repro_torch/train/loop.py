"""Train loop: checkpoint and auto-resume, preemption, stragglers.

The reference's ``train/loop.py``:
  * auto-resume from the latest checkpoint;
  * periodic async checkpoints, and a final one when the manager's
    ``preempted`` flag is set (SIGTERM);
  * straggler watchdog: an EMA of the step's wall time; steps slower
    than ``straggler_factor`` x EMA are counted and logged.

The step's one host sync is the ``float(loss)`` read, which also ends
the step's timing window (the reference's ``block_until_ready``).
"""

from __future__ import annotations

import time
from typing import Callable, Iterator

from ..checkpoint import CheckpointManager

__all__ = ["TrainLoop"]


class TrainLoop:
    def __init__(self, step_fn: Callable, ckpt_dir: str, *,
                 ckpt_every: int = 100, keep: int = 3,
                 straggler_factor: float = 3.0,
                 log_every: int = 10,
                 log_fn: Callable[[str], None] = print):
        self.step_fn = step_fn
        self.mgr = CheckpointManager(ckpt_dir, keep=keep)
        self.ckpt_every = ckpt_every
        self.straggler_factor = straggler_factor
        self.log_every = log_every
        self.log = log_fn
        self.step_times: list[float] = []
        self.stragglers = 0

    def maybe_resume(self, state):
        step = self.mgr.latest_step()
        if step is None:
            return state, 0
        restored, step, _ = self.mgr.restore_latest(state)
        self.log(f"[resume] restored checkpoint at step {step}")
        return restored, step

    def run(self, state, batches: Iterator[dict], num_steps: int,
            start_step: int = 0):
        ema = None
        history = []
        for i in range(start_step, num_steps):
            batch = next(batches)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0

            # straggler watchdog
            if ema is None:
                ema = dt
            else:
                if dt > self.straggler_factor * ema and i > start_step + 2:
                    self.stragglers += 1
                    self.log(f"[straggler] step {i}: {dt:.3f}s vs EMA "
                             f"{ema:.3f}s")
                ema = 0.9 * ema + 0.1 * dt
            self.step_times.append(dt)

            history.append(loss)
            if i % self.log_every == 0:
                self.log(f"step {i:5d} loss {loss:.4f} "
                         f"({dt*1e3:.0f} ms/step)")

            if self.ckpt_every and (i + 1) % self.ckpt_every == 0:
                self.mgr.save(state, i + 1)

            if self.mgr.preempted:      # SIGTERM fault tolerance
                self.log(f"[preempt] checkpoint + exit at step {i + 1}")
                self.mgr.save(state, i + 1, blocking=True)
                break

        self.mgr.wait()
        return state, history
