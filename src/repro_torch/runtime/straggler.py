"""Straggler detection for the host-side step loop.

At fleet scale a straggling host shows up as a slow step (its collective
partners stall with it).  The monitor keeps an EMA of step wall time and
flags steps exceeding ``threshold x EMA``; the step loop's mitigation
ladder:

  1. log + count (always),
  2. after ``evict_after`` consecutive flags: signal the scheduler to
     replace the host (here: raise StragglerEvicted, which the step loop
     handles exactly like a failure — checkpoint-restore-continue).

Host-only: nothing here touches a tensor.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional


class StragglerEvicted(RuntimeError):
    pass


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 3.0
    decay: float = 0.9
    evict_after: int = 5
    warmup_steps: int = 2          # ignore the first steps' start-up cost

    ema_s: Optional[float] = None
    flagged: int = 0
    consecutive: int = 0
    steps: int = 0
    _t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        """Record one step; returns True if the step was flagged."""
        dt = time.perf_counter() - self._t0
        self.steps += 1
        if self.steps <= self.warmup_steps:
            return False
        if self.ema_s is None:
            self.ema_s = dt
            return False
        slow = dt > self.threshold * self.ema_s
        if slow:
            self.flagged += 1
            self.consecutive += 1
            self._emit("straggler", dt,
                       evict=self.consecutive >= self.evict_after)
            if self.consecutive >= self.evict_after:
                raise StragglerEvicted(
                    f"step took {dt:.3f}s vs EMA {self.ema_s:.3f}s "
                    f"({self.consecutive} consecutive flags)")
        else:
            self.consecutive = 0
            self.ema_s = self.decay * self.ema_s + (1 - self.decay) * dt
        return slow

    def _emit(self, ev: str, dt: float, **fields) -> None:
        from repro_torch.obs import trace
        trace.emit(ev, step=self.steps, wall_s=round(dt, 6),
                   ema_s=round(self.ema_s, 6),
                   consecutive=self.consecutive, **fields)
