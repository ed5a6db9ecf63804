"""Fault tolerance + straggler mitigation for long-running multi-pod jobs
(a copy of the reference's ``repro.runtime.fault_tolerance``; pure
Python).

On a real 1000+-node deployment, failures arrive hourly; the framework's
contract is: (1) never lose more than the last checkpoint interval, (2)
detect dead/slow hosts fast, (3) restart elastically on fewer/more hosts.
The pieces here are runnable single-process (tested), and each maps 1:1 to
its cluster-scale implementation:

  * :class:`Heartbeat` -- per-host liveness with monotonic deadlines.  In a
    cluster this is backed by a KV store (etcd/GCS); here, by a dict.
  * :class:`StragglerDetector` -- per-step timing z-tests.  Hosts whose
    step time exceeds ``threshold x`` the rolling median are flagged for
    preemptive replacement (before they become hard failures).
  * :class:`FailureSimulator` -- deterministic fault injection used by the
    integration tests to prove the trainer's checkpoint/restart loop heals.
  * :func:`retry_with_backoff` -- the wrapper around anything that touches
    cross-host I/O.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional

__all__ = ["Heartbeat", "StragglerDetector", "FailureSimulator",
           "retry_with_backoff"]


class Heartbeat:
    """Liveness tracking: hosts ping; anything silent past the timeout is
    declared dead and reported for eviction + elastic restart."""

    def __init__(self, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        self._last: Dict[str, float] = {}

    def ping(self, host: str) -> None:
        self._last[host] = self._clock()

    def dead_hosts(self) -> List[str]:
        now = self._clock()
        return [h for h, t in self._last.items()
                if now - t > self.timeout_s]

    def alive_hosts(self) -> List[str]:
        now = self._clock()
        return [h for h, t in self._last.items()
                if now - t <= self.timeout_s]


class StragglerDetector:
    """Rolling-median step-time watchdog.

    A host is a straggler if its last step took more than ``threshold``
    times the rolling median across hosts.  At scale this drives preemptive
    hot-spare swap-in; single-process it drives the trainer's metrics.
    """

    def __init__(self, window: int = 32, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self._times: Dict[str, deque] = {}

    def record(self, host: str, step_time_s: float) -> None:
        self._times.setdefault(host, deque(maxlen=self.window)).append(
            step_time_s)

    def _median(self, xs: List[float]) -> float:
        s = sorted(xs)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def global_median(self) -> Optional[float]:
        allt = [t for dq in self._times.values() for t in dq]
        return self._median(allt) if allt else None

    def stragglers(self) -> List[str]:
        med = self.global_median()
        if med is None or med <= 0:
            return []
        return [h for h, dq in self._times.items()
                if dq and dq[-1] > self.threshold * med]


@dataclasses.dataclass
class FailureSimulator:
    """Deterministic fault injection: raises at the configured steps."""

    fail_at_steps: tuple = ()
    error: type = RuntimeError
    _fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise self.error(f"injected failure at step {step}")


def retry_with_backoff(fn: Callable, max_retries: int = 3,
                       base_delay_s: float = 0.1,
                       retriable=(OSError, IOError, RuntimeError),
                       sleep: Callable[[float], None] = time.sleep):
    """Run ``fn()`` with exponential backoff on retriable errors."""
    last = None
    for attempt in range(max_retries + 1):
        try:
            return fn()
        except retriable as e:  # noqa: PERF203
            last = e
            if attempt == max_retries:
                raise
            sleep(base_delay_s * (2 ** attempt))
    raise last  # unreachable
