"""Injectable time source — real threads or deterministic simulation.

Every timing-dependent component of the serving runtime (`BatchingQueue`'s
max-wait flush deadline, `ArqClientMixin`'s retry timers, the loadgen's
arrival/transmission/service events) reads time through a `Clock` so the
same code runs in two modes:

  * `SystemClock` (the default, shared `SYSTEM_CLOCK` instance) — wall
    time + real condition-variable waits; the threaded production path is
    byte-identical to the pre-clock code.
  * `VirtualClock` — a simulated monotonic clock advanced explicitly by a
    single-threaded event loop (`runtime.loadgen`). Nothing ever sleeps:
    `sleep`/`cv_wait` advance the clock instead of blocking, so a
    thousand-session, minutes-long traffic trace runs in milliseconds and
    every timing race is a deterministic function of the seed.

The contract that keeps `BatchingQueue` correct under both: `monotonic()`
is non-decreasing, and `cv_wait(cv, timeout)` returns only when either the
condition variable was notified (SystemClock) or `timeout` simulated
seconds elapsed (VirtualClock — there is no other thread to notify, so a
wait can only mean "the deadline passed").

The port's copy of the reference's `testing/clock.py`.
"""
from __future__ import annotations

import threading
import time


class Clock:
    """Time-source interface; see `SystemClock` / `VirtualClock`."""

    def monotonic(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    def cv_wait(self, cv: threading.Condition, timeout: float) -> bool:
        """Wait on `cv` (held) for up to `timeout` seconds; returns the
        underlying `Condition.wait` result (False on timeout)."""
        raise NotImplementedError


class SystemClock(Clock):
    """Wall-clock time and real waits — the threaded production mode."""

    def monotonic(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)

    def cv_wait(self, cv: threading.Condition, timeout: float) -> bool:
        return cv.wait(timeout)


#: process-wide default — component constructors take `clock=SYSTEM_CLOCK`
SYSTEM_CLOCK = SystemClock()


class VirtualClock(Clock):
    """Simulated monotonic clock for single-threaded event-loop tests.

    The owner (an event loop, or a test) advances time explicitly with
    `advance`/`advance_to`; components under test read `monotonic()` and
    their deadline arithmetic behaves exactly as it would under wall time.
    `sleep`/`cv_wait` advance the clock by the full timeout — in a
    single-threaded simulation no other thread can produce work mid-wait,
    so a wait always runs to its deadline. A well-scheduled event loop
    never triggers them (it fires consumers exactly at their deadlines);
    they exist so a component that *does* wait stays terminating instead
    of deadlocking the simulation.
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self.waits = 0          # cv_wait calls observed (wake-thrash probe)

    def monotonic(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)

    def cv_wait(self, cv: threading.Condition, timeout: float) -> bool:
        self.waits += 1
        self.advance(max(0.0, timeout))
        return False            # nothing can notify mid-wait: pure timeout

    # -- simulation control --------------------------------------------------

    def advance(self, seconds: float) -> float:
        assert seconds >= 0, f"time cannot move backwards ({seconds})"
        self._now += seconds
        return self._now

    def advance_to(self, t: float) -> float:
        assert t >= self._now - 1e-9, \
            f"advance_to({t}) behind current time {self._now}"
        self._now = max(self._now, float(t))
        return self._now
