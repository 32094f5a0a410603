"""Max-batch/max-wait batching queue — the server's admission policy.

The serving loop amortizes one top-model step over every request that
arrives within a small window: a flush is triggered by whichever comes
first of (a) `max_batch` pending items, or (b) `max_wait` seconds elapsing
after the first pending item of the batch arrived. This is the standard
continuous-batching admission policy; the tradeoff knob is latency
(`max_wait`) against step efficiency (`max_batch` fill).

Two serving-scale extensions:

  * admission control — `max_depth` bounds the pending backlog; a `put`
    that would exceed it raises `QueueFull` so the caller can reject the
    request instead of letting queueing delay grow without bound (an
    open-loop arrival process at rate > service capacity otherwise builds
    an unbounded queue and every session's latency diverges);
  * time injection — all deadline arithmetic goes through a
    `testing.clock.Clock`, so the identical flush policy runs under real
    threads (`SYSTEM_CLOCK`, the default — behavior unchanged) or under a
    `VirtualClock` event loop (`runtime.loadgen`), where `next_flush_at`
    tells the loop exactly when the policy wants its next flush.

The port's copy of the reference's `runtime/batching.py`.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, List, Optional

from repro_torch.testing.clock import Clock, SYSTEM_CLOCK


class QueueFull(RuntimeError):
    """Admission-control rejection: the queue is at `max_depth`."""


class BatchingQueue:
    """Thread-safe queue with a max-batch/max-wait flush policy.

    Producers call `put`; the single consumer calls `get_batch`, which
    returns between 0 and `max_batch` items:

      * empty queue: block up to `idle_timeout` (default `max_wait`) for a
        first item; return `[]` if none arrives (the caller's idle tick).
      * >= 1 item pending: wait at most `max_wait` from the first pending
        item for the batch to fill, then flush whatever is there (the
        ragged final batch of a draining session mix is returned short).
      * `max_batch` items pending: flush immediately.

    `max_depth` (optional) bounds the backlog: `put` raises `QueueFull`
    instead of exceeding it. `close()` wakes any waiter; once closed and
    drained, `get_batch` returns `[]` forever and `drained` is True.
    """

    def __init__(self, max_batch: int = 8, max_wait: float = 0.01,
                 max_depth: Optional[int] = None,
                 clock: Clock = SYSTEM_CLOCK):
        assert max_batch >= 1 and max_wait >= 0
        assert max_depth is None or max_depth >= max_batch
        self.max_batch = max_batch
        self.max_wait = max_wait
        self.max_depth = max_depth
        self.clock = clock
        self._items: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._closed = False

    def put(self, item: Any) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("put() on closed BatchingQueue")
            if (self.max_depth is not None
                    and len(self._items) >= self.max_depth):
                raise QueueFull(
                    f"BatchingQueue at max_depth={self.max_depth}")
            self._items.append((self.clock.monotonic(), item))
            # wake the consumer only when its behavior can change: the
            # first pending item (starts the max_wait deadline) and the
            # fill-completing item (flush now). Intermediate puts would
            # each bounce the single consumer awake just to recompute an
            # unchanged deadline — measurable thrash when producers and
            # the serve loop time-slice one core.
            n = len(self._items)
            if n == 1 or n >= self.max_batch:
                self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    @property
    def drained(self) -> bool:
        with self._cv:
            return self._closed and not self._items

    def __len__(self) -> int:
        with self._cv:
            return len(self._items)

    def next_flush_at(self) -> Optional[float]:
        """When the flush policy next wants `get_batch` called: None if
        nothing is pending, "now" if a full batch is already waiting, else
        the first pending item's max_wait deadline. A virtual-clock event
        loop schedules its flush event here and `get_batch(idle_timeout=0)`
        then returns the batch without ever waiting."""
        with self._cv:
            if not self._items:
                return None
            if len(self._items) >= self.max_batch:
                return self.clock.monotonic()
            return self._items[0][0] + self.max_wait

    def get_batch(self, idle_timeout: Optional[float] = None) -> List[Any]:
        idle = self.max_wait if idle_timeout is None else idle_timeout
        with self._cv:
            deadline = self.clock.monotonic() + idle
            while not self._items and not self._closed:
                remaining = deadline - self.clock.monotonic()
                if remaining <= 0:
                    return []
                self.clock.cv_wait(self._cv, remaining)
            if not self._items:
                return []                       # closed and drained
            # flush max_wait after the FIRST pending item arrived
            deadline = self._items[0][0] + self.max_wait
            while len(self._items) < self.max_batch and not self._closed:
                remaining = deadline - self.clock.monotonic()
                if remaining <= 0:
                    break
                self.clock.cv_wait(self._cv, remaining)
            n = min(self.max_batch, len(self._items))
            return [self._items.popleft()[1] for _ in range(n)]
