"""Max-batch/max-wait batching queue — the server's admission policy.

The serving loop amortizes one top-model step over every request that
arrives within a small window: a flush is triggered by whichever comes
first of (a) `max_batch` pending items, or (b) `max_wait` seconds elapsing
after the first pending item of the batch arrived. This is the standard
continuous-batching admission policy; the tradeoff knob is latency
(`max_wait`) against step efficiency (`max_batch` fill).

The port's copy of the reference's `runtime/batching.py`, on wall time;
its admission-control bound and virtual-clock hooks serve the open-loop
load generator, which is not ported yet.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, List, Optional


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

    `close()` wakes any waiter; once closed and drained, `get_batch`
    returns `[]` forever and `drained` is True.
    """

    def __init__(self, max_batch: int = 8, max_wait: float = 0.01):
        assert max_batch >= 1 and max_wait >= 0
        self.max_batch = max_batch
        self.max_wait = max_wait
        self._items: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._closed = False

    def put(self, item: Any) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("put() on closed BatchingQueue")
            self._items.append((time.monotonic(), item))
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

    def get_batch(self, idle_timeout: Optional[float] = None) -> List[Any]:
        idle = self.max_wait if idle_timeout is None else idle_timeout
        with self._cv:
            deadline = time.monotonic() + idle
            while not self._items and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._cv.wait(remaining)
            if not self._items:
                return []                       # closed and drained
            # flush max_wait after the FIRST pending item arrived
            deadline = self._items[0][0] + self.max_wait
            while len(self._items) < self.max_batch and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            n = min(self.max_batch, len(self._items))
            return [self._items.popleft()[1] for _ in range(n)]
