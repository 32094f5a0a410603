"""Seeded fault injection for the framed byte wire — deterministic chaos.

`FaultyEndpoint` wraps a `runtime.transport.Endpoint` and mangles the byte
chunks crossing it in either direction, driven by a seeded `FaultPlan`:

  corrupt     flip one byte of a chunk (must surface as `wire.ChecksumError`
              at the receiver — never as a silently-wrong payload)
  truncate    cut a chunk short (desyncs the stream -> CRC/length failure)
  drop        the chunk never arrives (recovered by ARQ retransmission)
  duplicate   the chunk arrives twice (recovered by seq dedup)
  reorder     the chunk is held back and delivered after its successor (or
              at the next idle recv timeout, so a hold-back with no later
              traffic degrades to a late delivery, never a silent drop —
              except a final send on an endpoint that never receives again,
              which the engines' shutdown() backstop tolerates)
  rechunk     split a chunk at arbitrary boundaries (benign: exercises
              `FrameReader` reassembly, costs nothing to recover)

At most one fault applies per chunk, drawn from a per-connection
`random.Random` seeded by (plan.seed, client id, connection index), so a
chaos run is reproducible chunk-for-chunk. Destructive faults share a
bounded budget (`plan.max_faults`) so every run terminates: once spent, the
wire goes clean and the ARQ layer drains the damage.

`FaultInjector` is the `wrap_endpoint` hook `runtime.engine.run_streaming`
accepts (the port's fedtrain takes no `wrap_endpoint` yet): it wraps
every client-side connection — initial and reconnect — and aggregates the
injected-fault counters that `tests/test_torch_faults.py` checks against
the engine's detected-fault counters. Its draws are the reference's
`random.Random` formulas, so a plan mangles a byte stream chunk for chunk
as the reference's does.

The port's copy of the reference's `testing/faults.py`.
"""
from __future__ import annotations

import collections
import dataclasses
import random
import threading
from typing import List, Optional

from repro_torch.runtime.transport import Endpoint

#: fault kinds that damage the stream and consume the shared budget
DESTRUCTIVE_FAULTS = ("corrupt", "truncate", "drop", "duplicate", "reorder")
#: all fault kinds, in the order probabilities are drawn
FAULT_KINDS = DESTRUCTIVE_FAULTS + ("rechunk",)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Per-chunk fault probabilities + the seed that makes them replayable.

    Probabilities are independent per chunk and at most one fault fires per
    chunk (drawn cumulatively in `FAULT_KINDS` order). `max_faults` bounds
    the total destructive faults across every connection of one
    `FaultInjector`, guaranteeing the chaos run terminates.
    """

    seed: int = 0
    corrupt: float = 0.0
    truncate: float = 0.0
    drop: float = 0.0
    duplicate: float = 0.0
    reorder: float = 0.0
    rechunk: float = 0.0
    max_faults: int = 64

    def any_destructive(self) -> bool:
        return any(getattr(self, f) > 0 for f in DESTRUCTIVE_FAULTS)


class _Budget:
    """Thread-safe countdown of destructive faults left to inject."""

    def __init__(self, n: int):
        self._n = n
        self._lock = threading.Lock()

    def take(self) -> bool:
        with self._lock:
            if self._n <= 0:
                return False
            self._n -= 1
            return True


class FaultyEndpoint(Endpoint):
    """An `Endpoint` whose chunks pass through the fault plan.

    The up direction is mangled at `send`, the down direction at
    `recv_chunk` (before the `FrameReader` sees the bytes), so one wrapper
    on the client half subjects both directions of the channel to chaos —
    servers stay untouched. `injected` counts every fault actually applied,
    by kind.
    """

    def __init__(self, inner: Endpoint, plan: FaultPlan,
                 rng: Optional[random.Random] = None,
                 budget: Optional[_Budget] = None):
        super().__init__(inner._out, inner._in)
        self._plan = plan
        self._rng = rng or random.Random(plan.seed)
        self._budget = budget or _Budget(plan.max_faults)
        self.injected: collections.Counter = collections.Counter()
        self._tx_delayed: Optional[bytes] = None    # reorder hold-back slots
        self._rx_delayed: Optional[bytes] = None
        self._rx_stash: collections.deque = collections.deque()

    # -- fault application ---------------------------------------------------

    def _draw_fault(self, chunk: bytes) -> Optional[str]:
        if len(chunk) < 2:
            return None
        r = self._rng.random()
        for name in FAULT_KINDS:
            prob = getattr(self._plan, name)
            if r < prob:
                if name in DESTRUCTIVE_FAULTS and not self._budget.take():
                    return None
                return name
            r -= prob
        return None

    def _mangle(self, chunk: bytes, delayed_attr: str) -> List[bytes]:
        """Apply at most one fault; returns the chunks to deliver now."""
        rng = self._rng
        fault = self._draw_fault(chunk)
        out: List[bytes]
        if fault == "corrupt":
            b = bytearray(chunk)
            b[rng.randrange(len(b))] ^= rng.randint(1, 255)
            out = [bytes(b)]
        elif fault == "truncate":
            out = [chunk[: rng.randrange(1, len(chunk))]]
        elif fault == "drop":
            out = []
        elif fault == "duplicate":
            out = [chunk, chunk]
        elif fault == "reorder":
            if getattr(self, delayed_attr) is None:
                setattr(self, delayed_attr, chunk)
                out = []                # held back until the next chunk
            else:
                fault = None            # one hold-back slot per direction
                out = [chunk]
        elif fault == "rechunk":
            cuts = sorted(rng.randrange(1, len(chunk))
                          for _ in range(rng.randint(1, 3)))
            bounds = [0] + cuts + [len(chunk)]
            out = [chunk[a:b] for a, b in zip(bounds, bounds[1:]) if a < b]
        else:
            out = [chunk]
        if fault is not None:
            self.injected[fault] += 1
        # a held-back chunk is released right after the chunk that overtook it
        if fault != "reorder" and getattr(self, delayed_attr) is not None:
            out = out + [getattr(self, delayed_attr)]
            setattr(self, delayed_attr, None)
        return out

    # -- Endpoint overrides --------------------------------------------------

    def send(self, frame_bytes: bytes) -> int:
        for chunk in self._mangle(bytes(frame_bytes), "_tx_delayed"):
            super().send(chunk)
        return len(frame_bytes)     # sender accounting sees the clean length

    def recv_chunk(self, timeout: Optional[float] = None) -> Optional[bytes]:
        if self._rx_stash:
            return self._rx_stash.popleft()
        chunk = super().recv_chunk(timeout=timeout)
        if chunk is None:
            # idle moment: flush any reorder-held chunk so a hold-back
            # with no successor degrades to a late delivery, not a drop
            if self._rx_delayed is not None:
                chunk, self._rx_delayed = self._rx_delayed, None
                return chunk
            if self._tx_delayed is not None:
                held, self._tx_delayed = self._tx_delayed, None
                Endpoint.send(self, held)
                return b""          # released upstream; keep waiting
            return None
        out = self._mangle(chunk, "_rx_delayed")
        if not out:
            return b""              # dropped: an empty feed, not a timeout
        self._rx_stash.extend(out[1:])
        return out[0]


class FaultInjector:
    """`wrap_endpoint` hook: deterministic chaos across every connection.

    Each wrapped connection draws from its own RNG seeded by
    (plan.seed, cid, per-client connection index) — reconnect replays a
    *different* fault stream, so a corrupted retry cannot loop forever —
    while all connections share one destructive-fault budget.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._budget = _Budget(plan.max_faults)
        self._conn_counts: collections.Counter = collections.Counter()
        self._lock = threading.Lock()
        self.endpoints: List[FaultyEndpoint] = []

    def __call__(self, cid: int, endpoint: Endpoint) -> FaultyEndpoint:
        with self._lock:
            conn = self._conn_counts[cid]
            self._conn_counts[cid] += 1
        rng = random.Random(self.plan.seed * 1_000_003 + cid * 8191 + conn)
        fep = FaultyEndpoint(endpoint, self.plan, rng=rng,
                             budget=self._budget)
        with self._lock:
            self.endpoints.append(fep)
        return fep

    def injected(self) -> collections.Counter:
        """Total faults injected so far, by kind, across all connections."""
        with self._lock:
            total: collections.Counter = collections.Counter()
            for ep in self.endpoints:
                total.update(ep.injected)
            return total

    @property
    def connections(self) -> int:
        with self._lock:
            return sum(self._conn_counts.values())
