"""Frame-lifecycle tracing — nestable spans, instant events, Chrome export.

A `Tracer` records what the serving/training stack *did* as a flat list of
events that `obs.export` serializes into Chrome-trace-event JSON (loadable
in Perfetto or `chrome://tracing`). Two event shapes cover everything the
runtime needs:

  * spans — an interval with a name, a track, and args. Emitted either via
    the `span()` context manager (timestamps read from the injected
    `testing.clock.Clock` on entry/exit) or via `complete()` with explicit
    start/end times (how the server turns "this frame was enqueued at t0
    and flushed at t1" into a `server.queue_wait` span without the tracer
    ever blocking anything);
  * instants — a point event (`instant()`): QoS rung moves, ARQ
    retransmits/reconnects, admission rejections, slot admit/evict.

Time is *injected*: a tracer built over a `VirtualClock` (the loadgen
co-simulation) stamps virtual seconds, so two runs at the same seed write
byte-identical trace files — the determinism `tests/test_torch_obs.py`
pins, clean and under `FaultInjector` chaos, against the reference's own
file. Under the default `SystemClock` the
stamps are wall monotonic time and the trace shows real durations.

Tracks: Chrome traces group events by (pid, tid). The runtime's convention
puts the serve loop on tid `SERVE_TID` (0) and each
session on `session_tid(sid)` = sid + 1, so one session's whole lifecycle —
encode, send, queue wait, accept, plus its QoS/ARQ instants — reads as one
horizontal track in Perfetto, with the server's decode/step/reply spans on
the serve track above it. Events emitted without an explicit `tid` get a
stable per-thread id (assigned in first-use order, offset far above any
session track).

The disabled default is `NULL_TRACER`: every method is a no-op and `span()`
returns a single reusable null context manager, so an uninstrumented hot
path pays one attribute check (`tracer.enabled`) or one empty call.

On the card a span measures HOST time: a span around a kernel launch
closes when the launch is queued, not when the device finishes. Spans sit
where the reference puts them and no span synchronizes the device; the
server's `server.step` span ends at the token readback, which waits for
the device, so it covers the flush's device work.

The port's copy of the reference's `obs/trace.py`.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from repro_torch.testing.clock import Clock, SYSTEM_CLOCK

# -- span taxonomy ------------------------------------------------------------
# the seven frame-lifecycle stages, in wire order
SPAN_CLIENT_ENCODE = "client.encode"    # bottom step + payload pull to host
SPAN_WIRE_SEND = "client.send"          # framing + uplink transmission
SPAN_QUEUE_WAIT = "server.queue_wait"   # enqueue -> flush pickup
SPAN_DECODE = "server.decode"           # host staging + device decode
SPAN_STEP = "server.step"               # donated arena / fused top step
SPAN_REPLY = "server.reply"             # token framing + downlink send
SPAN_ARQ_ACCEPT = "client.arq_accept"   # reply classified + accepted by ARQ

LIFECYCLE_SPANS = (SPAN_CLIENT_ENCODE, SPAN_WIRE_SEND, SPAN_QUEUE_WAIT,
                   SPAN_DECODE, SPAN_STEP, SPAN_REPLY, SPAN_ARQ_ACCEPT)

# instant events
EVT_QOS_TRANSITION = "qos.transition"   # (k, bits) rung move
EVT_ARQ_RETRANSMIT = "arq.retransmit"   # timeout/error-triggered replay
EVT_ARQ_RECONNECT = "arq.reconnect"     # fresh connection onto the session
EVT_ADMISSION_REJECT = "admission.reject"   # arrival turned away
EVT_SLOT_ADMIT = "slot.admit"           # session pinned to an arena slot
EVT_SLOT_EVICT = "slot.evict"           # closed session's slot reclaimed

INSTANT_EVENTS = (EVT_QOS_TRANSITION, EVT_ARQ_RETRANSMIT, EVT_ARQ_RECONNECT,
                  EVT_ADMISSION_REJECT, EVT_SLOT_ADMIT, EVT_SLOT_EVICT)

#: the serve loop's track; sessions live on `session_tid(sid)`
SERVE_TID = 0
#: auto-assigned per-thread tracks start here, clear of any session id
_THREAD_TID_BASE = 1_000_000


def session_tid(sid: int) -> int:
    """Track id of session `sid` — one Perfetto row per session."""
    return sid + 1


class _NullSpan:
    """Reusable no-op context manager (`NULL_TRACER.span(...)` result)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer — the default everywhere. All methods are no-ops;
    hot paths additionally guard arg construction on `tracer.enabled`."""

    enabled = False

    def span(self, name: str, *, cat: str = "lifecycle",
             tid: Optional[int] = None, **args):
        return _NULL_SPAN

    def complete(self, name: str, t0: float, t1: float, *,
                 cat: str = "lifecycle", tid: Optional[int] = None,
                 **args) -> None:
        pass

    def instant(self, name: str, *, cat: str = "event",
                tid: Optional[int] = None, **args) -> None:
        pass

    def name_track(self, tid: int, name: str) -> None:
        pass

    def events(self) -> List[dict]:
        return []


#: process-wide disabled tracer; components default to this
NULL_TRACER = NullTracer()


class _Span:
    """Context manager emitted by `Tracer.span` — stamps entry/exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_tid", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 tid: Optional[int], args: dict):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._tid = tid
        self._args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = self._tracer._clock.monotonic()
        return self

    def __exit__(self, *exc):
        self._tracer.complete(self._name, self._t0,
                              self._tracer._clock.monotonic(),
                              cat=self._cat, tid=self._tid, **self._args)
        return False


class Tracer:
    """Collects span/instant events against an injected clock.

    Thread-safe: the threaded runtime appends from reader threads, client
    threads, and the serve loop; the single-threaded loadgen appends in
    event-loop order (which, with a `VirtualClock`, makes the exported
    JSON a deterministic function of the seed).
    """

    enabled = True

    def __init__(self, clock: Optional[Clock] = None, *, pid: int = 0):
        self._clock = SYSTEM_CLOCK if clock is None else clock
        self.pid = pid
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._thread_tids: Dict[int, int] = {}
        self._named_tracks: Dict[int, str] = {}

    # -- emission ------------------------------------------------------------

    def span(self, name: str, *, cat: str = "lifecycle",
             tid: Optional[int] = None, **args) -> _Span:
        """Nestable span: stamps the clock on enter and exit."""
        return _Span(self, name, cat, tid, args)

    def complete(self, name: str, t0: float, t1: float, *,
                 cat: str = "lifecycle", tid: Optional[int] = None,
                 **args) -> None:
        """Explicitly-timed span [t0, t1] — for intervals whose endpoints
        were observed elsewhere (queue wait, modeled service time)."""
        evt = {"name": name, "cat": cat, "ph": "X", "pid": self.pid,
               "tid": self._resolve_tid(tid), "ts": t0,
               "dur": max(0.0, t1 - t0)}
        if args:
            evt["args"] = args
        with self._lock:
            self._events.append(evt)

    def instant(self, name: str, *, cat: str = "event",
                tid: Optional[int] = None, **args) -> None:
        evt = {"name": name, "cat": cat, "ph": "i", "s": "t",
               "pid": self.pid, "tid": self._resolve_tid(tid),
               "ts": self._clock.monotonic()}
        if args:
            evt["args"] = args
        with self._lock:
            self._events.append(evt)

    def name_track(self, tid: int, name: str) -> None:
        """Label a (pid, tid) track — rendered as the row name in Perfetto.
        Idempotent: the first name wins."""
        with self._lock:
            if tid in self._named_tracks:
                return
            self._named_tracks[tid] = name
            self._events.append({"name": "thread_name", "ph": "M",
                                 "pid": self.pid, "tid": tid, "ts": 0.0,
                                 "args": {"name": name}})

    # -- inspection ----------------------------------------------------------

    def events(self) -> List[dict]:
        """Snapshot of the raw event list (ts/dur in clock seconds)."""
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    # -- internals -----------------------------------------------------------

    def _resolve_tid(self, tid: Optional[int]) -> int:
        if tid is not None:
            return tid
        ident = threading.get_ident()
        with self._lock:
            got = self._thread_tids.get(ident)
            if got is None:
                got = _THREAD_TID_BASE + len(self._thread_tids)
                self._thread_tids[ident] = got
            return got
