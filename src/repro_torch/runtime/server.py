"""Streaming server — the label owner serving N concurrent sessions.

One reader thread per connection parses `core.wire` frames off the byte
transport and feeds a `BatchingQueue`; the single serve loop flushes the
queue under the max-batch/max-wait policy and drives the device-resident
slot arena (`runtime.arena.SlotArena`):

  * each session holds one arena slot while it is resident (FIFO free
    deque; a closed session's slot is reset and reused). A full arena
    reclaims a closed session's slot, else (`evict_idle`) moves the least
    recently active idle session's row to the host — the session
    re-admits on its next frame with its exact KV and position — and only
    waits, then raises, when every slot holds a session with a frame in
    flight;
  * each flush, the wire leaves are staged into cached per-(meta, bucket)
    host buffers in the kernels' 32-bit dtypes, padded to the nearest
    power-of-two flush bucket with zero rows aimed at the scratch slot —
    the host touches only the compressed leaves, never a dense activation;
  * a single-meta flush runs the fused step (`steps.make_fused_decode_step`:
    decode kernel into `xbuf[slots]`, then the whole-arena top step);
    a mixed-meta flush decodes per meta, then runs the top step once.

Token replies stream back as frames; per-session byte accounting comes
from the real frame sizes. The connection plumbing (reader threads, the
error frame and retired connection for a malformed frame, the session
registry, the queue-close lifecycle, and `pump`, the single-threaded
reader of the load generator) is `FrameServerBase`, which the training
server (`fedtrain.server.TrainingServer`) shares.

Time goes through an injected `testing.clock.Clock` (the admission wait,
the batching deadlines, the LRU stamps), so the same server runs under
real threads or the load generator's virtual clock. The registry counters
and tracer spans and instants are the reference's; on the card a span
measures host time (`obs.trace`).

Fault tolerance: a malformed frame (a typed `wire.WireError`) makes the
reader reply with an `error` frame and retire the connection; the session
survives, and the client reconnects and replays from its last
unacknowledged sequence number. Stop-and-wait dedup (`Session.last_seq` /
`last_reply`) re-acks a replayed frame without re-running the step, so a
KV cache never double-advances, across an eviction too.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import wire
from repro_torch.core.payload import Payload, device_leaf
from repro_torch.obs.registry import DEFAULT_REGISTRY, MetricsRegistry
from repro_torch.obs.trace import (EVT_SLOT_ADMIT, EVT_SLOT_EVICT,
                                   NULL_TRACER, SERVE_TID, SPAN_DECODE,
                                   SPAN_QUEUE_WAIT, SPAN_REPLY, SPAN_STEP,
                                   session_tid)
from repro_torch.runtime import steps
from repro_torch.runtime.arena import SlotArena
from repro_torch.runtime.batching import BatchingQueue
from repro_torch.runtime.session import Session
from repro_torch.split import protocol
from repro_torch.testing.clock import Clock, SYSTEM_CLOCK

#: `Session.host_state` between the LRU-eviction decision (reader thread,
#: under the server lock) and the serve loop's fetch of the row to the
#: host — "evicted, state still on the device". A frame arriving in that
#: window re-admits the session; the FIFO arena-op queue runs the fetch
#: before the restore, so the restore always writes real host state.
_EVICTING = object()


class FrameServerBase:
    """Connection plumbing shared by the serving and training servers: one
    reader thread per attached channel (or `pump` from a single-threaded
    event loop), an `error` frame and a retired connection for a malformed
    frame (never a dead thread), a session registry that survives
    reconnects, and the queue-close lifecycle.

    Subclasses call `_init_connections` from `__init__`, implement
    `_new_session(sid, endpoint)` (called under the lock), and set
    `direction` (the label protocol violations are reported under)."""

    direction = "serving"

    def _init_connections(self, queue: BatchingQueue, tracer=NULL_TRACER,
                          registry: Optional[MetricsRegistry] = None
                          ) -> None:
        self.queue = queue
        self.sessions: Dict[int, Session] = {}
        self._lock = threading.Lock()
        # admissions waiting for an arena slot wait here; notified on
        # session close and after every flush
        self._slot_cv = threading.Condition(self._lock)
        self._readers: List[threading.Thread] = []
        self._open_readers = 0
        self.errors: List[BaseException] = []   # reader-thread failures
        self.faults_detected = 0    # malformed frames rejected
        self.expected_sessions = 0  # set by the engine: the serve loop must
        #   not stop before this many sessions exist AND closed (a corrupt
        #   first frame can retire a connection before its session exists)
        self.tracer = tracer
        self.registry = registry if registry is not None else DEFAULT_REGISTRY
        # pre-bound per-frame instruments: the hot paths pay a lock + add,
        # never a registry lookup
        reg = self.registry
        self._m_frames_up = reg.counter("frames_total", party="server",
                                        direction="up")
        self._m_payload_up = reg.counter("payload_bytes_total",
                                         party="server", direction="up")
        self._m_framing_up = reg.counter("framing_bytes_total",
                                         party="server", direction="up")
        self._m_frames_down = reg.counter("frames_total", party="server",
                                          direction="down")
        self._m_bytes_down = reg.counter("wire_bytes_total", party="server",
                                         direction="down")
        self._m_faults = reg.counter("faults_detected_total", party="server")
        self._m_dups = reg.counter("duplicates_total", party="server")
        self._m_fill = reg.histogram("flush_fill")
        self._m_qwait = reg.histogram("queue_wait_ms")
        self._m_depth = reg.gauge("queue_depth")
        # (sid, seq) -> enqueue clock time; popped at flush into the
        # `server.queue_wait` span and the `queue_wait_ms` histogram
        self._enq_ts: Dict = {}

    def _new_session(self, sid: int, endpoint) -> Session:
        raise NotImplementedError

    def _before_enqueue(self, sess: Session) -> None:
        """Hook run after a payload frame is accepted, before it enters the
        queue: the serving server pins the session's device row and counts
        the frame in flight; the training server needs neither."""

    def _count_frame_up(self, sess: Session, frame) -> None:
        sess.stats.count_up(frame.header_nbytes, frame.payload_nbytes)
        self._m_frames_up.inc()
        self._m_payload_up.inc(frame.payload_nbytes)
        self._m_framing_up.inc(frame.header_nbytes)

    def _enqueue(self, sess: Session, frame) -> None:
        """Stamp a frame, then queue it. The stamp goes first: written after
        the put, it could land after the loop had flushed the frame and
        popped nothing, and stay for good. A refused put takes its stamp
        back."""
        key = (sess.id, frame.seq)
        self._enq_ts[key] = self.queue.clock.monotonic()
        try:
            self.queue.put((sess, frame))
        except BaseException:
            self._enq_ts.pop(key, None)
            raise

    def _observe_queue_wait(self, items) -> float:
        """Pop the enqueue stamp of every frame a flush picked up (replays
        the dedup drops included: they waited too) into the `queue_wait_ms`
        histogram and, when tracing, a `server.queue_wait` span; set
        `queue_depth`. Returns the flush's clock time."""
        t_flush = self.queue.clock.monotonic()
        trace = self.tracer.enabled
        for sess, frame in items:
            t_enq = self._enq_ts.pop((sess.id, frame.seq), None)
            if t_enq is None:
                continue
            self._m_qwait.observe((t_flush - t_enq) * 1e3)
            if trace:
                self.tracer.complete(SPAN_QUEUE_WAIT, t_enq, t_flush,
                                     tid=session_tid(sess.id), sid=sess.id,
                                     seq=frame.seq)
        self._m_depth.set(len(self.queue))
        return t_flush

    def _count_frame_down(self, sess: Session, nbytes: int) -> None:
        sess.stats.count_down(nbytes)
        self._m_frames_down.inc()
        self._m_bytes_down.inc(nbytes)

    def attach(self, endpoint) -> threading.Thread:
        """Register a client channel and start its frame-reader thread
        (once per client, and again for each reconnect)."""
        with self._lock:
            self._open_readers += 1
        t = threading.Thread(target=self._read_loop, args=(endpoint,),
                             daemon=True)
        self._readers.append(t)
        t.start()
        return t

    def shutdown(self) -> None:
        """Close the admission queue; the processing loop drains, then
        exits. The engine's backstop after every client finished, even if
        a CLOSE frame was lost to injected faults."""
        self.queue.close()

    def _reject(self, endpoint, sid_seen, exc: wire.WireError) -> None:
        """Name the defect in an error frame and retire the connection,
        keeping the session."""
        with self._lock:
            self.faults_detected += 1
            sess = (self.sessions.get(sid_seen)
                    if sid_seen is not None else None)
            if sess is not None:
                sess.stats.faults_detected += 1
        self._m_faults.inc()
        endpoint.send(wire.encode_error_frame(
            sid_seen if sid_seen is not None else 0, 0,
            wire.error_code(exc), str(exc)))

    def _close_session(self, sid: int) -> None:
        with self._lock:
            if sid in self.sessions:
                self.sessions[sid].closed = True
            self._slot_cv.notify_all()

    def _admit_frame(self, frame, endpoint) -> Session:
        """The session of one payload frame, with the frame counted and the
        session pinned for it (next: the queue)."""
        sess = self._session_for(frame.session, endpoint)
        self._count_frame_up(sess, frame)
        self._before_enqueue(sess)
        return sess

    def _read_loop(self, endpoint) -> None:
        sid_seen = None             # session observed on THIS connection
        try:
            while True:
                try:
                    frame = endpoint.recv_frame(timeout=0.1)
                except wire.WireError as e:
                    self._reject(endpoint, sid_seen, e)
                    return
                if frame is None:
                    continue
                if frame.kind == wire.FRAME_CLOSE:
                    self._close_session(frame.session)
                    return
                if frame.kind == wire.FRAME_ERROR:
                    return              # peer abandoned this connection
                if frame.kind != wire.FRAME_PAYLOAD:
                    raise wire.WireError(
                        f"unexpected frame kind {frame.kind} on the "
                        f"{self.direction} up direction")
                sid_seen = frame.session
                sess = self._admit_frame(frame, endpoint)
                try:
                    self._enqueue(sess, frame)
                except RuntimeError:
                    return              # server shut down under us
        except wire.WireError as e:     # protocol violation from a valid frame
            self._reject(endpoint, sid_seen, e)
        except BaseException as e:      # surfaced by the engine
            with self._lock:
                self.errors.append(e)
        finally:
            with self._lock:
                self._open_readers -= 1
                done = (self._open_readers == 0
                        and len(self.sessions) >= self.expected_sessions
                        and all(s.closed for s in self.sessions.values()))
            if done:
                self.queue.close()

    def pump(self, endpoint, sid_seen: Optional[int] = None):
        """Single-threaded counterpart of `_read_loop`: drain every frame
        now available on `endpoint` without blocking, enqueueing payload
        frames as the reader thread would.

        Returns `(status, sid_seen)`: `"open"` (pump this connection again
        later), `"retired"` (a malformed frame was rejected with an error
        frame, or the peer abandoned the connection; the session survives
        for a reconnect) or `"closed"` (the session's CLOSE arrived). Pass
        `sid_seen` back on the next pump of the same connection, so a
        fault is charged to the right session."""
        while True:
            try:
                frame = endpoint.recv_frame(timeout=0.0)
            except wire.WireError as e:
                self._reject(endpoint, sid_seen, e)
                return "retired", sid_seen
            if frame is None:
                return "open", sid_seen
            if frame.kind == wire.FRAME_CLOSE:
                self._close_session(frame.session)
                return "closed", sid_seen
            if frame.kind == wire.FRAME_ERROR:
                return "retired", sid_seen
            if frame.kind != wire.FRAME_PAYLOAD:
                self._reject(endpoint, sid_seen, wire.WireError(
                    f"unexpected frame kind {frame.kind} on the "
                    f"{self.direction} up direction"))
                return "retired", sid_seen
            sid_seen = frame.session
            sess = self._admit_frame(frame, endpoint)
            self._enqueue(sess, frame)      # QueueFull surfaces to caller

    def _session_for(self, sid: int, endpoint) -> Session:
        with self._lock:
            sess = self.sessions.get(sid)
            if sess is None:
                sess = self._new_session(sid, endpoint)
                self.sessions[sid] = sess
            else:
                sess.endpoint = endpoint    # replies follow the latest conn
            return sess


class StreamingServer(FrameServerBase):
    """Top-model serving engine over framed byte channels.

    `top_step` is an arena step (`steps.make_arena_top_step`); `capacity`
    bounds concurrently-resident sessions (the engine sets it to the
    client count, where neither eviction nor waiting ever triggers).
    `backend` picks the decode kernel ("auto"/None) or its plain version
    ("torch"). `evict_idle` turns LRU eviction to the host on;
    `admit_timeout` bounds an admission's wait for a slot (read through
    `clock`, so under a virtual clock a full arena raises at once instead
    of deadlocking a single-threaded pump)."""

    def __init__(self, params, top_step: Callable, make_cache: Callable,
                 *, device, max_batch: int = 8, max_wait: float = 0.01,
                 dtype=torch.float32, capacity: Optional[int] = None,
                 x_shape=None, backend: Optional[str] = None,
                 clock: Clock = SYSTEM_CLOCK, evict_idle: bool = True,
                 admit_timeout: float = 5.0, tracer=NULL_TRACER,
                 registry: Optional[MetricsRegistry] = None):
        self.params = params
        self.device = torch.device(device)
        self.clock = clock
        self.top_step = top_step
        self._fused_step = steps.make_fused_decode_step(top_step,
                                                        backend=backend)
        self.dtype = dtype
        self.backend = backend
        self.batch_sizes: List[int] = []    # flush fill history
        self.stage_s = {"decode": 0.0, "step": 0.0, "reply": 0.0}
        # decode launches by payload kind, and flushes of more than one
        # meta (each meta group of a flush is one decode)
        self.decode_groups: collections.Counter = collections.Counter()
        self.mixed_meta_flushes = 0
        self._init_connections(BatchingQueue(max_batch, max_wait,
                                             clock=clock),
                               tracer=tracer, registry=registry)
        if tracer.enabled:
            tracer.name_track(SERVE_TID, "serve loop")
        self.arena: Optional[SlotArena] = None
        self._make_cache = make_cache
        self._capacity = capacity or max_batch
        self.evict_idle = evict_idle
        self.admit_timeout = admit_timeout
        if x_shape is not None:
            self.arena = SlotArena(make_cache, self._capacity, x_shape,
                                   dtype, self.device)
        # FIFO free deque: O(1) admission, freed slots cycle to the back
        self._free_slots: Deque[int] = collections.deque(
            range(self._capacity))
        # ordered row ops ("reset" | "fetch" | "restore", session, slot),
        # applied by the serve loop before the next flush touches the
        # arena: FIFO order puts an eviction's fetch before any
        # re-admission's restore of the same session
        self._arena_ops: List[Tuple] = []
        # flush-size buckets: powers of two up to max_batch, plus max_batch
        self._buckets = sorted(
            {1 << i for i in range(max_batch.bit_length())
             if (1 << i) <= max_batch} | {max_batch})
        self._staging: Dict = {}            # (meta, bucket, leaf) -> np buf
        self.host_bytes = {"staged": 0, "wire": 0}

    def _ensure_arena(self, d: int) -> None:
        if self.arena is None:
            self.arena = SlotArena(self._make_cache, self._capacity,
                                   (1, 1, d), self.dtype, self.device)

    # -- slot lifecycle (admission / reclaim / evict / re-admit) -------------

    def _assign_slot_locked(self, sid: int) -> int:
        """Take a free slot, else reclaim a closed session's, else LRU-evict
        an idle session's row to the host, else wait on the slot condvar
        until `admit_timeout`. Called under the lock; the wait releases
        it."""
        deadline = None
        while True:
            if self._free_slots:
                return self._free_slots.popleft()
            for sess in self.sessions.values():
                if sess.closed and sess.slot >= 0:
                    slot, sess.slot = sess.slot, -1
                    self._arena_ops.append(("reset", None, slot))
                    self.registry.counter("slot_reclaims_total").inc()
                    self.tracer.instant(EVT_SLOT_EVICT, tid=SERVE_TID,
                                        sid=sess.id, slot=slot)
                    return slot
            if self.evict_idle:
                cand = None
                for sess in self.sessions.values():
                    # resident, idle and materialized: a session whose
                    # fetch or restore is still queued (host_state set)
                    # is not evictable
                    if (sess.slot >= 0 and not sess.closed
                            and sess.pending == 0
                            and sess.host_state is None
                            and sess.id != sid
                            and (cand is None
                                 or sess.last_active < cand.last_active)):
                        cand = sess
                if cand is not None:
                    slot, cand.slot = cand.slot, -1
                    cand.host_state = _EVICTING
                    self._arena_ops.append(("fetch", cand, slot))
                    self._arena_ops.append(("reset", None, slot))
                    self.registry.counter("slot_evictions_total").inc()
                    self.tracer.instant(EVT_SLOT_EVICT, tid=SERVE_TID,
                                        sid=cand.id, slot=slot)
                    return slot
            now = self.clock.monotonic()
            if deadline is None:
                deadline = now + self.admit_timeout
            if now >= deadline:
                raise RuntimeError(
                    f"session {sid}: arena full ({self._capacity} slots, "
                    f"none closed or idle within {self.admit_timeout:.1f}s)"
                    f" — raise `capacity` toward the expected concurrent "
                    f"session count")
            self.clock.cv_wait(self._slot_cv, deadline - now)

    def _ensure_resident(self, sess: Session) -> None:
        """Re-admit an evicted session (under the lock): assign a row
        (possibly evicting another idle session) and queue the restore,
        FIFO after its own eviction's fetch. The untouched `last_seq` /
        `last_reply` keep dedup working across the gap."""
        if sess.slot >= 0 or sess.closed or sess.host_state is None:
            return
        slot = self._assign_slot_locked(sess.id)
        sess.slot = slot
        self._arena_ops.append(("restore", sess, slot))
        self.registry.counter("slot_readmissions_total").inc()
        self.tracer.instant(EVT_SLOT_ADMIT, tid=SERVE_TID, sid=sess.id,
                            slot=slot)

    def _before_enqueue(self, sess: Session) -> None:
        """Pin residency for the frame about to enter the queue and count
        it in flight: `pending > 0` makes the session ineligible for
        eviction until the flush that serves the frame."""
        with self._lock:
            self._ensure_resident(sess)
            sess.pending += 1
            sess.last_active = self.clock.monotonic()

    def _new_session(self, sid: int, endpoint) -> Session:
        slot = self._assign_slot_locked(sid)
        self.registry.counter("slot_admits_total").inc()
        self.tracer.instant(EVT_SLOT_ADMIT, tid=SERVE_TID, sid=sid,
                            slot=slot)
        if self.tracer.enabled:
            self.tracer.name_track(session_tid(sid), f"session {sid}")
        return Session(id=sid, slot=slot, endpoint=endpoint,
                       last_active=self.clock.monotonic())

    def _apply_arena_ops(self, ops) -> None:
        """Run queued row ops (eviction fetches, template resets,
        re-admission restores) on the serve-loop thread, in FIFO order,
        before the flush's step touches the arena. With no arena yet no
        row was ever written: a fetch keeps a fresh template row and
        reset/restore are no-ops."""
        for kind, sess, slot in ops:
            if self.arena is None:
                if kind == "fetch":
                    sess.host_state = self._make_cache(1)
                elif kind == "restore":
                    sess.host_state = None
                continue
            if kind == "fetch":
                sess.host_state = self.arena.fetch_slot(slot)
            elif kind == "restore":
                state = sess.host_state
                if state is None or state is _EVICTING:
                    raise RuntimeError(f"session {sess.id}: restore "
                                       f"ordered before its eviction's "
                                       f"fetch")
                self.arena.restore_slot(slot, state)
                sess.host_state = None
            else:
                self.arena.reset_slot(slot)

    # -- serving --------------------------------------------------------------

    def serve_loop(self) -> None:
        """Flush/process until every connection has closed and drained."""
        while True:
            batch = self.queue.get_batch(idle_timeout=0.05)
            if batch:
                self._process(batch)
            elif self.queue.drained:
                return

    def warm(self, example_payloads) -> None:
        """Run every hot-loop path once before the serving clock starts
        (kernel library build, allocator and library handles): for each
        example payload and flush bucket, the decode into the scratch row
        and the fused step with every slot inactive (no session state
        changes), then one plain arena step for the mixed-meta path."""
        for p in example_payloads:
            self._ensure_arena(p.meta.d)
            inactive = np.zeros(self.arena.capacity, bool)
            for size in self._buckets:
                slots = np.full(size, self.arena.capacity, np.int64)
                stacked, dslots = self._stack_group(p.meta, [p] * size,
                                                    slots, size)
                self._decode(stacked, dslots)
                self._fused_step(self.params, self.arena.xbuf, stacked,
                                 dslots, self.arena.cache, inactive)
        if self.arena is None:
            return
        tokens = self.top_step(self.params, self.arena.xbuf,
                               self.arena.cache,
                               np.zeros(self.arena.capacity, bool))
        tokens.cpu()
        self.host_bytes = {"staged": 0, "wire": 0}   # warm traffic is free

    def _decode(self, stacked: Payload, slots) -> None:
        protocol.server_decode_to_slots(self.arena.xbuf, stacked, slots,
                                        backend=self.backend)

    def _dedup(self, items) -> List:
        """Stop-and-wait filter: a seq at or below the last processed one
        is a replay; the last one is re-acked from the cached reply."""
        fresh = []
        for sess, frame in items:
            if frame.seq > sess.last_seq:
                fresh.append((sess, frame))
                continue
            sess.stats.duplicates += 1
            self._m_dups.inc()
            if frame.seq == sess.last_seq and sess.last_reply is not None:
                sess.endpoint.send(sess.last_reply)
                self._count_frame_down(sess, len(sess.last_reply))
        return fresh

    def _bucket(self, n: int) -> int:
        return next(b for b in self._buckets if b >= n)

    def _stack_group(self, meta, group, slots: np.ndarray, size: int):
        """Stack one meta-group's wire leaves into the cached (meta, bucket)
        host buffers — in the kernels' dtypes (f32 values/headers, int32
        codes, indices and mask words) — zero-padding to `size` rows aimed
        at the scratch slot, and move them to the device. Returns (stacked
        device Payload, (size,) int32 device slot vector). Reusing a buffer
        across flushes is safe: the copy to the device has finished reading
        it when `.to()` returns (pageable host memory)."""
        n = len(group)
        leaves = {}
        for name, first in group[0].wire_leaves():
            row0 = np.asarray(first)
            key = (meta, size, name)
            buf = self._staging.get(key)
            if buf is None:
                dt = np.float32 if row0.dtype == np.float32 else np.int32
                buf = self._staging[key] = np.zeros((size,) + row0.shape, dt)
            for i in range(n):
                a = np.asarray(getattr(group[i], name))
                buf[i] = a.view(np.int32) if a.dtype == np.uint32 else a
            if n < size:
                buf[n:] = 0
            leaves[name] = device_leaf(buf, name, self.device)
            self.host_bytes["staged"] += buf.nbytes
            self.host_bytes["wire"] += n * row0.nbytes
        if n < size:
            padded = np.full(size, self.arena.capacity, np.int64)
            padded[:n] = slots
            slots = padded
        dslots = torch.as_tensor(slots.astype(np.int32), device=self.device)
        return Payload(meta=meta, **leaves), dslots

    def _group(self, meta, idxs, items):
        """One meta group of a flush, stacked: (device Payload, slots)."""
        self.decode_groups[meta.kind] += 1
        return self._stack_group(
            meta, [items[i][1].payload for i in idxs],
            np.fromiter((self.arena.wire_row(items[i][2]) for i in idxs),
                        np.int64, len(idxs)),
            self._bucket(len(idxs)))

    def _process(self, items) -> None:
        t_flush = self._observe_queue_wait(items)
        trace = self.tracer.enabled
        all_items = items
        items = self._dedup(items)
        with self._lock:
            # drain the in-flight count of EVERY frame this flush picked up
            # and stamp activity for the LRU order
            for sess, _frame in all_items:
                sess.pending -= 1
                sess.last_active = t_flush
            # eager slot release: a closed session's row returns to the
            # free deque now
            for sess in self.sessions.values():
                if sess.closed and sess.slot >= 0:
                    slot, sess.slot = sess.slot, -1
                    self._arena_ops.append(("reset", None, slot))
                    self._free_slots.append(slot)
                    self.registry.counter("slot_reclaims_total").inc()
                    self.tracer.instant(EVT_SLOT_EVICT, tid=SERVE_TID,
                                        sid=sess.id, slot=slot)
            if len(self._free_slots) == self._capacity:
                self._free_slots = collections.deque(
                    sorted(self._free_slots))
            ops, self._arena_ops = self._arena_ops, []
            self._slot_cv.notify_all()
            # snapshot slots under the lock (a reader may reclaim a closed
            # session's slot at any moment); a frame of a session with no
            # row left (closed) is dropped
            items = [(s, f, s.slot) for s, f in items if s.slot >= 0]
        if items:
            self._ensure_arena(items[0][1].payload.meta.d)
        self._apply_arena_ops(ops)      # serialized with the step here
        if not items:
            return
        self.batch_sizes.append(len(items))
        self._m_fill.observe(len(items))
        if trace:
            ts0 = self.clock.monotonic()
        t0 = time.perf_counter()
        by_meta: Dict = {}
        for i, (_, frame, _slot) in enumerate(items):
            by_meta.setdefault(frame.payload.meta, []).append(i)
        active = np.zeros(self.arena.capacity, bool)
        for _, _, slot in items:
            active[slot] = True
        if len(by_meta) == 1:
            [(meta, idxs)] = by_meta.items()
            stacked, slots = self._group(meta, idxs, items)
            if trace:
                ts1 = self.clock.monotonic()
            t1 = time.perf_counter()
            tokens = self._fused_step(self.params, self.arena.xbuf, stacked,
                                      slots, self.arena.cache, active)
        else:
            self.mixed_meta_flushes += 1
            for meta, idxs in by_meta.items():
                self._decode(*self._group(meta, idxs, items))
            if trace:
                ts1 = self.clock.monotonic()
            t1 = time.perf_counter()
            tokens = self.top_step(self.params, self.arena.xbuf,
                                   self.arena.cache, active)
        tokens = tokens.cpu().numpy()           # waits for the device
        if trace:
            ts2 = self.clock.monotonic()
        t2 = time.perf_counter()
        for sess, frame, slot in items:
            row = self.arena.wire_row(slot)
            reply = wire.encode_token_frame(sess.id, frame.seq,
                                            tokens[row:row + 1])
            sess.last_seq, sess.last_reply = frame.seq, reply
            sess.endpoint.send(reply)
            self._count_frame_down(sess, len(reply))
        t3 = time.perf_counter()
        self.stage_s["decode"] += t1 - t0
        self.stage_s["step"] += t2 - t1
        self.stage_s["reply"] += t3 - t2
        if trace:
            ts3 = self.clock.monotonic()
            n = len(items)
            self.tracer.complete(SPAN_DECODE, ts0, ts1, tid=SERVE_TID, n=n)
            self.tracer.complete(SPAN_STEP, ts1, ts2, tid=SERVE_TID, n=n)
            self.tracer.complete(SPAN_REPLY, ts2, ts3, tid=SERVE_TID, n=n)
