"""Streaming server — the label owner serving N concurrent sessions.

One reader thread per connection parses `core.wire` frames off the byte
transport and feeds a `BatchingQueue`; the single serve loop flushes the
queue under the max-batch/max-wait policy and drives the device-resident
slot arena (`runtime.arena.SlotArena`):

  * each session is pinned to one arena slot at admission (FIFO free
    deque; a closed session's slot is reset and reused);
  * each flush, the wire leaves are staged into cached per-(meta, bucket)
    host buffers in the kernels' 32-bit dtypes, padded to the nearest
    power-of-two flush bucket with zero rows aimed at the scratch slot —
    the host touches only the compressed leaves, never a dense activation;
  * a single-meta flush runs the fused step (`steps.make_fused_decode_step`:
    decode kernel into `xbuf[slots]`, then the whole-arena top step);
    a mixed-meta flush decodes per meta, then runs the top step once.

Token replies stream back as frames; per-session byte accounting comes
from the real frame sizes. Malformed frames are answered with an error
frame and the connection is retired. LRU eviction/readmission, tracing and
the metrics registry of the reference server are not ported yet.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import wire
from repro_torch.core.payload import Payload, device_leaf
from repro_torch.runtime import steps
from repro_torch.runtime.arena import SlotArena
from repro_torch.runtime.batching import BatchingQueue
from repro_torch.runtime.session import Session


class StreamingServer:
    """Top-model serving engine over framed byte channels.

    `top_step` is an arena step (`steps.make_arena_top_step`); `capacity`
    bounds concurrently-resident sessions (the engine sets it to the client
    count). `backend` picks the decode kernel ("auto"/None) or its plain
    version ("torch")."""

    direction = "serving"

    def __init__(self, params, top_step: Callable, make_cache: Callable,
                 *, device, max_batch: int = 8, max_wait: float = 0.01,
                 dtype=torch.float32, capacity: Optional[int] = None,
                 x_shape=None, backend: Optional[str] = None,
                 admit_timeout: float = 5.0):
        self.params = params
        self.device = torch.device(device)
        self.top_step = top_step
        self._fused_step = steps.make_fused_decode_step(top_step,
                                                        backend=backend)
        self.dtype = dtype
        self.backend = backend
        self.batch_sizes: List[int] = []    # flush fill history
        self.stage_s = {"decode": 0.0, "step": 0.0, "reply": 0.0}
        self.queue = BatchingQueue(max_batch, max_wait)
        self.sessions: Dict[int, Session] = {}
        self._lock = threading.Lock()
        self._slot_cv = threading.Condition(self._lock)
        self._readers: List[threading.Thread] = []
        self._open_readers = 0
        self.errors: List[BaseException] = []   # reader-thread failures
        self.faults_detected = 0
        self.expected_sessions = 0          # set by the engine
        self.arena: Optional[SlotArena] = None
        self._make_cache = make_cache
        self._capacity = capacity or max_batch
        self.admit_timeout = admit_timeout
        if x_shape is not None:
            self.arena = SlotArena(make_cache, self._capacity, x_shape,
                                   dtype, self.device)
        # FIFO free deque: O(1) admission, freed slots cycle to the back
        self._free_slots: Deque[int] = collections.deque(
            range(self._capacity))
        self._resets: List[int] = []        # slots to reset, serve loop
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

    # -- connections -----------------------------------------------------------

    def attach(self, endpoint) -> threading.Thread:
        """Register a client channel and start its frame-reader thread."""
        with self._lock:
            self._open_readers += 1
        t = threading.Thread(target=self._read_loop, args=(endpoint,),
                             daemon=True)
        self._readers.append(t)
        t.start()
        return t

    def shutdown(self) -> None:
        """Close the admission queue; the serve loop drains, then exits."""
        self.queue.close()

    def _reject(self, endpoint, sid_seen, exc: wire.WireError) -> None:
        """Name the defect in an error frame and retire the connection."""
        with self._lock:
            self.faults_detected += 1
            sess = self.sessions.get(sid_seen)
            if sess is not None:
                sess.stats.faults_detected += 1
        endpoint.send(wire.encode_error_frame(
            sid_seen if sid_seen is not None else 0, 0,
            wire.error_code(exc), str(exc)))

    def _read_loop(self, endpoint) -> None:
        sid_seen = None
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
                    with self._lock:
                        if frame.session in self.sessions:
                            self.sessions[frame.session].closed = True
                        self._slot_cv.notify_all()
                    return
                if frame.kind == wire.FRAME_ERROR:
                    return
                if frame.kind != wire.FRAME_PAYLOAD:
                    raise wire.WireError(
                        f"unexpected frame kind {frame.kind} on the "
                        f"{self.direction} up direction")
                sid_seen = frame.session
                sess = self._session_for(frame.session, endpoint)
                sess.stats.count_up(frame.header_nbytes,
                                    frame.payload_nbytes)
                try:
                    self.queue.put((sess, frame))
                except RuntimeError:
                    return              # server shut down under us
        except wire.WireError as e:
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

    def _session_for(self, sid: int, endpoint) -> Session:
        with self._lock:
            sess = self.sessions.get(sid)
            if sess is None:
                sess = Session(id=sid, slot=self._assign_slot_locked(sid),
                               endpoint=endpoint)
                self.sessions[sid] = sess
            else:
                sess.endpoint = endpoint
            return sess

    def _assign_slot_locked(self, sid: int) -> int:
        """Take a free slot, else reclaim a closed session's, else wait on
        the slot condvar until `admit_timeout`. Called under the lock."""
        deadline = time.monotonic() + self.admit_timeout
        while True:
            if self._free_slots:
                return self._free_slots.popleft()
            for sess in self.sessions.values():
                if sess.closed and sess.slot >= 0:
                    slot, sess.slot = sess.slot, -1
                    self._resets.append(slot)
                    return slot
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise RuntimeError(
                    f"session {sid}: arena full ({self._capacity} slots, "
                    f"none closed within {self.admit_timeout:.1f}s)")
            self._slot_cv.wait(remaining)

    # -- serving -----------------------------------------------------------------

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
        from repro_torch.split import protocol

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
            if frame.seq == sess.last_seq and sess.last_reply is not None:
                sess.endpoint.send(sess.last_reply)
                sess.stats.count_down(len(sess.last_reply))
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

    def _process(self, items) -> None:
        items = self._dedup(items)
        with self._lock:
            # eager slot release: a closed session's row returns to the
            # free deque now
            for sess in self.sessions.values():
                if sess.closed and sess.slot >= 0:
                    slot, sess.slot = sess.slot, -1
                    self._resets.append(slot)
                    self._free_slots.append(slot)
            if len(self._free_slots) == self._capacity:
                self._free_slots = collections.deque(
                    sorted(self._free_slots))
            resets, self._resets = self._resets, []
            self._slot_cv.notify_all()
            # snapshot slots under the lock (a reader may reclaim a closed
            # session's slot at any moment)
            items = [(s, f, s.slot) for s, f in items if s.slot >= 0]
        if items:
            self._ensure_arena(items[0][1].payload.meta.d)
        if self.arena is not None:
            for slot in resets:
                self.arena.reset_slot(slot)     # serialized with the step
        if not items:
            return
        self.batch_sizes.append(len(items))
        t0 = time.perf_counter()
        by_meta: Dict = {}
        for i, (_, frame, _slot) in enumerate(items):
            by_meta.setdefault(frame.payload.meta, []).append(i)
        active = np.zeros(self.arena.capacity, bool)
        for _, _, slot in items:
            active[slot] = True
        if len(by_meta) == 1:
            [(meta, idxs)] = by_meta.items()
            stacked, slots = self._stack_group(
                meta, [items[i][1].payload for i in idxs],
                np.fromiter((items[i][2] for i in idxs), np.int64,
                            len(idxs)),
                self._bucket(len(idxs)))
            t1 = time.perf_counter()
            tokens = self._fused_step(self.params, self.arena.xbuf, stacked,
                                      slots, self.arena.cache, active)
        else:
            for meta, idxs in by_meta.items():
                stacked, slots = self._stack_group(
                    meta, [items[i][1].payload for i in idxs],
                    np.fromiter((items[i][2] for i in idxs), np.int64,
                                len(idxs)),
                    self._bucket(len(idxs)))
                self._decode(stacked, slots)
            t1 = time.perf_counter()
            tokens = self.top_step(self.params, self.arena.xbuf,
                                   self.arena.cache, active)
        tokens = tokens.cpu().numpy()           # waits for the device
        t2 = time.perf_counter()
        for sess, frame, slot in items:
            reply = wire.encode_token_frame(sess.id, frame.seq,
                                            tokens[slot:slot + 1])
            sess.last_seq, sess.last_reply = frame.seq, reply
            sess.endpoint.send(reply)
            sess.stats.count_down(len(reply))
        t3 = time.perf_counter()
        self.stage_s["decode"] += t1 - t0
        self.stage_s["step"] += t2 - t1
        self.stage_s["reply"] += t3 - t2
