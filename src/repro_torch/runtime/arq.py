"""Stop-and-wait ARQ recovery — the client half, shared by both runtimes.

`ArqClientMixin` holds the one copy of the retry/reconnect/dedup loop that
`runtime.client.StreamingClient` (awaiting token frames) and
`fedtrain.client.TrainingClient` (awaiting grad frames) run, and the
load generator's event-driven sessions reuse (`runtime.loadgen`):

  * every request carries its step as the sequence number; the reply echoes
    it, so stale duplicate re-acks (seq < step) are counted and dropped;
  * no reply within `retry_timeout` -> retransmit the same frame (the
    server dedups by seq and re-acks from its reply cache), counting the
    resent bytes — a retransmission is a real frame crossing the queue;
  * an `error` frame or a corrupt downstream (`wire.WireError`) -> the
    connection is dead; reconnect through the engine-provided callable onto
    the same server-side session and replay the in-flight step. Error-frame
    replays spend the same `max_retries` budget as timeouts, so a
    deterministically-rejecting peer cannot spin the loop forever;
  * every 8th timeout also reconnects: a corrupted length prefix stalls a
    reader waiting for bytes that never come, and only a fresh connection
    (with fresh `FrameReader`s on both ends) can unstick it.

Subclasses provide `id`, `endpoint`, `stats`, `reconnect`, `reply_timeout`,
`retry_timeout`, `max_retries`, plus the two points that differ: the
expected reply kind (`_reply_kind`) and how a received reply is counted
(`_count_reply` — token replies count aggregate bytes, grad replies keep
the payload/framing split that Table-2 bwd accounting needs).

With a clean wire and `retry_timeout=None` the loop is one blocking wait.
The port's copy of the reference's `runtime/arq.py`.
"""
from __future__ import annotations

from repro_torch.core import wire
from repro_torch.obs.registry import DEFAULT_REGISTRY
from repro_torch.obs.trace import (EVT_ARQ_RECONNECT, EVT_ARQ_RETRANSMIT,
                                   NULL_TRACER, SPAN_ARQ_ACCEPT,
                                   session_tid)
from repro_torch.testing.clock import SYSTEM_CLOCK


class ArqClientMixin:
    """Retry / reconnect / dedup recovery loop for a lock-step client.

    `clock` is the injectable time source behind every latency stamp the
    subclass takes; the blocking `_await_reply` path itself waits on the
    transport (SYSTEM_CLOCK mode), while the event-driven loadgen harness
    replaces the wait with scheduled retry events on a `VirtualClock` and
    reuses `_accept_reply` / `_retransmit` / `_reconnect` unchanged.

    Observability: retransmits and reconnects emit
    `arq.*` instants on the session's trace track and bump the
    `arq_replays_total` / `arq_reconnects_total` registry counters; an
    accepted reply closes the lifecycle with a `client.arq_accept` span.
    Both hooks are class-attribute defaults (`NULL_TRACER`, the process
    registry) so subclasses and harnesses override per run.
    """

    _reply_kind: int                    # wire.FRAME_TOKENS / FRAME_GRAD
    clock = SYSTEM_CLOCK
    tracer = NULL_TRACER
    registry = DEFAULT_REGISTRY

    def _count_reply(self, reply: wire.Frame) -> None:
        raise NotImplementedError

    def _reconnect(self) -> None:
        if self.reconnect is None:
            raise RuntimeError(f"session {self.id}: connection failed and "
                               f"no reconnect path is configured")
        # best-effort abandon notice so the old connection's server reader
        # exits instead of polling an orphaned channel forever
        try:
            self.endpoint.send(wire.encode_error_frame(
                self.id, 0, wire.ERR_PROTOCOL, "peer reconnecting"))
        except Exception:
            pass
        self.endpoint = self.reconnect()
        self.stats.reconnects += 1
        self.registry.counter("arq_reconnects_total", party="client").inc()
        self.tracer.instant(EVT_ARQ_RECONNECT, tid=session_tid(self.id),
                            sid=self.id)

    def _retransmit(self, frame_bytes: bytes, header_nbytes: int) -> None:
        self.stats.count_up(header_nbytes,
                            len(frame_bytes) - header_nbytes)
        self.registry.counter("arq_replays_total", party="client").inc()
        self.tracer.instant(EVT_ARQ_RETRANSMIT, tid=session_tid(self.id),
                            sid=self.id, nbytes=len(frame_bytes))
        self.endpoint.send(frame_bytes)

    def _accept_reply(self, reply: wire.Frame, step: int, t_recv=None):
        """Classify one received reply for in-flight `step`: returns the
        frame when it acks `step`, None for a counted stale duplicate
        (seq < step — a server re-ack of a replayed frame), and raises
        `wire.WireError` on a protocol violation (wrong kind, wrong
        session, or a seq from the future the stop-and-wait discipline
        can never produce). `t_recv` (clock seconds, optional) is when the
        reply came off the wire — the start of the traced accept span."""
        if reply.kind == self._reply_kind and reply.session == self.id:
            self._count_reply(reply)
            if reply.seq == step:
                if self.tracer.enabled:
                    now = self.clock.monotonic()
                    self.tracer.complete(
                        SPAN_ARQ_ACCEPT, now if t_recv is None else t_recv,
                        now, tid=session_tid(self.id), sid=self.id,
                        step=step)
                return reply
            if reply.seq < step:
                self.stats.duplicates += 1      # stale re-ack, drop
                self.registry.counter("duplicates_total",
                                      party="client").inc()
                return None
        raise wire.WireError(
            f"session {self.id}: unexpected reply kind={reply.kind} "
            f"seq={reply.seq} while awaiting step {step}")

    def _await_reply(self, step: int, frame_bytes: bytes,
                     header_nbytes: int) -> wire.Frame:
        """Block for the reply echoing `step`; raises TimeoutError once
        `max_retries` replays (timeout- or error-triggered) are spent."""
        timeout = (self.reply_timeout if self.retry_timeout is None
                   else self.retry_timeout)
        retries = 0
        while True:
            try:
                reply = self.endpoint.recv_frame(timeout=timeout)
            except wire.WireError:
                # corrupt downstream: this connection's frame boundaries
                # are gone — resume the session over a fresh one
                self.stats.faults_detected += 1
                self.registry.counter("faults_detected_total",
                                      party="client").inc()
                self._reconnect()
                reply = None
            t_recv = (self.clock.monotonic()
                      if self.tracer.enabled and reply is not None else None)
            if reply is None or reply.kind == wire.FRAME_ERROR:
                if self.retry_timeout is None or retries >= self.max_retries:
                    raise TimeoutError(
                        f"session {self.id}: no reply to frame {step} "
                        f"after {retries} retransmissions")
                retries += 1
                self.stats.replays += 1
                if reply is not None:
                    # peer rejected a frame and retired the connection
                    self.stats.count_down(reply.nbytes)
                    self._reconnect()
                elif self.reconnect is not None and retries % 8 == 0:
                    self._reconnect()   # escape a stalled reader
                self._retransmit(frame_bytes, header_nbytes)
                continue
            got = self._accept_reply(reply, step, t_recv)
            if got is not None:
                return got
