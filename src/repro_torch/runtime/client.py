"""Streaming client — the feature owner of one serving session.

Runs the bottom model against its own KV cache, encodes each cut
activation and packs its wire bitstream on the device
(`steps.make_bottom_step_device`: one launch of the fused encode on the
card), pulls the packed sections, frames them as `core.wire` bytes, and
blocks on the server's token reply before advancing — one round trip per
token. Prompt tokens go through the same path (the server's top model must
see them to build its KV), with the replies discarded until the prompt is
exhausted. With `device_encode=False` the bottom step is
`steps.make_bottom_step` instead: the payload comes to the host and is
framed by the host codec (`wire.encode_payload_frame`). Frames are
byte-identical either way.

Recovery is the stop-and-wait ARQ loop of `runtime.arq.ArqClientMixin`:
requests carry the step as their sequence number, token replies echo it,
and the client retransmits on timeout, drops stale duplicates, and
reconnects + replays through the engine-provided `reconnect` callable
when a connection dies. With a clean wire and `retry_timeout=None` the
loop is one blocking wait.

Spans (`client.encode`, `client.send`, `client.arq_accept`) are the
reference's; on the card `client.encode` ends after the packed sections
reached the host, which waits for the device step.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from repro_torch.core import wire
from repro_torch.kernels.encode import ops as enc_ops
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.trace import (NULL_TRACER, SPAN_CLIENT_ENCODE,
                                   SPAN_WIRE_SEND, session_tid)
from repro_torch.runtime.arq import ArqClientMixin
from repro_torch.runtime.session import SessionStats
from repro_torch.testing.clock import Clock, SYSTEM_CLOCK


def encode_frame(sid: int, seq: int, out, device_encode: bool):
    """One bottom step's output -> (frame bytes, payload): the device
    sections framed as they are, or the host payload through the host
    codec."""
    if device_encode:
        payload, sections = out
        # `.cpu()` inside sections_to_bytes waits for the device step
        body = enc_ops.sections_to_bytes(payload.meta, payload.batch_shape,
                                         sections)
        return wire.encode_payload_frame_from_bytes(
            sid, seq, payload.meta, payload.batch_shape, body), payload
    return wire.encode_payload_frame(sid, seq, out), out


class StreamingClient(ArqClientMixin):
    """One simulated feature owner driving a session to completion."""

    _reply_kind = wire.FRAME_TOKENS

    def __init__(self, session_id: int, params, cache, bottom_step,
                 endpoint, prompt: np.ndarray, gen: int,
                 reply_timeout: float = 120.0,
                 retry_timeout: Optional[float] = None,
                 max_retries: int = 16,
                 reconnect: Optional[Callable] = None,
                 clock: Clock = SYSTEM_CLOCK,
                 tracer=NULL_TRACER, registry=None,
                 device_encode: bool = True):
        self.id = session_id
        self.clock = clock
        self.tracer = tracer
        # a client given no registry counts into one of its own, never the
        # process default (as the server: an empty histogram's NaN there
        # would make every later snapshot differ from itself)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.params = params
        self.cache = cache                      # updated in place per step
        self.bottom_step = bottom_step          # shared per compressor
        self.endpoint = endpoint
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.gen = gen
        self.reply_timeout = reply_timeout
        self.retry_timeout = retry_timeout      # None -> never retransmit
        self.max_retries = max_retries
        self.reconnect = reconnect              # () -> fresh endpoint
        self.device_encode = device_encode
        self.stats = SessionStats()
        self.generated: list = []
        self.latencies: list = []       # per-step send->reply seconds
        self.error: Optional[BaseException] = None
        # pre-bound hot-path instruments (one registry lookup per metric)
        reg = self.registry
        self._m_frames_up = reg.counter("frames_total", party="client",
                                        direction="up")
        self._m_payload_up = reg.counter("payload_bytes_total",
                                         party="client", direction="up")
        self._m_framing_up = reg.counter("framing_bytes_total",
                                         party="client", direction="up")
        self._m_tokens = reg.counter("tokens_total", party="client")
        self._m_latency = reg.histogram("token_latency_ms")
        self._m_frames_down = reg.counter("frames_total", party="client",
                                          direction="down")
        self._m_bytes_down = reg.counter("wire_bytes_total", party="client",
                                         direction="down")

    def _count_reply(self, reply: wire.Frame) -> None:
        self.stats.count_down(reply.nbytes)
        self._m_frames_down.inc()
        self._m_bytes_down.inc(reply.nbytes)

    def run(self) -> None:
        """Thread target; on any failure records the exception and closes."""
        try:
            self._run()
        except BaseException as e:              # surfaced by the engine
            self.error = e
        finally:
            self.endpoint.send(wire.encode_close_frame(self.id))

    def _run(self) -> None:
        token = np.asarray([[self.prompt[0]]], np.int32)
        n_steps = len(self.prompt) + self.gen - 1
        tid = session_tid(self.id)
        trace = self.tracer.enabled
        if trace:
            self.tracer.name_track(tid, f"session {self.id}")
        for step in range(n_steps):
            with self.tracer.span(SPAN_CLIENT_ENCODE, tid=tid, step=step):
                out = self.bottom_step(self.params, self.cache, token)
                frame_bytes, payload = encode_frame(self.id, step, out,
                                                    self.device_encode)
            t_send = self.clock.monotonic()
            self.endpoint.send(frame_bytes)
            if trace:
                self.tracer.complete(SPAN_WIRE_SEND, t_send,
                                     self.clock.monotonic(), tid=tid,
                                     step=step, nbytes=len(frame_bytes))
            hb = wire.payload_frame_header_nbytes(payload)
            self.stats.count_up(header_nbytes=hb,
                                payload_nbytes=len(frame_bytes) - hb)
            self._m_frames_up.inc()
            self._m_payload_up.inc(len(frame_bytes) - hb)
            self._m_framing_up.inc(hb)

            reply = self._await_reply(step, frame_bytes, hb)
            latency = self.clock.monotonic() - t_send
            self.latencies.append(latency)
            self._m_latency.observe(latency * 1e3)
            nxt = int(reply.tokens[0])
            if step + 1 < len(self.prompt):
                token = np.asarray([[self.prompt[step + 1]]], np.int32)
            else:
                self.generated.append(nxt)
                self.stats.tokens_out += 1
                self._m_tokens.inc()
                token = np.asarray([[nxt]], np.int32)
