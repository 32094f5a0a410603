"""Streaming client — the feature owner of one serving session.

Runs the bottom model against its own KV cache, encodes each cut
activation and packs its wire bitstream on the device
(`steps.make_bottom_step_device`), pulls the packed sections, frames them
as `core.wire` bytes, and blocks on the server's token reply before
advancing — one round trip per token. Prompt tokens go through the same
path (the server's top model must see them to build its KV), with the
replies discarded until the prompt is exhausted.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.core import wire
from repro_torch.kernels.encode import ops as enc_ops
from repro_torch.runtime.arq import ArqClientMixin
from repro_torch.runtime.session import SessionStats


class StreamingClient(ArqClientMixin):
    """One simulated feature owner driving a session to completion."""

    _reply_kind = wire.FRAME_TOKENS

    def __init__(self, session_id: int, params, cache, bottom_step,
                 endpoint, prompt: np.ndarray, gen: int,
                 reply_timeout: float = 120.0):
        self.id = session_id
        self.params = params
        self.cache = cache                      # updated in place per step
        self.bottom_step = bottom_step          # shared per compressor
        self.endpoint = endpoint
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.gen = gen
        self.reply_timeout = reply_timeout
        self.stats = SessionStats()
        self.generated: list = []
        self.latencies: list = []       # per-step send->reply seconds
        self.error: Optional[BaseException] = None

    def _count_reply(self, reply: wire.Frame) -> None:
        self.stats.count_down(reply.nbytes)

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
        for step in range(n_steps):
            payload, sections = self.bottom_step(self.params, self.cache,
                                                 token)
            # `.cpu()` inside sections_to_bytes waits for the device step
            body = enc_ops.sections_to_bytes(payload.meta,
                                             payload.batch_shape, sections)
            frame_bytes = wire.encode_payload_frame_from_bytes(
                self.id, step, payload.meta, payload.batch_shape, body)
            t_send = time.perf_counter()
            self.endpoint.send(frame_bytes)
            hb = wire.payload_frame_header_nbytes(payload)
            self.stats.count_up(header_nbytes=hb,
                                payload_nbytes=len(frame_bytes) - hb)
            reply = self._await_reply(step)
            self.latencies.append(time.perf_counter() - t_send)
            nxt = int(reply.tokens[0])
            if step + 1 < len(self.prompt):
                token = np.asarray([[self.prompt[step + 1]]], np.int32)
            else:
                self.generated.append(nxt)
                self.stats.tokens_out += 1
                token = np.asarray([[nxt]], np.int32)
