"""The clean-wire part of the reference's stop-and-wait ARQ client loop.

On a clean wire the loop is one blocking wait for the reply echoing the
in-flight step (`_await_reply`) and its classification (`_accept_reply`):
every request carries its step as the sequence number, the reply echoes
it, and a stale duplicate (seq < step) is counted and dropped.
Retransmission, reconnect and fault injection are not ported yet.
"""
from __future__ import annotations

from repro_torch.core import wire


class ArqClientMixin:
    """Subclasses provide `id`, `endpoint`, `stats`, `reply_timeout`, the
    expected reply kind `_reply_kind` and `_count_reply`."""

    _reply_kind: int                    # wire.FRAME_TOKENS

    def _count_reply(self, reply: wire.Frame) -> None:
        raise NotImplementedError

    def _accept_reply(self, reply: wire.Frame, step: int):
        """The frame when it acks `step`, None for a counted stale
        duplicate; raises `wire.WireError` on a protocol violation."""
        if reply.kind == self._reply_kind and reply.session == self.id:
            self._count_reply(reply)
            if reply.seq == step:
                return reply
            if reply.seq < step:
                self.stats.duplicates += 1
                return None
        raise wire.WireError(
            f"session {self.id}: unexpected reply kind={reply.kind} "
            f"seq={reply.seq} while awaiting step {step}")

    def _await_reply(self, step: int) -> wire.Frame:
        """Block for the reply echoing `step`; TimeoutError after
        `reply_timeout` seconds without one, RuntimeError on an error
        frame."""
        while True:
            reply = self.endpoint.recv_frame(timeout=self.reply_timeout)
            if reply is None:
                raise TimeoutError(f"session {self.id}: no reply to frame "
                                   f"{step} within {self.reply_timeout}s")
            if reply.kind == wire.FRAME_ERROR:
                raise RuntimeError(f"session {self.id}: server rejected "
                                   f"frame {step}: {reply.error_msg}")
            got = self._accept_reply(reply, step)
            if got is not None:
                return got
