"""Label-owner training server — the top model and the loss across the wire.

One reader thread per client connection parses `core.wire` frames into a
`runtime.batching.BatchingQueue` (`runtime.server.FrameServerBase`, shared
with the serving server); the train loop flushes the queue and, for each
received activation frame, decodes the self-described payload to the
dense cut view on the device (`protocol.server_decode_device`: only the
compressed wire leaves cross to the card, the `decode_rows` kernel builds
the view there, so `HOST_DENSIFY_COUNT` stays flat), runs the top model
and the loss under autograd with the view as a leaf (the party boundary
is literal: no gradient flows through the wire), takes the AdamW step,
and streams the compressed cut gradient back as a `grad` frame
(`protocol.server_grad_encode` + `wire.encode_grad_frame`, which also
carries the step's loss for the client's schedule).

Top-model updates run one frame at a time. With one client that is the
paper's alternating two-party loop. With N clients the reference applies
a flush in arrival order; the port applies it in (seq, session) order,
so a flush that holds one whole round (every client's frame of one step,
which `max_batch = N` and a `max_wait` longer than a step give) trains
the same weights on every run. Labels never cross the wire: the engine
hands the server a `labels_for(session, seq)` view of the label owner's
shard, aligned with the clients' deterministic batch streams.

Stop-and-wait dedup by sequence number re-acks a replayed step from the
cached grad frame and never steps the top optimizer twice.
"""
from __future__ import annotations

from typing import Callable, List

import torch

from repro_torch.core import wire
from repro_torch.optim.adamw import adamw_update
from repro_torch.runtime.batching import BatchingQueue
from repro_torch.runtime.server import FrameServerBase
from repro_torch.runtime.session import Session
from repro_torch.split import protocol, tabular


class TrainingServer(FrameServerBase):
    """Top-model training engine over framed byte channels."""

    direction = "training"

    def __init__(self, spec: tabular.SplitSpec, top, opt, *, device,
                 max_batch: int = 4, max_wait: float = 0.005):
        self.spec = spec
        self.device = torch.device(device)
        self.top = top
        self.opt = opt
        self.batch_sizes: List[int] = []
        self.step_count = 0
        self.labels_for: Callable = None    # set by the engine
        self._init_connections(BatchingQueue(max_batch, max_wait))

    def _new_session(self, sid: int, endpoint) -> Session:
        return Session(id=sid, endpoint=endpoint)

    def _step(self, view, y):
        """Top forward + loss, the gradients of the top weights and of the
        view, the AdamW step. Returns (loss, d loss / d view)."""
        top = {k: v.detach().requires_grad_(True) for k, v in self.top.items()}
        view = view.detach().requires_grad_(True)
        loss, _ = tabular.top_fn(top, view, y)
        *dtp, dview = torch.autograd.grad(loss, [*top.values(), view])
        self.top, self.opt, _ = adamw_update(
            top, dict(zip(top, dtp)), self.opt, lr=self.spec.lr,
            grad_clip=0.0)
        return loss.detach(), dview

    # -- training -------------------------------------------------------------

    def train_loop(self) -> None:
        """Flush/process until every client connection closed and drained."""
        while True:
            batch = self.queue.get_batch(idle_timeout=0.05)
            if batch:
                self._process(batch)
            elif self.queue.drained:
                return

    def _process(self, items) -> None:
        kept = 0
        for sess, frame in sorted(items, key=lambda it: (it[1].seq,
                                                         it[0].id)):
            # stop-and-wait dedup: a client never has two frames in flight,
            # so any seq above the last processed one is fresh progress
            # (async local steps and a resume both skip seqs); anything at
            # or below it is a replay and must not step the optimizer
            # again: re-ack the latest from the cache instead
            if frame.seq <= sess.last_seq:
                sess.stats.duplicates += 1
                if (frame.seq == sess.last_seq
                        and sess.last_reply is not None):
                    sess.endpoint.send(sess.last_reply)
                    sess.stats.count_down_frame(
                        sess.last_reply_header,
                        len(sess.last_reply) - sess.last_reply_header)
                continue
            kept += 1
            view = protocol.server_decode_device(
                frame.payload, backend=self.spec.backend, device=self.device)
            y = torch.from_numpy(self.labels_for(sess.id, frame.seq)).to(
                self.device)
            loss, dview = self._step(view, y)
            gp = protocol.server_grad_encode(frame.payload, dview)
            gf = wire.encode_grad_frame(sess.id, frame.seq, gp, float(loss))
            sess.last_seq, sess.last_reply = frame.seq, gf
            sess.last_reply_header = wire.grad_frame_header_nbytes(gp)
            sess.endpoint.send(gf)
            sess.stats.count_down_frame(sess.last_reply_header,
                                        len(gf) - sess.last_reply_header)
            self.step_count += 1
        if kept:
            self.batch_sizes.append(kept)

    # -- checkpoint state -----------------------------------------------------

    def state(self) -> dict:
        return {"top": self.top, "opt": self.opt}

    def load_state(self, st: dict) -> None:
        self.top = st["top"]
        self.opt = st["opt"]
