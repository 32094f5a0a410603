"""Feature-owner training client — the paper's bottom-model party, live.

One `TrainingClient` owns a shard of the training features, its bottom
model and its optimizer. Each sync step it runs the bottom forward, adds
the error-feedback residual (optional), encodes the cut activation on its
device (`protocol.client_encode_device`: on the card a randomized mask's
kernel, then one fused launch for the selection, encode and bit-pack;
`comp.encode` and the plain packer on the CPU; the same bytes either
way), frames it as `core.wire` bytes, blocks
for the server's `grad` frame, decodes the compressed cut gradient onto
the forward support (`protocol.client_grad_decode`, the `scatter_rows`
kernel on the card for sparse kinds) and pulls it through the bottom
model into AdamW. Every counter in `self.stats` is the length of a real
framed byte string. The grad route is keyed on the forward payload's
kind and indices leaf, so every wire kind works without per-kind code.

Policies plug in at two points:

  * `KScheduler` (schedule.py) picks the per-sync-step (k, bits); the
    server needs no notice because frames are self-describing.
  * `AsyncPolicy` (async_policy.py) decides which steps sync at all; local
    steps train against the cached stale gradient and never touch the wire.

Randomness: one `torch.Generator(seed)` on the client's device draws the
initial bottom weights (`tabular.init_parties`, unless weights are given)
and then every sync step's RandTopK draws, the draw chain of
`split.tabular.train`, so one client reproduces that trainer exactly.

The port's copy of the reference's `fedtrain/client.py` on a clean wire:
the stop-and-wait loop is `runtime.arq.ArqClientMixin` without
retransmission or reconnect, and the tracer spans and registry counters
are not ported yet. All trainer state (params, optimizer moments, the
generator's state, EF residual, stale gradient, schedule state, byte
counters) round-trips through `state()` / `load_state` for
`checkpoint.store`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import compressors as C, wire
from repro_torch.fedtrain.async_policy import AsyncPolicy
from repro_torch.fedtrain.schedule import KScheduler
from repro_torch.kernels.encode import ops as enc_ops
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.runtime.arq import ArqClientMixin
from repro_torch.runtime.session import SessionStats
from repro_torch.split import protocol, tabular

#: SessionStats fields a checkpoint carries, in order
_COUNTERS = ("frames_up", "payload_bytes_up", "header_bytes_up",
             "frames_down", "bytes_down", "payload_bytes_down",
             "header_bytes_down")


class TrainingClient(ArqClientMixin):
    """One feature owner driving its training shard over the wire.

    `bottom` = starting weights (else drawn from `seed`); `device` is where
    the bottom model trains."""

    _reply_kind = wire.FRAME_GRAD

    def __init__(self, cid: int, spec: tabular.SplitSpec, x_shard: np.ndarray,
                 batch_ids: List[np.ndarray], endpoint, *, seed: int,
                 device, bottom=None, scheduler: Optional[KScheduler] = None,
                 policy: Optional[AsyncPolicy] = None, ef: bool = False,
                 barrier=None, ckpt_every: int = 0,
                 reply_timeout: float = 120.0):
        self.id = cid
        self.spec = spec
        self.device = torch.device(device)
        self.x = np.asarray(x_shard, np.float32)
        self.batch_ids = batch_ids          # one index array per local step
        self.endpoint = endpoint
        self.scheduler = scheduler
        self.policy = policy or AsyncPolicy()
        self.ef = ef
        self.barrier = barrier
        self.ckpt_every = ckpt_every
        self.reply_timeout = reply_timeout

        self.start_step = 0
        self.end_step = len(batch_ids)
        self.stats = SessionStats()
        self.losses: list = []              # (step, loss) at sync steps
        self.k_trace: list = []             # (step, k, bits) at sync steps
        self.sync_count = 0                 # schedule clock (survives resume)
        self.analytic_up = 0.0              # compressor-accounting bytes
        self.analytic_down = 0.0
        self.error: Optional[BaseException] = None

        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        if bottom is None:
            bottom, _ = tabular.init_parties(self.gen, spec, self.device)
        self.bottom = {k: v.to(self.device) for k, v in bottom.items()}
        self.opt = adamw_init(self.bottom)

        batch = len(batch_ids[0]) if batch_ids else 0
        self._stale = torch.zeros((batch, spec.cut_dim), device=self.device)
        self._has_stale = False
        self._ef_resid = torch.zeros((spec.cut_dim,), device=self.device)

    # -- the two halves -------------------------------------------------------

    def _compressor(self, k: int, bits: int) -> C.Compressor:
        """(k, bits) from the schedule -> codec object. k >= d means the
        dense warmup phase (identity transfer); otherwise the SplitSpec
        dispatch with the scheduled (k, bits) swapped in."""
        spec = self.spec
        if spec.method in (None, "none") or (k >= spec.cut_dim
                                             and bits == 0):
            return C.Compressor(backend=spec.backend)
        return tabular.spec_compressor(dataclasses.replace(
            spec, k=k, quant_bits=bits or spec.quant_bits))

    @torch.no_grad()
    def _encode(self, comp: C.Compressor, xb):
        """Bottom forward (+ EF residual) and the device encode: returns
        the device payload and the frame's payload bytes."""
        o = tabular.bottom_fn(self.bottom, xb)
        if self.ef:
            o = o + self._ef_resid[None, :]
        p, sections = protocol.client_encode_device(
            comp, o, generator=self.gen, training=True)
        if self.ef:
            dec = comp.decode(p, dtype=o.dtype)
            self._ef_resid = torch.mean(o - dec, dim=0)
        return p, enc_ops.sections_to_bytes(p.meta, p.batch_shape, sections)

    def _update(self, xb, g_cut) -> None:
        """Pull the cut gradient through the bottom model; AdamW step."""
        spec = self.spec
        bottom = {k: v.detach().requires_grad_(True)
                  for k, v in self.bottom.items()}
        o = tabular.bottom_fn(bottom, xb)
        g = g_cut
        if spec.method == "l1":
            g = g + spec.l1_lam * torch.sign(o.detach()) / xb.shape[0]
        grads = torch.autograd.grad(o, list(bottom.values()), g)
        self.bottom, self.opt, _ = adamw_update(
            bottom, dict(zip(bottom, grads)), self.opt, lr=spec.lr,
            grad_clip=0.0)

    # -- the loop -------------------------------------------------------------

    def run(self) -> None:
        """Thread target; failures are recorded and surfaced by the engine."""
        try:
            self._run()
        except BaseException as e:          # surfaced by the engine
            self.error = e
            if self.barrier is not None:
                self.barrier.abort()        # don't deadlock healthy clients
        finally:
            self.endpoint.send(wire.encode_close_frame(self.id))

    def _count_reply(self, reply: wire.Frame) -> None:
        # grad replies keep the payload/framing split: their payload bytes
        # are the Table-2 bwd column
        self.stats.count_down_frame(reply.header_nbytes,
                                    reply.payload_nbytes)

    def _sync_step(self, step: int, xb):
        spec = self.spec
        d = spec.cut_dim
        if self.scheduler is not None:
            k, bits = self.scheduler.k_bits(self.sync_count)
        else:
            k, bits = spec.k, spec.quant_bits
        self.sync_count += 1
        comp = self._compressor(min(k, d), bits)
        p, body = self._encode(comp, xb)
        fb = wire.encode_payload_frame_from_bytes(self.id, step, p.meta,
                                                  p.batch_shape, body)
        self.endpoint.send(fb)
        hb = wire.payload_frame_header_nbytes(p)
        self.stats.count_up(hb, len(fb) - hb)
        # L1's training transport is dense; its fwd_bits models the
        # worst-case nnz encoding, so account what actually crossed
        fwd_bits = (d * C.FLOAT_BITS if isinstance(comp, C.L1Reg)
                    else comp.fwd_bits(d))
        self.analytic_up += fwd_bits / 8 * xb.shape[0]

        reply = self._await_reply(step)
        self.analytic_down += comp.bwd_bits(d) / 8 * xb.shape[0]

        g_cut = protocol.client_grad_decode(
            reply.payload, fwd_kind=p.meta.kind, indices=p.indices, d=d,
            device=self.device)
        if self.scheduler is not None:
            self.scheduler.observe(reply.loss)
        self.losses.append((step, reply.loss))
        self.k_trace.append((step, min(k, d), bits))
        return g_cut

    def _run(self) -> None:
        for step in range(self.start_step, self.end_step):
            xb = torch.from_numpy(self.x[self.batch_ids[step]]).to(
                self.device)
            if self.policy.is_sync(step):
                g_cut = self._sync_step(step, xb)
                self._stale, self._has_stale = g_cut, True
            else:
                assert self._has_stale, "local step before any sync"
                g_cut = self._stale     # stale cut gradient (Chen et al.)
            self._update(xb, g_cut)
            if (self.barrier is not None and self.ckpt_every
                    and (step + 1) % self.ckpt_every == 0):
                self.barrier.wait()     # engine snapshots all parties here

    # -- checkpoint state -----------------------------------------------------

    def state(self) -> dict:
        s = self.stats
        return {
            "bottom": self.bottom, "opt": self.opt,
            "gen": self.gen.get_state(),
            "ef": self._ef_resid,
            "stale": self._stale,
            "has_stale": np.int64(self._has_stale),
            "sched": (self.scheduler.state() if self.scheduler else {}),
            "counters": np.asarray([getattr(s, f) for f in _COUNTERS]
                                   + [self.sync_count], np.int64),
            "analytic": np.asarray([self.analytic_up, self.analytic_down],
                                   np.float64),
        }

    def load_state(self, st: dict) -> None:
        self.bottom = st["bottom"]
        self.opt = st["opt"]
        self.gen.set_state(st["gen"])
        self._ef_resid = st["ef"]
        self._stale = st["stale"]
        self._has_stale = bool(st["has_stale"])
        if self.scheduler is not None and st["sched"]:
            self.scheduler.load_state(st["sched"])
        *counters, self.sync_count = (int(v) for v in st["counters"])
        for f, v in zip(_COUNTERS, counters):
            setattr(self.stats, f, v)
        self.analytic_up, self.analytic_down = (
            float(v) for v in st["analytic"])
