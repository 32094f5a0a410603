"""Cut-layer transfer protocol — one generic encode/transfer/decode path.

Training:

  * `cut_boundary` — the in-graph path of `split.model.forward`: encode ->
    decode on one device, with the payload-typed backward wire attached as
    a `torch.autograd.Function` (`_Transport`, the reference's custom VJP):
    the gradient is gathered at the far side's support and scattered onto
    the feature owner's (sparse kinds), sliced and padded (slice), or
    passed through (dense, quant: the straight-through estimator). Both
    parties live on one device: the reference's in-graph pod transfer
    (`_pod_permute` under `SplitConfig.transfer_over_pod`) waits for the
    training mesh.
  * `pod_ring_perm` — the cut boundary's ring permutation along a mesh's
    'pod' axis, which the sharded serving step runs
    (`runtime.steps.make_arena_top_step` with a pod mesh).
  * `server_grad_encode` / `client_grad_decode` — the same backward rules
    as out-of-process halves, for a label owner and a feature owner that
    exchange frames.
  * `server_decode_device` — a received payload decoded on the device.

Serving:

  * `client_encode_device` — the feature owner's half: cut activation ->
    device Payload + the packed wire sections in one launch of the fused
    encode kernel (selection, gather, quantize and bit-pack), so the host
    only pulls the packed buffers and frames them.
  * `server_decode_to_slots` — the label owner's half on the serving hot
    path: a stacked flush payload decoded straight into the arena's
    cut-activation rows on the device.
  * `server_decode` — the host-side dense decode, counted in
    `HOST_DENSIFY_COUNT` (the serving path must keep it flat).
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from repro_torch.core import compressors, selection, wire
from repro_torch.core.payload import (Payload, PayloadMeta, device_leaf,
                                      to_device, to_host)
from repro_torch.kernels._lib import resolve_backend
from repro_torch.kernels.decode import ops as dec_ops
from repro_torch.kernels.encode import ops as enc_ops
from repro_torch.models.config import ArchConfig, Runtime, SplitConfig
from repro_torch.obs.registry import DEFAULT_REGISTRY


def make_cut_compressor(sc: SplitConfig) -> compressors.Compressor:
    """Config -> codec object."""
    kw = {}
    if sc.compressor in ("topk", "randtopk", "randtopk_quant",
                         "randtopk_mask", "size_reduction"):
        kw["k"] = sc.k
    if sc.compressor in ("randtopk", "randtopk_quant", "randtopk_mask"):
        kw["alpha"] = sc.alpha
    if sc.compressor in ("quant", "randtopk_quant"):
        kw["bits"] = sc.quant_bits
    if sc.compressor == "l1":
        kw["lam"] = sc.l1_lam
    if sc.backend is not None:
        kw["backend"] = sc.backend
    return compressors.make_compressor(sc.compressor, **kw)


# ---------------------------------------------------------------------------
# Backward wire rules, dispatched on the payload kind (not the compressor).
# ---------------------------------------------------------------------------

def pod_ring_perm(n_pod: int, *, inverse: bool = False):
    """The cut-boundary ring permutation along the 'pod' axis, as (src,
    dst) pairs: forward sends pod i's rows to pod i+1 (mod n), inverse
    returns them."""
    step = -1 if inverse else 1
    return [(i, (i + step) % n_pod) for i in range(n_pod)]


def _grad_to_wire(kind: str, g, idx_far, k: int):
    """Label-owner side: the gradient leaves that cross back (Table 2 bwd)."""
    if kind in ("sparse", "sparse_quant"):
        return torch.gather(g, -1, idx_far.long())
    if kind == "mask":
        # idx_far = the packed support words; the k supported gradient
        # values in ascending-index order (the mask payload's value order)
        mask = selection.unpack_mask_words(idx_far, g.shape[-1])
        idx = torch.argsort((~mask).to(torch.int8), dim=-1,
                            stable=True)[..., :k]
        return torch.gather(g, -1, idx)
    if kind == "slice":
        return g[..., :k]
    return g  # dense / quant: full-precision dense gradient


def _grad_from_wire(kind: str, gw, idx_local, d: int, backend=None):
    """Feature-owner side: route the wire gradient onto the activation.

    Sparse/slice/mask kinds scatter onto the forward support (the paper's
    same-mask backward; the sparse scatter is `compressors._scatter_rows`,
    the `scatter_rows` kernel on the card); dense/quant kinds are the
    identity (STE)."""
    if kind in ("sparse", "sparse_quant"):
        return compressors._scatter_rows(gw, idx_local, d, backend)
    if kind == "mask":
        return compressors.mask_expand_rows(gw, idx_local, d)
    if kind == "slice":
        return torch.nn.functional.pad(gw, (0, d - gw.shape[-1]))
    return gw


class _Transport(torch.autograd.Function):
    """encode -> decode with the payload-typed backward wire: the
    reference's `_transport` custom VJP on one device, where the far side's
    support is the local one."""

    @staticmethod
    def forward(ctx, x, comp, generator, training):
        p = comp.encode(x, generator=generator, training=training)
        ctx.kind, ctx.d = comp.wire_kind, x.shape[-1]
        ctx.k = min(getattr(comp, "k", 0), ctx.d)
        ctx.backend = comp.backend
        ctx.save_for_backward(p.indices)
        return comp.decode(p, dtype=x.dtype)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        gw = _grad_to_wire(ctx.kind, g, idx, ctx.k)
        return (_grad_from_wire(ctx.kind, gw, idx, ctx.d, ctx.backend),
                None, None, None)


def cut_boundary(x, cfg: ArchConfig, rt: Runtime, generator) -> tuple:
    """Compress the cut activation (B, S, d), decode it on the far side, and
    attach the payload-typed backward. Returns (x_top, l1_penalty).

    One generic path for every compressor — the payload object is the whole
    interface between the compressor and the far side. `generator` feeds
    RandTopK's draws at training; it is never read inside a recomputed
    (remat) region, so a recompute cannot draw a different mask."""
    comp = make_cut_compressor(cfg.split)
    pen = comp.loss_penalty(x.reshape(-1, x.shape[-1]))
    return _Transport.apply(x, comp, generator, rt.training), pen


def wire_bytes_per_step(cfg: ArchConfig, batch: int, seq: int,
                        *, training: bool) -> float:
    """Paper-exact cut-layer wire bytes for one step (Table 2)."""
    sc = cfg.split
    if sc is None:
        return 0.0
    return wire.bytes_per_step(sc.compressor, cfg.d_model, batch * seq,
                               k=sc.k, bits=sc.quant_bits, training=training)


def measured_payload_bytes(cfg: ArchConfig, batch: int, seq: int,
                           *, training: bool = False,
                           generator=None) -> int:
    """Byte-exact forward payload size of one (batch, seq) step, measured by
    encoding a probe activation (normal, seed 0, on the CPU) and
    serializing it — the codec-side cross-check of `wire_bytes_per_step`.
    The size is a function of the shapes only."""
    sc = cfg.split
    if sc is None:
        return 0
    comp = make_cut_compressor(sc)
    probe = torch.randn((batch, seq, cfg.d_model),
                        generator=torch.Generator().manual_seed(0))
    return wire.payload_nbytes(client_encode(comp, probe, generator=generator,
                                             training=training))


class HostDensifyCounter:
    """Registry-backed count of host-side dense materializations
    (`server_decode`). Read and written from reader threads, the serve
    loop and test threads.

    The count lives in the process-wide registry
    (`obs.registry.DEFAULT_REGISTRY`, metric `host_densify_total`), so it
    shows up in registry snapshots next to every other runtime metric.
    That metric stays monotonic; `reset()` (returns the prior count) and
    `watch()` are offsets on top of it:

        with protocol.HOST_DENSIFY_COUNT.watch() as w:
            run_streaming(...)
        assert w.delta == 0

    `int(...)` and equality against ints read the count."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counter = DEFAULT_REGISTRY.counter("host_densify_total")
        self._offset = 0

    @property
    def value(self) -> int:
        with self._lock:
            return int(self._counter.value) - self._offset

    def increment(self) -> None:
        self._counter.inc()

    def reset(self) -> int:
        with self._lock:
            total = int(self._counter.value)
            prior, self._offset = total - self._offset, total
            return prior

    @contextlib.contextmanager
    def watch(self):
        yield _Watch(self)

    def __int__(self) -> int:
        return self.value

    def __eq__(self, other) -> bool:
        try:
            return self.value == int(other)
        except (TypeError, ValueError):
            return NotImplemented

    def __repr__(self) -> str:
        return f"HostDensifyCounter({self.value})"


class _Watch:
    """`HostDensifyCounter.watch()`'s handle: `delta` since entry."""

    def __init__(self, counter: HostDensifyCounter):
        self._counter = counter
        self.start = counter.value

    @property
    def delta(self) -> int:
        return self._counter.value - self.start


HOST_DENSIFY_COUNT = HostDensifyCounter()


def client_encode(comp: compressors.Compressor, x, *, generator=None,
                  training: bool = False) -> Payload:
    """Feature-owner half with the host codec: a numpy Payload in the wire
    dtypes, ready for `wire.encode_payload_frame`."""
    return to_host(comp.encode(x, generator=generator, training=training))


def client_encode_device(comp: compressors.Compressor, x, *, generator=None,
                         training: bool = False):
    """Device variant of `client_encode`: returns `(payload, sections)`,
    the device Payload and its packed int32 word sections. Frame them with

        body = enc_ops.sections_to_bytes(p.meta, p.batch_shape, sections)
        wire.encode_payload_frame_from_bytes(sid, seq, p.meta,
                                             p.batch_shape, body)

    When the backend resolves to the CUDA kernels, every kind (dense too,
    for the identity compressor) runs in ONE launch of the fused encode
    kernel (`enc_ops.encode_sections`): the selection where the mask is a
    plain top-k (TopK; RandTopK at inference), gather, quantize, mask
    words and the bit-packed sections together. A randomized mask
    (RandTopK in training) is drawn first by its own kernel. Otherwise
    `comp.encode` feeds the plain packer. Bytes are identical on every
    path."""
    kind = comp.wire_kind
    plain_dense = kind == "dense" and type(comp) is not compressors.Compressor
    if resolve_backend(comp.backend, x) == "cuda" and not plain_dense:
        d = x.shape[-1]
        k = min(getattr(comp, "k", 0) or 0, d)
        masked = kind in enc_ops.MASK_KINDS
        select = masked and comp._mask_is_topk(training)
        mask = (comp._mask(x, generator, training)
                if masked and not select else None)
        return enc_ops.encode_sections(x, kind, k=k,
                                       bits=getattr(comp, "bits", 0),
                                       mask=mask, select=select)
    p = comp.encode(x, generator=generator, training=training)
    return p, enc_ops.pack_payload(p, backend=comp.backend)


def server_decode(p: Payload, *, dtype=None):
    """Label-owner half on the host: dense (..., d) CPU view of a received
    payload. Counted in HOST_DENSIFY_COUNT; the serving loop never calls
    it."""
    HOST_DENSIFY_COUNT.increment()
    return compressors.payload_to_dense(to_device(p, "cpu"), dtype=dtype)


def server_decode_to_slots(xbuf, p: Payload, slots, *, backend=None):
    """Decode a stacked flush payload (device leaves, leading dim = flush
    rows) into `xbuf[slots]` IN PLACE — the arena's cut-activation buffer
    (the reference donates it; here the rows of the live buffer are
    written). Rows padded onto the scratch slot carry zero leaves. The CUDA
    kernel for a CUDA xbuf, else (or with backend="torch") its plain
    version. Returns xbuf."""
    return dec_ops.decode_rows_to_slots(xbuf, p, slots, backend=backend)


def server_decode_device(p: Payload, *, dtype=None, backend=None,
                         device="cuda"):
    """`server_decode` on the device: only the payload's wire leaves move
    to `device` (k floats + indices, not the dense tensor); the dense view
    is built there (the `decode_rows` kernel on the card, per `backend`).
    Not counted in HOST_DENSIFY_COUNT."""
    return compressors.payload_to_dense(to_device(p, device), dtype=dtype,
                                        backend=backend)


def server_grad_encode(p: Payload, g) -> Payload:
    """Label-owner backward half: the dense cut gradient (..., d) compressed
    to the wire payload the forward payload's kind dictates (Table 2 bwd):
    the k gradient floats at the forward support for sparse and mask
    kinds (the feature owner already holds the support), the first k for
    `slice`, the full dense gradient for dense and quant kinds. Returns
    numpy leaves, ready for `core.wire.encode_grad_frame`."""
    kind, d = p.meta.kind, p.meta.d
    k = min(p.meta.k or d, d)
    g = torch.as_tensor(np.asarray(g) if not torch.is_tensor(g) else g)
    idx = None if p.indices is None else device_leaf(p.indices, "indices",
                                                     g.device)
    gw = _grad_to_wire(kind, g, idx, k)
    sparse_bwd = kind in ("sparse", "sparse_quant", "slice", "mask")
    meta = (PayloadMeta("slice", d=d, k=k) if sparse_bwd
            else PayloadMeta("dense", d=d))
    return Payload(meta=meta, values=gw.detach().float().cpu().numpy())


def client_grad_decode(gp: Payload, *, fwd_kind: str, indices=None, d: int,
                       device="cpu"):
    """Feature-owner backward half: the dense (..., d) cut gradient from a
    received grad payload, routed onto the support of the forward payload
    the client sent (scatter for sparse kinds, expand for mask, pad for
    slice, identity for dense/quant), built on `device` (on the card the
    sparse scatter is the `scatter_rows` kernel)."""
    gw = device_leaf(gp.values, "values", device)
    idx = None if indices is None else device_leaf(indices, "indices",
                                                   device)
    return _grad_from_wire(fwd_kind, gw, idx, d)
