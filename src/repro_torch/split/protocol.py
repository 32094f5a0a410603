"""Cut-layer transfer protocol — one generic encode/transfer/decode path.

Training:

  * `cut_boundary` — the in-graph path of `split.model.forward`: encode ->
    decode on one device, with the payload-typed backward wire attached as
    a `torch.autograd.Function` (`_Transport`, the reference's custom VJP,
    which `cut_boundary_mesh` shares):
    the gradient is gathered at the far side's support and scattered onto
    the feature owner's (sparse kinds), sliced and padded (slice), or
    passed through (dense, quant: the straight-through estimator).
  * `cut_boundary_mesh` — the same on a training mesh: the codec runs
    once a batch shard, and with `SplitConfig.transfer_over_pod` and a
    'pod' axis the payload leaves cross to the next pod (the reference's
    `_pod_permute`) and the gradient leaves come back.
  * `pod_ring_perm` — the cut boundary's ring permutation along a mesh's
    'pod' axis, which the training cut and the sharded serving step
    (`runtime.steps.make_arena_top_step` with a pod mesh) run.
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

from repro_torch import mesh as mesh_mod
from repro_torch.core import compressors, selection, wire
from repro_torch.core.payload import (Payload, PayloadMeta, device_leaf,
                                      to_device, to_host)
from repro_torch.kernels._lib import resolve_backend
from repro_torch.kernels.decode import ops as dec_ops
from repro_torch.kernels.encode import ops as enc_ops
from repro_torch.models import tp
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
    """encode -> decode with the payload-typed backward wire, the
    reference's `_transport` custom VJP, over one or more batch shards
    (xs, those the process runs: `tp.Layout.held`): each shard's rows
    encoded with its `draws` entry (a generator, or `selection.Draws`),
    the payload leaves moved over the shards along 'pod' by `perm` on a
    mesh (`lay`; one collective-permute a leaf, as the reference's
    `_transfer_payload` sends leaf by leaf) and decoded where they
    arrive; in the backward the gradient leaves go back by the inverse
    permutation before they are scattered onto the feature owner's
    support. Without `perm` the far side's support is the local one."""

    @staticmethod
    def forward(ctx, comp, draws, training, lay, perm, *xs):
        ps = [comp.encode(x, generator=g, training=training)
              for x, g in zip(xs, draws)]
        far = _pod_send(lay, ps, perm)
        ctx.kind, ctx.d = comp.wire_kind, xs[0].shape[-1]
        ctx.k = min(getattr(comp, "k", 0), ctx.d)
        ctx.backend, ctx.lay, ctx.perm = comp.backend, lay, perm
        ctx.n = len(xs)
        ctx.save_for_backward(*[p.indices for p in ps + far
                                if p.indices is not None])
        return tuple(comp.decode(p, dtype=x.dtype)
                     for p, x in zip(far, xs))

    @staticmethod
    def backward(ctx, *gs):
        saved = ctx.saved_tensors
        idx_local, idx_far = (saved[:ctx.n], saved[ctx.n:]) if saved \
            else ([None] * ctx.n, [None] * ctx.n)
        gws = [_grad_to_wire(ctx.kind, g, i, ctx.k)
               for g, i in zip(gs, idx_far)]
        if ctx.perm is not None:
            gws = ring_permute(ctx.lay, gws,
                                [(dst, src) for src, dst in ctx.perm])
        return (None,) * 5 + tuple(
            _grad_from_wire(ctx.kind, gw, i, ctx.d, ctx.backend)
            for gw, i in zip(gws, idx_local))


def ring_permute(lay, ts, perm):
    """ts, one tensor a batch shard the process runs (`tp.Layout.held`),
    permuted over the shards along 'pod' by `perm`: over the shards mesh
    on the single controller; on a process mesh each position sends its
    shard's copy to the position of the pod `perm` names with its other
    coordinates (one collective-permute either way)."""
    if not lay.mesh.procs:
        return mesh_mod.permute(lay.shards, ts, "pod", perm,
                                registry=lay.registry)
    (p,) = lay.mesh.local
    got = mesh_mod.permute(lay.mesh, lay.mesh.each(lambda _: ts[0]), "pod",
                           perm, registry=lay.registry)
    return [got[p]]


def _pod_send(lay, ps, perm):
    """The shards' payloads where they arrive: each wire leaf permuted
    over the shards along 'pod' (none without `perm`)."""
    if perm is None:
        return ps
    names = [n for n, _ in ps[0].wire_leaves()]
    moved = {n: ring_permute(lay, [dict(p.wire_leaves())[n] for p in ps],
                              perm)
             for n in names}
    return [p.with_leaves(**{n: moved[n][b] for n in names})
            for b, p in enumerate(ps)]


def cut_boundary(x, cfg: ArchConfig, rt: Runtime, generator) -> tuple:
    """Compress the cut activation (B, S, d), decode it on the far side, and
    attach the payload-typed backward. Returns (x_top, l1_penalty).

    One generic path for every compressor — the payload object is the whole
    interface between the compressor and the far side. `generator` feeds
    RandTopK's draws at training; it is never read inside a recomputed
    (remat) region, so a recompute cannot draw a different mask."""
    comp = make_cut_compressor(cfg.split)
    pen = comp.loss_penalty(x.reshape(-1, x.shape[-1]))
    (y,) = _Transport.apply(comp, [generator], rt.training, None, None, x)
    return y, pen


def _shard_draws(comp, rows, shards, n: int, generator, training: bool):
    """RandTopK's draws for the rows (B_loc, S, d) of batch shards
    `shards` of n: drawn for all B rows at once in the mesh-less step's
    order and sliced by shard, so each shard's mask is the mesh-less one
    (on a process mesh every process draws the whole batch's from its
    own generator, seeded alike); the generator itself for a codec that
    draws nothing."""
    k, d = getattr(comp, "k", 0), rows[0].shape[-1]
    if not (training and isinstance(comp, compressors.RandTopK) and k < d):
        return [generator] * len(rows)
    if generator is None:
        raise ValueError("RandTopK.forward(training=True) needs a "
                         "torch.Generator")
    b = rows[0].shape[0]
    full = selection.draw(generator, comp.alpha, k,
                          (b * n,) + tuple(rows[0].shape[1:]),
                          device=rows[0].device)
    return [selection.Draws(full.counts[i * b:(i + 1) * b],
                            full.noise[i * b:(i + 1) * b])
            for i in shards]


def cut_boundary_mesh(xs, cfg: ArchConfig, lay, generator):
    """`cut_boundary` on a training mesh (`tp.Layout`): xs holds each
    position's cut activation. The activation is gathered to full S
    (`tp.gather_seq`); the codec runs once a batch shard, on its
    representative's rows (on a process mesh at every position of the
    shard, on its equal gathered rows with equal draws,
    `tp.Layout.held`), with RandTopK's draws sliced from the mesh-less
    step's (`_shard_draws`); with `transfer_over_pod` and a 'pod' axis
    of more than one the payload leaves cross to the next pod
    (`pod_ring_perm`). Every position of the shard that receives a
    payload takes its chunk of the decoded rows.

    Returns (xs, l1_penalty, origin): the penalty is the mean over the
    shards the process runs (every shard's on the single controller, its
    own shard's on a process mesh); origin[b] is the batch shard whose
    rows shard b now holds. The reference sends the rows but not their
    labels, so its pod mesh trains each row against another row's labels
    (ROADMAP Queue 3); the caller scores shard b against origin[b]'s
    labels, so the loss is the mesh-less loss."""
    comp = make_cut_compressor(cfg.split)
    gathered = tp.gather_seq(lay, xs)
    held = lay.held()
    rows = [gathered[p] for _, p in held]
    pens = [comp.loss_penalty(x.reshape(-1, x.shape[-1])) for x in rows]
    draws = _shard_draws(comp, rows, [b for b, _ in held], len(lay.groups),
                         generator, lay.rt.training)
    n_pod = lay.mesh.shape.get("pod", 1)
    perm = pod_ring_perm(n_pod) if (cfg.split.transfer_over_pod
                                    and n_pod > 1) else None
    ys = _Transport.apply(comp, draws, lay.rt.training, lay, perm, *rows)
    decoded = {b: y for (b, _), y in zip(held, ys)}
    out = lay.mesh.each(lambda p: lay.local_seq(p,
                                                decoded[lay.shard_of[p]]))
    return out, torch.stack(pens).mean(), cut_origin(cfg, lay)


def cut_origin(cfg: ArchConfig, lay):
    """origin[b]: the batch shard whose rows shard b holds after the cut
    (`cut_boundary_mesh`): with `transfer_over_pod` and a 'pod' axis of
    more than one the ring hands pod i's rows to pod i + 1, else every
    shard keeps its own. A decode cache's top layers are built for these
    rows (`split.model.init_decode_cache`)."""
    n_pod = lay.mesh.shape.get("pod", 1)
    origin = list(range(len(lay.groups)))
    if cfg.split is None or cfg.split.cut_layer <= 0 or n_pod == 1 \
            or not cfg.split.transfer_over_pod:
        return origin
    m = lay.mesh
    for b, r in enumerate(lay.reps):
        origin[lay.shard_of[m.shift(r, "pod",
                                    (m.coord(r, "pod") + 1) % n_pod)]] = b
    return origin


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


def pod_leaf_sizes(cfg: ArchConfig) -> tuple:
    """(bytes, gradient values) a token of what the training cut's pod
    ring moves (`cut_boundary_mesh`): the device payload's wire leaves
    forward and the gradient leaves back, in the activation dtype.
    Measured on a probe token encoded on the CPU, as `_Transport` encodes
    it; the sizes are a function of the config only."""
    comp = make_cut_compressor(cfg.split)
    d = cfg.d_model
    probe = torch.randn((1, 1, d), generator=torch.Generator().manual_seed(0))
    p = comp.encode(probe, generator=torch.Generator().manual_seed(0),
                    training=True)
    grad = _grad_to_wire(comp.wire_kind, probe, p.indices,
                         min(getattr(comp, "k", 0), d))
    return (sum(t.numel() * t.element_size() for _, t in p.wire_leaves()),
            grad.numel())


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
