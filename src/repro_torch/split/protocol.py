"""Cut-layer transfer protocol — the serving halves.

  * `client_encode_device` — the feature owner's half: cut activation ->
    device Payload + the packed wire sections (one encode kernel, one
    bit-pack kernel per packed stream), so the host only pulls the packed
    buffers and frames them.
  * `server_decode_to_slots` — the label owner's half on the serving hot
    path: a stacked flush payload decoded straight into the arena's
    cut-activation rows on the device.
  * `server_decode` — the host-side dense decode, counted in
    `HOST_DENSIFY_COUNT` (the serving path must keep it flat).

The training halves (`cut_boundary`, the gradient wire) are not ported yet.
"""
from __future__ import annotations

import threading

from repro_torch.core import compressors
from repro_torch.core.payload import Payload, to_device, to_host
from repro_torch.kernels._lib import resolve_backend
from repro_torch.kernels.decode import ops as dec_ops
from repro_torch.kernels.encode import ops as enc_ops
from repro_torch.models.config import SplitConfig


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


class HostDensifyCounter:
    """Locked count of host-side dense materializations (`server_decode`).
    Read and written from reader threads, the serve loop and test threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n

    def increment(self) -> None:
        with self._lock:
            self._n += 1


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
    for the identity compressor) runs the fused encode kernel: selection
    mask -> gather -> quantize -> mask words in one launch, then the
    bit-pack kernel. Otherwise `comp.encode` feeds the plain packer. Bytes
    are identical on every path."""
    kind = comp.wire_kind
    plain_dense = kind == "dense" and type(comp) is not compressors.Compressor
    if resolve_backend(comp.backend, x) == "cuda" and not plain_dense:
        d = x.shape[-1]
        k = min(getattr(comp, "k", 0) or 0, d)
        mask = (comp._mask(x, generator, training)
                if kind in enc_ops.MASK_KINDS else None)
        p = enc_ops.encode_rows(x, kind, k=k, bits=getattr(comp, "bits", 0),
                                mask=mask)
    else:
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
