"""Cut-layer compressors for split learning (paper Sections 3-4).

Each compressor is a frozen config object implementing the payload codec:

    payload = comp.encode(x, generator=g, training=True)  # device Payload
    y       = comp.decode(payload)                        # dense view
    y, aux  = comp.forward(x, generator=g, training=True) # decode(encode(x))

`x` is the cut activation (..., d). `encode` returns a `core.payload`
Payload with device leaves in kernel dtypes (f32 values, int32 codes,
int32 indices / mask words, f32 (lo, step) headers); `core.payload.to_host`
narrows them to the wire dtypes. Backward semantics follow the reference:
sparse kinds mask the gradient with the forward support (gather/scatter
adjoints), quantization is a straight-through estimator (`_STE`).

Randomness (RandTopK at training) comes from an explicit
`torch.Generator`; at inference RandTopK is the deterministic top-k.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import selection
from repro_torch.core.payload import Payload, PayloadMeta
from repro_torch.core.wire import index_bits

FLOAT_BITS = 32  # N in the paper
MAX_INDEX = 2 ** 16  # uint16 wire indices


class _STE(torch.autograd.Function):
    """Value `y`, gradient identity to `x` (straight-through estimator)."""

    @staticmethod
    def forward(ctx, x, y):
        return y.clone()

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros_like(g)


def ste(x, y):
    return _STE.apply(x, y)


def mask_expand_rows(vals, words, d: int):
    """Dense (..., d) expansion of a mask payload: the j-th value lands on
    the lane of the (j+1)-th set bit (ascending-index value order); set
    bits beyond k (a hostile frame) expand to zero."""
    mask = selection.unpack_mask_words(words, d)
    k = vals.shape[-1]
    pos = torch.cumsum(mask.to(torch.int64), dim=-1) - 1
    take = torch.gather(vals, -1, torch.clamp(pos, 0, k - 1))
    return torch.where(mask & (pos < k), take, torch.zeros_like(take))


def _scatter_rows(vals, idx, d: int):
    """Dense (..., d) scatter of a sparse support (one write per index, the
    reference's `put_along_axis`)."""
    out = torch.zeros(vals.shape[:-1] + (d,), dtype=vals.dtype,
                      device=vals.device)
    return out.scatter(-1, idx.long(), vals)


def dequant(codes, header):
    """`lo + (code + 0.5) * step` (the reference's `_dequant`), each
    operation rounded on its own: the decode kernel spells out the same
    roundings, so the two agree bit for bit."""
    lo, step = header[..., :1].float(), header[..., 1:2].float()
    return lo + (codes.float() + 0.5) * step


def payload_to_dense(p: Payload, dtype=None):
    """Dense view (..., d) of any payload — the label-owner-side Decode,
    dispatched on `p.meta.kind` only. The plain path: the reference's
    `decode_rows` kernel (with its fused projection epilogue) is not ported
    yet."""
    dtype = dtype or torch.float32
    m = p.meta
    if m.kind == "dense":
        return p.values.to(dtype)
    if m.kind == "slice":
        return torch.nn.functional.pad(p.values.to(dtype), (0, m.d - m.k))
    if m.kind == "sparse":
        return _scatter_rows(p.values.to(dtype), p.indices, m.d)
    if m.kind == "mask":
        return mask_expand_rows(p.values.to(dtype), p.indices, m.d)
    if m.kind == "quant":
        return dequant(p.values, p.header).to(dtype)
    if m.kind == "sparse_quant":
        return _scatter_rows(dequant(p.values, p.header).to(dtype),
                             p.indices, m.d)
    raise ValueError(m.kind)


def quantize_rows(vals, bits: int, *, selected: bool = False):
    """Uniform quantization (Eq. 2) with a per-row [min, max] range.
    Returns (codes int32, header f32 (..., 2) = (lo, step)).

    `selected=False` is the reference's full-row `_quant_encode` (a
    degenerate step becomes 1.0 via `step <= 0`); `selected=True` is
    RandTopKQuant's range over the selected values (`hi > lo` guard)."""
    lo = vals.min(dim=-1, keepdim=True).values
    hi = vals.max(dim=-1, keepdim=True).values
    n_bins = 2 ** bits
    one = torch.ones_like(lo)
    if selected:
        step = torch.where(hi > lo, (hi - lo) / n_bins, one)
    else:
        step = (hi - lo) / n_bins
        step = torch.where(step <= 0, one, step)
    code = torch.clamp(torch.floor((vals - lo) / step), 0, n_bins - 1)
    return code.to(torch.int32), torch.cat([lo, step], dim=-1)


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base: identity (vanilla split learning, 'No compression')."""

    name: str = "identity"
    backend: Optional[str] = None   # selection backend: None->auto, torch, cuda

    wire_kind = "dense"             # payload kind this compressor emits

    def encode(self, x, *, generator=None, training=False) -> Payload:
        return Payload(meta=PayloadMeta("dense", d=x.shape[-1]),
                       values=x.float())

    def decode(self, p: Payload, dtype=None):
        return payload_to_dense(p, dtype=dtype)

    def forward(self, x, *, generator=None, training=False):
        p = self.encode(x, generator=generator, training=training)
        return self.decode(p, dtype=x.dtype), self._aux(p, x, training)

    def _aux(self, p: Payload, x, training) -> dict:
        return {}

    def loss_penalty(self, x):
        return torch.zeros((), dtype=torch.float32, device=x.device)

    # -- wire accounting (bits per instance of dimension d) ------------------
    def fwd_bits(self, d: int) -> float:
        return d * FLOAT_BITS

    def bwd_bits(self, d: int) -> float:
        return d * FLOAT_BITS


@dataclasses.dataclass(frozen=True)
class SizeReduction(Compressor):
    """Keep the first k features (mask-based cut-layer slimming, Eq. 1)."""

    k: int = 8
    name: str = "size_reduction"

    wire_kind = "slice"

    def encode(self, x, *, generator=None, training=False):
        d = x.shape[-1]
        k = min(self.k, d)
        return Payload(meta=PayloadMeta("slice", d=d, k=k),
                       values=x[..., :k].float())

    def _aux(self, p, x, training):
        mask = torch.arange(p.meta.d, device=x.device) < p.meta.k
        return {"mask": mask.expand(x.shape)}

    def fwd_bits(self, d):
        return self.k * FLOAT_BITS

    def bwd_bits(self, d):
        return self.k * FLOAT_BITS


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Magnitude top-k sparsification (Eq. 3)."""

    k: int = 8
    name: str = "topk"

    wire_kind = "sparse"

    def _mask(self, x, generator, training):
        return selection.topk_mask(x, self.k, backend=self.backend)

    def _support(self, x, generator, training):
        """int32 indices of the selected support, ascending-index order
        (the canonical wire order the encode kernel shares), and the mask."""
        d = x.shape[-1]
        assert d <= MAX_INDEX, "uint16 wire indices need d <= 65536"
        k = min(self.k, d)
        mask = self._mask(x, generator, training)
        score = torch.where(mask, x.detach().float().abs(),
                            torch.full(x.shape, -1.0, device=x.device))
        idx = torch.topk(score, k, dim=-1).indices
        idx = torch.sort(idx, dim=-1).values
        return idx, mask

    def encode(self, x, *, generator=None, training=False):
        d = x.shape[-1]
        idx, _ = self._support(x, generator, training)
        vals = torch.gather(x, -1, idx).float()
        return Payload(meta=PayloadMeta("sparse", d=d, k=idx.shape[-1]),
                       values=vals, indices=idx.to(torch.int32))

    def _aux(self, p, x, training):
        return {"mask": selection.mask_from_indices(p.indices, p.meta.d)}

    def fwd_bits(self, d):
        return self.k * (FLOAT_BITS + index_bits(d))

    def bwd_bits(self, d):
        return self.k * FLOAT_BITS    # the feature owner holds the indices


@dataclasses.dataclass(frozen=True)
class RandTopK(TopK):
    """Randomized top-k sparsification — the paper's contribution (Eq. 7).
    alpha=0 -> TopK; alpha=1 -> Dropout-like. Randomness only in training."""

    alpha: float = 0.1
    name: str = "randtopk"

    def _mask(self, x, generator, training):
        if not training:
            return selection.topk_mask(x, self.k, backend=self.backend)
        if generator is None:
            raise ValueError("RandTopK.forward(training=True) needs a "
                             "torch.Generator")
        return selection.randtopk_mask(x, self.k, self.alpha, generator,
                                       backend=self.backend)


@dataclasses.dataclass(frozen=True)
class RandTopKMask(RandTopK):
    """RandTopK with a mask-encoded wire format (Zhou et al. 2024): one
    packed d-bit support bitmask per instance replaces the index stream;
    the k values ship in ascending-index order."""

    name: str = "randtopk_mask"

    wire_kind = "mask"

    def encode(self, x, *, generator=None, training=False):
        d = x.shape[-1]
        idx, mask = self._support(x, generator, training)
        vals = torch.gather(x, -1, idx).float()
        return Payload(meta=PayloadMeta("mask", d=d, k=idx.shape[-1]),
                       values=vals,
                       indices=selection.pack_mask_words(mask.detach()))

    def _aux(self, p, x, training):
        return {"mask": selection.unpack_mask_words(p.indices, p.meta.d)}

    def fwd_bits(self, d):
        return self.k * FLOAT_BITS + 8 * ((d + 7) // 8)

    def bwd_bits(self, d):
        return self.k * FLOAT_BITS


@dataclasses.dataclass(frozen=True)
class Quantization(Compressor):
    """b-bit uniform quantization of the forward activation; backward is the
    full-precision gradient through a straight-through estimator."""

    bits: int = 4
    name: str = "quant"

    wire_kind = "quant"

    def encode(self, x, *, generator=None, training=False):
        assert self.bits <= 8, "uint8 wire codes need bits <= 8"
        code, header = quantize_rows(x.detach().float(), self.bits)
        return Payload(meta=PayloadMeta("quant", d=x.shape[-1],
                                        bits=self.bits),
                       values=code, header=header)

    def forward(self, x, *, generator=None, training=False):
        p = self.encode(x, generator=generator, training=training)
        return ste(x, self.decode(p, dtype=x.dtype)), {}

    def fwd_bits(self, d):
        return d * self.bits + 2 * FLOAT_BITS   # codes + (lo, step)

    def bwd_bits(self, d):
        return d * FLOAT_BITS


@dataclasses.dataclass(frozen=True)
class L1Reg(Compressor):
    """L1 regularization on the cut activation: identity transport in
    training (+ penalty); at inference the empirically non-zero support."""

    lam: float = 1e-3
    tol: float = 1e-6
    name: str = "l1"

    def encode(self, x, *, generator=None, training=False):
        vals = x if training else x * (x.abs() > self.tol).to(x.dtype)
        return Payload(meta=PayloadMeta("dense", d=x.shape[-1]),
                       values=vals.float())

    def _aux(self, p, x, training):
        return {} if training else {"mask": x.abs() > self.tol}

    def loss_penalty(self, x):
        return self.lam * x.float().abs().sum() / x.shape[0]

    def fwd_bits(self, d):  # not statically known; report worst case
        return d * (FLOAT_BITS + index_bits(d))

    def bwd_bits(self, d):
        return d * FLOAT_BITS


@dataclasses.dataclass(frozen=True)
class RandTopKQuant(RandTopK):
    """RandTopk + b-bit quantization of the surviving values (range over the
    selected values only)."""

    bits: int = 8
    name: str = "randtopk_quant"

    wire_kind = "sparse_quant"

    def encode(self, x, *, generator=None, training=False):
        assert self.bits <= 8, "uint8 wire codes need bits <= 8"
        d = x.shape[-1]
        idx, _ = self._support(x, generator, training)
        vals = torch.gather(x, -1, idx).float().detach()
        code, header = quantize_rows(vals, self.bits, selected=True)
        return Payload(meta=PayloadMeta("sparse_quant", d=d,
                                        k=idx.shape[-1], bits=self.bits),
                       values=code, indices=idx.to(torch.int32),
                       header=header)

    def _aux(self, p, x, training):
        return {"mask": selection.mask_from_indices(p.indices, p.meta.d)}

    def forward(self, x, *, generator=None, training=False):
        p = self.encode(x, generator=generator, training=training)
        y = self.decode(p, dtype=x.dtype)
        aux = self._aux(p, x, training)
        maskf = aux["mask"].to(x.dtype).detach()
        return ste(x * maskf, y), aux   # STE on values, masked support

    def fwd_bits(self, d):
        return self.k * (self.bits + index_bits(d)) + 2 * FLOAT_BITS

    def bwd_bits(self, d):
        return self.k * FLOAT_BITS


def make_compressor(spec: Optional[str], **kw) -> Compressor:
    """Factory: 'randtopk:k=8,alpha=0.1' style strings or kwargs."""
    if spec is None or spec == "none" or spec == "identity":
        return Compressor(**kw)
    if ":" in spec:
        name, args = spec.split(":", 1)
        for item in args.split(","):
            key, val = item.split("=")
            kw.setdefault(key, float(val) if "." in val else int(val))
    else:
        name = spec
    table = {
        "size_reduction": SizeReduction,
        "topk": TopK,
        "randtopk": RandTopK,
        "randtopk_mask": RandTopKMask,
        "quant": Quantization,
        "l1": L1Reg,
        "randtopk_quant": RandTopKQuant,
    }
    if name not in table:
        raise ValueError(f"unknown compressor {name!r}")
    return table[name](**kw)
