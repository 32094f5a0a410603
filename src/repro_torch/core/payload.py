"""Typed cut-layer payload — the single object that crosses the wire.

Same kinds, field names and wire order as the JAX reference. On the device
the leaves stay in 32-bit, kernel-friendly dtypes:

  values   float32 (dense/slice/sparse/mask) or int32 codes (quant kinds)
  indices  int32 support indices (sparse kinds) or int32 words holding the
           packed d-bit support bitmask (mask kind, bit pattern of u32)
  header   float32 per-instance (lo, step) (quant kinds)

They are narrowed to u8 codes, u16 indices and u32 words only as numpy
arrays at the wire (`to_host`, `core.wire`). `to_device` widens a numpy
payload decoded from a frame back to the device dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

# "mask" is last: the wire subheader serializes the kind as its index into
# this tuple, so the order is part of the frame format.
KINDS = ("dense", "slice", "sparse", "quant", "sparse_quant", "mask")

#: wire-leaf field names, in transfer order
WIRE_FIELDS = ("values", "indices", "header")

QUANT_KINDS = ("quant", "sparse_quant")

#: the wire leaves each kind carries, in WIRE_FIELDS order (also the order
#: of the encode kernel's outputs and the decode kernel's inputs)
KIND_LEAVES = {
    "dense": ("values",),
    "slice": ("values",),
    "sparse": ("values", "indices"),
    "quant": ("values", "header"),
    "sparse_quant": ("values", "indices", "header"),
    "mask": ("values", "indices"),
}


@dataclasses.dataclass(frozen=True)
class PayloadMeta:
    """Static (hashable) payload descriptor."""

    kind: str                       # one of KINDS
    d: int                          # dense feature width of the decoded view
    k: int = 0                      # support size (slice/sparse kinds)
    bits: int = 0                   # code width (quant kinds)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown payload kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class Payload:
    """Wire leaves (torch tensors on a device, or numpy arrays on host) plus
    static meta."""

    meta: PayloadMeta
    values: Any
    indices: Optional[Any] = None
    header: Optional[Any] = None

    def wire_leaves(self) -> Tuple[Tuple[str, Any], ...]:
        """(name, array) pairs of the leaves that actually cross the wire."""
        return tuple((f, getattr(self, f)) for f in WIRE_FIELDS
                     if getattr(self, f) is not None)

    def with_leaves(self, **leaves) -> "Payload":
        return dataclasses.replace(self, **leaves)

    @property
    def batch_shape(self):
        return tuple(self.values.shape[:-1])


def _wire_dtype(meta: PayloadMeta, field: str):
    if field == "values":
        return np.uint8 if meta.kind in QUANT_KINDS else np.float32
    if field == "indices":
        return np.uint32 if meta.kind == "mask" else np.uint16
    return np.float32


def to_host(p: Payload) -> Payload:
    """Device payload -> numpy leaves in the reference's wire dtypes (u8
    codes, u16 indices, u32 mask words). `.cpu()` synchronizes."""
    leaves = {}
    for name, a in p.wire_leaves():
        arr = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        dt = _wire_dtype(p.meta, name)
        if dt == np.uint32 and arr.dtype == np.int32:
            arr = arr.view(np.uint32)      # bit pattern, not a value cast
        leaves[name] = arr.astype(dt, copy=False)
    return p.with_leaves(**leaves)


def device_leaf(a, field: str, device) -> torch.Tensor:
    """One wire leaf (numpy in a wire dtype, or a tensor) as a device tensor
    in its kernel dtype: float32 values/header, int32 codes/indices/words."""
    if torch.is_tensor(a):
        t = a
    else:
        arr = np.asarray(a)
        if arr.dtype == np.uint32:
            arr = arr.view(np.int32)       # keep the bit pattern
        elif arr.dtype != np.float32:
            arr = arr.astype(np.int32)
        # a leaf decoded from a frame is a read-only view of its bytes
        t = torch.from_numpy(arr.copy() if not arr.flags.writeable
                             else np.ascontiguousarray(arr))
    want = torch.float32 if t.is_floating_point() else torch.int32
    return t.to(device=device, dtype=want)


def to_device(p: Payload, device) -> Payload:
    """Numpy (wire-dtype) payload -> device tensors in the kernel dtypes."""
    return p.with_leaves(**{n: device_leaf(a, n, device)
                            for n, a in p.wire_leaves()})
