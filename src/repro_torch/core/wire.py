"""Byte-exact wire format for the compressed cut-layer payloads (Table 2).

The port's own copy of the reference codec (`repro/core/wire.py`): numpy
only, byte-identical frames, the same `WireError` taxonomy. The reference
module reaches `jax` through its payload import, so the port keeps this
copy instead of importing it.

`encode_payload` / `decode_payload` map a `core.payload.Payload` to and
from its bitstream. Offsets use r = ceil(log2 d) bits per index, bit-packed
little-endian. Leaves may be numpy arrays or CPU tensors in either the wire
dtypes (u8 codes, u16 indices, u32 mask words) or the port's device dtypes
(int32 throughout): the bytes are the same. `decode_payload` returns numpy
leaves in the wire dtypes.

On top sits the length-prefixed frame layer (`encode_payload_frame` /
`decode_frame` / `FrameReader`): session id, sequence number, a
self-describing payload subheader (kind / d / k / bits / batch shape), a
protocol-version byte and a CRC32 trailer over everything after the length
prefix, so corruption surfaces as a typed `WireError`, never as a
plausible-but-wrong payload. Version and CRC bytes are framing overhead:
they count in `Frame.header_nbytes`, never in `payload_nbytes`.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import struct
import zlib
from typing import Iterator, Optional, Tuple

import numpy as np

from repro_torch.core.payload import KINDS, Payload, PayloadMeta

# ---------------------------------------------------------------------------
# Typed wire-error taxonomy. Every defect a hostile/lossy byte stream can
# present decodes to one of these — never to a silently-wrong payload.
# WireError subclasses ValueError so pre-taxonomy callers keep working.
# ---------------------------------------------------------------------------

class WireError(ValueError):
    """Base class: the byte stream is not a well-formed frame."""


class ChecksumError(WireError):
    """CRC32 trailer disagrees with the frame bytes (corruption in flight)."""


class TruncatedFrame(WireError):
    """Frame body too short for its declared contents (or an absurd
    length prefix that could never be satisfied)."""


class UnknownKind(WireError):
    """Unrecognized frame kind or payload kind index."""


class BadCount(WireError):
    """A count/shape field (token count, d, k, bits, batch shape) is out of
    range or disagrees with the body length."""


class VersionMismatch(WireError):
    """Frame carries a protocol version this decoder does not speak."""


def index_bits(d: int) -> int:
    return max(1, math.ceil(math.log2(d)))


def mask_words(d: int) -> int:
    """u32 words per packed d-bit support bitmask (the device row layout the
    `mask` payload kind keeps in its `indices` leaf)."""
    return (d + 31) // 32


def mask_row_nbytes(d: int) -> int:
    """Socket bytes per packed d-bit support bitmask (byte-aligned per row)."""
    return (d + 7) // 8


def mask_words_to_bytes(words: np.ndarray, d: int) -> bytes:
    """Serialize (..., W) u32 mask words to the per-row byte-aligned wire
    layout: bit j of a row's mask is bit j%8 of its byte j//8 — i.e. the
    little-endian byte view of the little-endian words, truncated to
    `mask_row_nbytes(d)` per row."""
    w = np.ascontiguousarray(np.asarray(words).astype("<u4", copy=False))
    w = w.reshape(-1, mask_words(d))
    rows = w.view(np.uint8).reshape(w.shape[0], -1)
    return rows[:, :mask_row_nbytes(d)].tobytes()


def mask_bytes_to_words(buf, n: int, d: int) -> np.ndarray:
    """Inverse of `mask_words_to_bytes`: (n, mask_words(d)) uint32 words."""
    mb, nw = mask_row_nbytes(d), mask_words(d)
    raw = np.frombuffer(buf, dtype=np.uint8, count=n * mb)
    padded = np.zeros((n, 4 * nw), dtype=np.uint8)
    padded[:, :mb] = raw.reshape(n, mb)
    return padded.view("<u4").astype(np.uint32)


def _pack_bits(vals: np.ndarray, width: int) -> bytes:
    """Pack unsigned ints (any shape) into a bitstream, `width` bits each.

    Value i occupies absolute bit positions [i*width, (i+1)*width), least
    significant bit first; bit j of the stream is bit j%8 of byte j//8.

    Mirror of `_unpack_bits`'s two-aligned-word scheme: values are grouped
    64 per row so a group spans exactly `width` uint64 words, and a static
    loop over the 64 lanes ORs each lane into its (at most two) aligned
    words — no `(count, width)` bit matrix is ever materialized (the
    historical `>> shifts` + `np.packbits` path cost ~9 x `count x width`
    bytes of intermediates). Byte-identical outputs are pinned by
    the reference's `benchmarks/wire_packing` against the per-bit loop.
    """
    vals = np.ascontiguousarray(vals).astype(np.uint64).ravel()
    if vals.size == 0 or width == 0:
        return b""
    assert width <= 64
    n = vals.size
    groups = (n + 63) // 64
    lanes = np.zeros((groups, 64), dtype=np.uint64)
    lanes.ravel()[:n] = vals & np.uint64((1 << width) - 1)
    words = np.zeros((groups, width), dtype=np.uint64)
    for i in range(min(64, n)):
        start = i * width
        j, off = start // 64, start % 64
        words[:, j] |= lanes[:, i] << np.uint64(off)
        if off and off + width > 64:
            # spill into the next word; j+1 < width holds whenever a lane
            # spills (start + width <= 64 * width)
            words[:, j + 1] |= lanes[:, i] >> np.uint64(64 - off)
    return words.astype("<u8", copy=False).tobytes()[:(n * width + 7) // 8]


def _unpack_bits(buf: bytes, width: int, count: int) -> np.ndarray:
    """Inverse of `_pack_bits` (same little-endian bit layout).

    Value i is assembled from at most two aligned uint64 words of the
    stream (`lo = word >> bit_offset`, `hi` the spill from the next word) —
    no `(count, width)` bit matrix is ever materialized (the historical
    implementation's `unpackbits` + uint64 shift-matrix reduction cost
    ~9 x `count x width` bytes of intermediates and a per-bit reduction
    pass). Byte-identical outputs are pinned by the reference's
    `benchmarks/wire_packing` against the per-bit loop.
    """
    if count == 0 or width == 0:
        return np.zeros(count, dtype=np.uint64)
    assert width <= 64
    arr = np.frombuffer(buf, dtype=np.uint8)
    nbytes = (count * width + 7) // 8
    if arr.size < nbytes:
        raise ValueError(f"bit-packed buffer holds {arr.size} B, "
                         f"{count} x {width}-bit values need {nbytes} B")
    padded = np.zeros((nbytes // 8 + 2) * 8, dtype=np.uint8)
    padded[:nbytes] = arr[:nbytes]
    words = padded.view("<u8")
    starts = np.arange(count, dtype=np.uint64) * np.uint64(width)
    wi = (starts >> np.uint64(6)).astype(np.int64)
    bit = starts & np.uint64(63)
    lo = words[wi] >> bit
    hi = words[wi + 1] << ((np.uint64(64) - bit) & np.uint64(63))
    hi = np.where(bit == np.uint64(0), np.uint64(0), hi)
    return (lo | hi) & np.uint64((1 << width) - 1)


# ---------------------------------------------------------------------------
# Payload serialization — one codec for every compressor kind.
# ---------------------------------------------------------------------------

def encode_payload(p: Payload) -> bytes:
    """Serialize a Payload to the exact bitstream a two-party socket carries.

    Layout per kind (leading instance dims flattened, C order):
      dense/slice : values f32
      sparse      : values f32, then indices packed @ r = ceil(log2 d) bits
      quant       : header f32 (lo, step)/instance, then codes packed @ bits
      sparse_quant: header f32, then indices packed @ r, then codes @ bits
      mask        : values f32 (ascending-index order), then one packed
                    d-bit support mask per instance, byte-aligned per row
    """
    m = p.meta
    kind = m.kind
    if kind in ("dense", "slice"):
        return np.asarray(p.values).astype("<f4").tobytes()
    if kind == "mask":
        return (np.asarray(p.values).astype("<f4").tobytes()
                + mask_words_to_bytes(np.asarray(p.indices), m.d))
    if kind == "sparse":
        return (np.asarray(p.values).astype("<f4").tobytes()
                + _pack_bits(np.asarray(p.indices), index_bits(m.d)))
    if kind == "quant":
        return (np.asarray(p.header).astype("<f4").tobytes()
                + _pack_bits(np.asarray(p.values), m.bits))
    if kind == "sparse_quant":
        return (np.asarray(p.header).astype("<f4").tobytes()
                + _pack_bits(np.asarray(p.indices), index_bits(m.d))
                + _pack_bits(np.asarray(p.values), m.bits))
    raise ValueError(kind)


def decode_payload(buf: bytes, meta: PayloadMeta, batch_shape) -> Payload:
    """Inverse of `encode_payload`; returns a Payload of numpy arrays.

    `buf` must be exclusively owned by the caller and never mutated after
    this call: the float leaves are zero-copy `np.frombuffer` views into it
    (the frame layer hands each payload a fresh body slice, so the hot
    receive path does one copy — the slice — instead of one per leaf).
    """
    n = int(np.prod(batch_shape, dtype=np.int64)) if batch_shape else 1
    kind, d, k = meta.kind, meta.d, meta.k
    if kind in ("dense", "slice"):
        w = d if kind == "dense" else k
        vals = np.frombuffer(buf, dtype="<f4", count=n * w)
        return Payload(meta=meta, values=vals.reshape(*batch_shape, w))
    if kind == "sparse":
        vals = np.frombuffer(buf, dtype="<f4", count=n * k)
        idx = _unpack_bits(buf[4 * n * k:], index_bits(d), n * k)
        return Payload(meta=meta,
                       values=vals.reshape(*batch_shape, k),
                       indices=idx.astype(np.uint16).reshape(*batch_shape, k))
    if kind == "mask":
        vals = np.frombuffer(buf, dtype="<f4", count=n * k)
        words = mask_bytes_to_words(buf[4 * n * k:], n, d)
        return Payload(meta=meta,
                       values=vals.reshape(*batch_shape, k),
                       indices=words.reshape(*batch_shape, mask_words(d)))
    if kind == "quant":
        head = np.frombuffer(buf, dtype="<f4", count=2 * n)
        codes = _unpack_bits(buf[8 * n:], meta.bits, n * d)
        return Payload(meta=meta,
                       values=codes.astype(np.uint8).reshape(*batch_shape, d),
                       header=head.reshape(*batch_shape, 2))
    if kind == "sparse_quant":
        r = index_bits(d)
        head = np.frombuffer(buf, dtype="<f4", count=2 * n)
        off = 8 * n
        idx_nbytes = (n * k * r + 7) // 8
        idx = _unpack_bits(buf[off: off + idx_nbytes], r, n * k)
        codes = _unpack_bits(buf[off + idx_nbytes:], meta.bits, n * k)
        return Payload(meta=meta,
                       values=codes.astype(np.uint8).reshape(*batch_shape, k),
                       indices=idx.astype(np.uint16).reshape(*batch_shape, k),
                       header=head.reshape(*batch_shape, 2))
    raise ValueError(kind)


def payload_nbytes(p: Payload) -> int:
    """Measured socket bytes of a payload (bit-packed, headers included)."""
    return len(encode_payload(p))


FLOAT_BITS = 32  # N in the paper


def payload_bits_per_instance(meta: PayloadMeta) -> float:
    """Analytic forward wire bits per instance for a payload kind, the
    codec-side counterpart of `table2_row`."""
    kind, d, k, r = meta.kind, meta.d, meta.k, index_bits(meta.d)
    if kind == "dense":
        return d * FLOAT_BITS
    if kind == "slice":
        return k * FLOAT_BITS
    if kind == "sparse":
        return k * (FLOAT_BITS + r)
    if kind == "mask":
        return k * FLOAT_BITS + 8 * mask_row_nbytes(d)
    if kind == "quant":
        return d * meta.bits + 2 * FLOAT_BITS
    if kind == "sparse_quant":
        return k * (meta.bits + r) + 2 * FLOAT_BITS
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Table-2 analytic sizes (relative to d * 32 bits), per instance.
# ---------------------------------------------------------------------------


def table2_row(method: str, d: int, *, k: float = 0, bits: int = 0) -> dict:
    r = index_bits(d)
    n = FLOAT_BITS
    if method == "size_reduction":
        fwd = bwd = k / d
    elif method in ("topk", "randtopk"):
        fwd = k / d * (1 + r / n)
        bwd = k / d
    elif method == "randtopk_mask":
        # k floats + one packed d-bit support mask (byte-aligned)
        fwd = (k * n + 8 * mask_row_nbytes(d)) / (d * n)
        bwd = k / d
    elif method == "quant":
        fwd = bits / n
        bwd = 1.0
    elif method == "l1":
        fwd = k / d * (1 + r / n)  # k = measured nnz
        bwd = 1.0
    elif method == "randtopk_quant":
        fwd = (k * (bits + r) + 2 * n) / (d * n)
        bwd = k / d
    elif method == "identity":
        fwd = bwd = 1.0
    else:
        raise ValueError(method)
    return {"method": method, "fwd": fwd, "bwd": bwd}


def bytes_per_step(method: str, d: int, n_instances: int, *, k: float = 0,
                   bits: int = 0, training: bool = True) -> float:
    """Wire bytes for one batch step (fwd + optionally bwd)."""
    row = table2_row(method, d, k=k, bits=bits)
    per_inst = row["fwd"] + (row["bwd"] if training else 0.0)
    return per_inst * d * FLOAT_BITS / 8 * n_instances


# ---------------------------------------------------------------------------
# Frame layer — the length-prefixed unit a streaming session sends.
# ---------------------------------------------------------------------------

#: version 2 = CRC32 trailer appended and counted in body_len (v1 had no
#: trailer); a v1 peer's frames fail the version gate, not the CRC gate
WIRE_VERSION = 2

#: frame kinds
FRAME_PAYLOAD = 1   # client -> server: one compressed cut activation
FRAME_TOKENS = 2    # server -> client: greedy-decoded next token(s)
FRAME_CLOSE = 3     # either direction: end of session
FRAME_GRAD = 4      # server -> client: compressed cut gradient + step loss
FRAME_ERROR = 5     # either direction: typed rejection, connection is dying

# <u32 body_len> <u8 version> <u8 frame_kind> <u32 session> <u32 seq>
_FRAME_HEAD = struct.Struct("<IBBII")
# payload-frame subheader: <u8 kind_idx> <u32 d> <u32 k> <u8 bits> <u8 ndim>
_PAYLOAD_HEAD = struct.Struct("<BIIBB")
_TOKENS_HEAD = struct.Struct("<I")       # <u32 count>, then count x i32
_GRAD_TAIL = struct.Struct("<f")         # <f32 loss> closing a grad subheader
_ERROR_HEAD = struct.Struct("<BH")       # <u8 code> <u16 msg_len>, then msg
_CRC = struct.Struct("<I")               # crc32 trailer closing every frame

#: a length prefix beyond this is treated as corrupt rather than waited on
MAX_FRAME_BODY = 1 << 27
#: max batch-shape rank a payload subheader may declare
MAX_PAYLOAD_NDIM = 8

#: error-frame codes, one per WireError subclass
ERR_CHECKSUM, ERR_TRUNCATED, ERR_UNKNOWN_KIND, ERR_BAD_COUNT, \
    ERR_VERSION, ERR_PROTOCOL = 1, 2, 3, 4, 5, 6

_ERROR_CODES = ((ChecksumError, ERR_CHECKSUM), (TruncatedFrame, ERR_TRUNCATED),
                (UnknownKind, ERR_UNKNOWN_KIND), (BadCount, ERR_BAD_COUNT),
                (VersionMismatch, ERR_VERSION))


def error_code(exc: BaseException) -> int:
    """Map a WireError (or any rejection) to its error-frame code."""
    for cls, code in _ERROR_CODES:
        if isinstance(exc, cls):
            return code
    return ERR_PROTOCOL


@dataclasses.dataclass(frozen=True)
class Frame:
    """One decoded wire frame.

    `header_nbytes` counts every byte that is framing/metadata (length
    prefix, version, kind, session, seq, payload subheader);
    `payload_nbytes` counts only the payload bitstream (token bytes for
    FRAME_TOKENS). Byte accounting in `repro_torch.runtime` keeps the two apart so
    compression ratios are computed from the payload bytes the codec actually
    produced, with framing overhead reported separately.
    """

    kind: int
    session: int
    seq: int
    payload: Optional[Payload] = None       # FRAME_PAYLOAD / FRAME_GRAD
    tokens: Optional[np.ndarray] = None     # FRAME_TOKENS, int32
    loss: Optional[float] = None            # FRAME_GRAD, training step loss
    error_code: Optional[int] = None        # FRAME_ERROR, ERR_* code
    error_msg: Optional[str] = None         # FRAME_ERROR, short description
    header_nbytes: int = 0
    payload_nbytes: int = 0

    @property
    def nbytes(self) -> int:
        return self.header_nbytes + self.payload_nbytes


def _frame(kind: int, session: int, seq: int, body: bytes) -> bytes:
    head = _FRAME_HEAD.pack(
        len(body) + _FRAME_HEAD.size - 4 + _CRC.size, WIRE_VERSION,
        kind, session, seq)
    buf = head + body
    # crc32 covers version..body (everything after the length prefix)
    return buf + _CRC.pack(zlib.crc32(memoryview(buf)[4:]))


def payload_frame_header_nbytes(p: Payload) -> int:
    """Framing bytes of `encode_payload_frame(p)` — everything that is not
    the payload bitstream (deterministic; used for byte accounting without
    re-encoding the payload)."""
    return (_FRAME_HEAD.size + _PAYLOAD_HEAD.size + 4 * len(p.batch_shape)
            + _CRC.size)


# memoized: a streaming session re-frames the SAME (meta, batch_shape)
# every step, and the subheader/byte-count recompute was a measurable
# slice of the per-frame host pack time (the reference's serve_throughput
# encode gate). Bounded: one entry per distinct payload meta in the process.
@functools.lru_cache(maxsize=4096)
def _meta_subheader(m: PayloadMeta, bshape) -> bytes:
    sub = _PAYLOAD_HEAD.pack(KINDS.index(m.kind), m.d, m.k, m.bits,
                             len(bshape))
    return sub + (struct.pack(f"<{len(bshape)}I", *bshape) if bshape else b"")


def _payload_subheader(p: Payload) -> bytes:
    return _meta_subheader(p.meta, p.batch_shape)


def encode_payload_frame(session: int, seq: int, p: Payload) -> bytes:
    """Frame a payload: self-describing subheader + `encode_payload` bytes."""
    return _frame(FRAME_PAYLOAD, session, seq,
                  _payload_subheader(p) + encode_payload(p))


def encode_payload_frame_from_bytes(session: int, seq: int, m: PayloadMeta,
                                    batch_shape, body: bytes) -> bytes:
    """Frame an already-serialized payload bitstream (the device encode
    path: `kernels/encode` packs the wire sections on device, so the host's
    only work is this subheader + CRC wrap of the pulled buffer). `body`
    must be exactly the bytes `encode_payload` would produce — the length
    is checked here, byte equality is pinned in tests."""
    expect = payload_expected_nbytes(m, batch_shape)
    if len(body) != expect:
        raise BadCount(f"{m.kind} payload of batch shape "
                       f"{tuple(batch_shape)} needs {expect} B, device "
                       f"buffer holds {len(body)} B")
    return _frame(FRAME_PAYLOAD, session, seq,
                  _meta_subheader(m, tuple(batch_shape)) + body)


def grad_frame_header_nbytes(p: Payload) -> int:
    """Framing bytes of `encode_grad_frame(p)`: the payload-frame header
    plus the f32 loss the training reply carries."""
    return payload_frame_header_nbytes(p) + _GRAD_TAIL.size


def encode_grad_frame(session: int, seq: int, p: Payload,
                      loss: float = 0.0) -> bytes:
    """Frame a backward cut-gradient payload (training direction).

    The subheader mirrors the payload frame (the gradient is itself a
    `Payload` — `slice` of k floats for sparse forward kinds, `dense`
    otherwise, per Table 2 bwd), followed by one f32 `loss`: the label
    owner's scalar step loss, which the feature owner needs for logging and
    adaptive-k scheduling. The loss is framing metadata, not codec
    bitstream — byte accounting keeps it out of `payload_nbytes`.
    """
    return _frame(FRAME_GRAD, session, seq,
                  _payload_subheader(p) + _GRAD_TAIL.pack(loss)
                  + encode_payload(p))


def encode_token_frame(session: int, seq: int, tokens) -> bytes:
    toks = np.asarray(tokens, dtype="<i4").ravel()
    return _frame(FRAME_TOKENS, session, seq,
                  _TOKENS_HEAD.pack(toks.size) + toks.tobytes())


def encode_close_frame(session: int, seq: int = 0) -> bytes:
    return _frame(FRAME_CLOSE, session, seq, b"")


def encode_error_frame(session: int, seq: int, code: int,
                       msg: str = "") -> bytes:
    """Frame a typed rejection: the receiver of a malformed frame reports
    the `ERR_*` code + a short reason, then closes the connection. The
    session may then be resumed over a fresh connection (seq replay)."""
    mb = msg.encode("utf-8", "replace")[:512]
    return _frame(FRAME_ERROR, session, seq, _ERROR_HEAD.pack(code, len(mb))
                  + mb)


def payload_expected_nbytes(meta: PayloadMeta, batch_shape) -> int:
    """Exact `encode_payload` byte count for (meta, batch_shape) — each
    bit-packed section rounds up to whole bytes independently."""
    return _expected_nbytes(meta, tuple(batch_shape))


@functools.lru_cache(maxsize=4096)
def _expected_nbytes(meta: PayloadMeta, batch_shape) -> int:
    n = int(np.prod(batch_shape, dtype=np.int64)) if batch_shape else 1
    kind, d, k, r = meta.kind, meta.d, meta.k, index_bits(meta.d)
    if kind == "dense":
        return 4 * n * d
    if kind == "slice":
        return 4 * n * k
    if kind == "sparse":
        return 4 * n * k + (n * k * r + 7) // 8
    if kind == "mask":
        return 4 * n * k + n * mask_row_nbytes(d)
    if kind == "quant":
        return 8 * n + (n * d * meta.bits + 7) // 8
    if kind == "sparse_quant":
        return 8 * n + (n * k * r + 7) // 8 + (n * k * meta.bits + 7) // 8
    raise UnknownKind(kind)


def _validated_meta(kind_idx: int, d: int, k: int, bits: int) -> PayloadMeta:
    if kind_idx >= len(KINDS):
        raise UnknownKind(f"payload kind index {kind_idx}")
    kind = KINDS[kind_idx]
    if not 1 <= d <= 65536:                 # uint16 indices bound d
        raise BadCount(f"payload d={d} out of range")
    if kind in ("slice", "sparse", "sparse_quant", "mask") and not 1 <= k <= d:
        raise BadCount(f"{kind} payload k={k} out of range for d={d}")
    if kind in ("quant", "sparse_quant") and not 1 <= bits <= 8:
        raise BadCount(f"{kind} payload bits={bits} out of range")
    return PayloadMeta(kind, d=d, k=k, bits=bits)


def decode_frame(buf, offset: int = 0) -> Optional[Tuple[Frame, int]]:
    """Parse one frame starting at `offset` (bytes or bytearray).

    Returns (frame, next_offset), or None if the buffer does not yet hold a
    complete frame (stream reassembly — see `FrameReader`). A frame that is
    complete per its length prefix but malformed raises a typed `WireError`:
    the CRC32 trailer is verified before anything else is trusted, so a
    flipped bit anywhere surfaces as `ChecksumError`, never as silently
    wrong indices/values.
    """
    if len(buf) - offset < 4:
        return None
    (body_len,) = struct.unpack_from("<I", buf, offset)
    if body_len < _FRAME_HEAD.size - 4 + _CRC.size:
        raise TruncatedFrame(f"frame body length {body_len} below the "
                             f"head+crc minimum")
    if body_len > MAX_FRAME_BODY:
        raise TruncatedFrame(f"frame body length {body_len} exceeds "
                             f"MAX_FRAME_BODY ({MAX_FRAME_BODY})")
    end = offset + 4 + body_len
    if len(buf) < end:
        return None
    body_end = end - _CRC.size
    _, version, kind, session, seq = _FRAME_HEAD.unpack_from(buf, offset)
    # version gate BEFORE the checksum gate: a peer speaking another layout
    # (e.g. v1, whose frames carry no CRC trailer) must surface as a
    # version skew, not as phantom corruption
    if version != WIRE_VERSION:
        raise VersionMismatch(f"wire version {version}, expected "
                              f"{WIRE_VERSION}")
    (crc_stored,) = _CRC.unpack_from(buf, body_end)
    crc = zlib.crc32(memoryview(buf)[offset + 4: body_end])
    if crc != crc_stored:
        raise ChecksumError(f"frame crc32 {crc_stored:#010x} != computed "
                            f"{crc:#010x}")
    pos = offset + _FRAME_HEAD.size
    if kind in (FRAME_PAYLOAD, FRAME_GRAD):
        if pos + _PAYLOAD_HEAD.size > body_end:
            raise TruncatedFrame("payload subheader overruns frame body")
        kind_idx, d, k, bits, ndim = _PAYLOAD_HEAD.unpack_from(buf, pos)
        pos += _PAYLOAD_HEAD.size
        if ndim > MAX_PAYLOAD_NDIM:
            raise BadCount(f"payload batch rank {ndim} exceeds "
                           f"{MAX_PAYLOAD_NDIM}")
        if pos + 4 * ndim > body_end:
            raise TruncatedFrame("payload batch shape overruns frame body")
        bshape = struct.unpack_from(f"<{ndim}I", buf, pos) if ndim else ()
        pos += 4 * ndim
        if any(dim < 1 for dim in bshape):
            raise BadCount(f"payload batch shape {bshape} has a zero dim")
        loss = None
        if kind == FRAME_GRAD:
            if pos + _GRAD_TAIL.size > body_end:
                raise TruncatedFrame("grad loss field overruns frame body")
            (loss,) = _GRAD_TAIL.unpack_from(buf, pos)
            pos += _GRAD_TAIL.size
        meta = _validated_meta(kind_idx, d, k, bits)
        expect = payload_expected_nbytes(meta, bshape)
        if body_end - pos != expect:
            raise BadCount(f"{meta.kind} payload of batch shape {bshape} "
                           f"needs {expect} B, frame carries "
                           f"{body_end - pos} B")
        payload = decode_payload(buf[pos:body_end], meta, bshape)
        return (Frame(kind, session, seq, payload=payload, loss=loss,
                      header_nbytes=pos - offset + _CRC.size,
                      payload_nbytes=body_end - pos), end)
    if kind == FRAME_TOKENS:
        if pos + _TOKENS_HEAD.size > body_end:
            raise TruncatedFrame("token count field overruns frame body")
        (count,) = _TOKENS_HEAD.unpack_from(buf, pos)
        pos += _TOKENS_HEAD.size
        if pos + 4 * count != body_end:
            raise BadCount(f"token frame count {count} disagrees with "
                           f"body length {body_end - pos}")
        toks = np.frombuffer(buf, dtype="<i4", count=count, offset=pos).copy()
        return (Frame(kind, session, seq, tokens=toks,
                      header_nbytes=(_FRAME_HEAD.size + _TOKENS_HEAD.size
                                     + _CRC.size),
                      payload_nbytes=4 * count), end)
    if kind == FRAME_CLOSE:
        if pos != body_end:
            raise BadCount(f"close frame carries {body_end - pos} "
                           f"unexpected body bytes")
        return (Frame(kind, session, seq,
                      header_nbytes=_FRAME_HEAD.size + _CRC.size), end)
    if kind == FRAME_ERROR:
        if pos + _ERROR_HEAD.size > body_end:
            raise TruncatedFrame("error frame header overruns frame body")
        code, msg_len = _ERROR_HEAD.unpack_from(buf, pos)
        pos += _ERROR_HEAD.size
        if pos + msg_len != body_end:
            raise BadCount(f"error frame msg_len {msg_len} disagrees with "
                           f"body length {body_end - pos}")
        msg = bytes(buf[pos:body_end]).decode("utf-8", "replace")
        return (Frame(kind, session, seq, error_code=code, error_msg=msg,
                      header_nbytes=end - offset), end)
    raise UnknownKind(f"unknown frame kind {kind}")


class FrameReader:
    """Incremental stream reassembler: feed byte chunks, iterate frames.

    Chunk boundaries need not align with frame boundaries — partial frames
    are buffered until complete, and consumed prefixes are dropped.

    A `WireError` raised mid-iteration poisons the reader: frame boundaries
    downstream of a corrupt length/CRC cannot be trusted, so every later
    `frames()` call re-raises and the connection must be torn down (the
    session itself can resume over a fresh connection — see
    `repro_torch.runtime`).
    """

    def __init__(self):
        self._buf = bytearray()
        self._broken: Optional[WireError] = None

    def feed(self, data: bytes) -> None:
        self._buf.extend(data)

    def frames(self) -> Iterator[Frame]:
        if self._broken is not None:
            raise self._broken
        while True:
            # decode straight off the bytearray (no full-buffer copy);
            # decode_payload copies out every array it returns
            try:
                got = decode_frame(self._buf)
            except WireError as e:
                self._broken = e
                raise
            if got is None:
                return
            frame, consumed = got
            # trim BEFORE yielding: an abandoned iterator must not re-yield
            del self._buf[:consumed]
            yield frame
