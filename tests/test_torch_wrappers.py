"""The host side of the `encode_rows`, `pack_bits`, `decode_rows`,
`decode_rows_to_slots` and `quantize` wrappers, on the CPU with a fake
library in place of the built kernels: the checks that run once per key
(`encode_plan`, `pack_plan`, `rows_plan`, `slots_plan`, `quant_plan`)
raise where the
kernels cannot take an input; the outputs a launch allocates have the plain
version's shapes and dtypes, do not overlap and start 16-byte aligned;
and a launch hands the kernel the pointers and scalars its C signature
(`_lib.SIGNATURES`) expects."""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.core.payload import KIND_LEAVES, KINDS, PayloadMeta
from repro_torch.kernels import _lib
from repro_torch.kernels.decode import ops as dec_ops
from repro_torch.kernels.decode import ref as dec_ref
from repro_torch.kernels.encode import ops as enc_ops
from repro_torch.kernels.encode import ref as enc_ref
from repro_torch.kernels.quant import ops as q_ops
from repro_torch.kernels.quant import ref as q_ref
from repro_torch.kernels.randtopk import ref as tk_ref

STREAM = 0xC0FFEE
WIDTHS = (70, 1000, 4096, 16384)
QUANT = ("quant", "sparse_quant")


class _FakeFn:
    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


class _FakeLib:
    def __init__(self):
        for name in _lib.SIGNATURES:
            setattr(self, name, _FakeFn())


@pytest.fixture
def fake(monkeypatch):
    """The fake library behind `_lib`, and a fixed stream handle."""
    lib = _FakeLib()
    monkeypatch.setattr(_lib, "_LIB", None)
    monkeypatch.setattr(_lib, "_FNS", {})
    monkeypatch.setattr(_lib, "_load", lambda: lib)
    monkeypatch.setattr(_lib, "stream_handle", lambda t: STREAM)
    _lib.reset_launch_counts()
    yield lib
    _lib.reset_launch_counts()


def _k_bits(kind, d):
    k = 0 if kind in ("dense", "quant") else min(64, d - 1)
    return k, (4 if kind in QUANT else 0)


def _x_mask(kind, lead, d, k, dtype=torch.float32):
    g = np.random.default_rng(d)
    x = torch.from_numpy(g.standard_normal(lead + (d,)).astype(np.float32))
    x = x.to(dtype)
    mask = (tk_ref.topk_mask_threshold(x, k)[0]
            if kind in enc_ops.MASK_KINDS else None)
    return x, mask


def _assert_signature(name, args):
    """Each argument converts to its ctypes type without loss."""
    types = _lib.SIGNATURES[name]
    assert len(args) == len(types)
    for a, t in zip(args, types):
        assert isinstance(a, int), (name, args)
        if t is ctypes.c_int:
            assert -2 ** 31 <= a < 2 ** 31
            assert t(a).value == a
        elif t is ctypes.c_longlong:
            assert 0 <= a < 2 ** 63
        else:
            assert t is ctypes.c_void_p and 0 <= a < 2 ** 64
            assert (t(a).value or 0) == a


def _spans(leaves):
    return sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
                  for t in leaves)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("kind", list(KIND_LEAVES))
def test_encode_outputs_match_plain_layout(fake, kind, d):
    k, bits = _k_bits(kind, d)
    x, mask = _x_mask(kind, (3,), d, k)
    plan = enc_ops.encode_plan(kind, x.shape, x.dtype, k, bits)
    p = enc_ops.launch_encode(plan, x, mask)
    leaves = [getattr(p, name) for name in KIND_LEAVES[kind]]
    want = enc_ref.encode_rows(x, kind, k, bits, mask)
    assert len(leaves) == len(want) == len(plan.leaves)
    for a, b, (shape, dt) in zip(leaves, want, plan.leaves):
        assert a.shape == b.shape == shape and a.dtype == b.dtype == dt
        assert a.is_contiguous() and a.data_ptr() % 16 == 0
    spans = _spans(leaves)
    assert all(e <= s for (_, e), (s, _) in zip(spans, spans[1:]))


@pytest.mark.parametrize("lead", [(), (1,), (2, 5)])
def test_encode_layout_keeps_leading_dims(fake, lead):
    d, k = 1000, 64
    x, mask = _x_mask("sparse", lead, d, k)
    plan = enc_ops.encode_plan("sparse", x.shape, x.dtype, k, 0)
    p = enc_ops.launch_encode(plan, x, mask)
    assert p.values.shape == p.indices.shape == lead + (k,)
    assert plan.rows == int(np.prod(lead))
    (args,) = fake.encode_rows.calls
    assert args[3] == plan.rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", list(KIND_LEAVES))
def test_encode_launch_passes_signature_args(fake, kind, dtype):
    d = 4096
    k, bits = _k_bits(kind, d)
    x, mask = _x_mask(kind, (2,), d, k, dtype)
    plan = enc_ops.encode_plan(kind, x.shape, x.dtype, k, bits)
    p = enc_ops.launch_encode(plan, x, mask)
    (args,) = fake.encode_rows.calls
    _assert_signature("encode_rows", args)
    leaves = [getattr(p, name) for name in KIND_LEAVES[kind]]
    outs = [t.data_ptr() for t in leaves] + [0] * (3 - len(leaves))
    assert args == (x.data_ptr(), int(dtype == torch.bfloat16),
                    0 if mask is None else mask.data_ptr(), 2, d,
                    KINDS.index(kind), p.meta.k, p.meta.bits, *outs, STREAM)
    plain = enc_ops.encode_rows(x, kind, k=k, bits=bits, mask=mask,
                                backend="torch")
    assert p.meta == plain.meta
    for name in KIND_LEAVES[kind]:
        a, b = getattr(p, name), getattr(plain, name)
        assert a.shape == b.shape and a.dtype == b.dtype
    assert _lib.launch_counts()["encode_rows"] == 1


def test_encode_plan_is_resolved_once_per_key(fake):
    x, mask = _x_mask("sparse", (1,), 4096, 64, torch.bfloat16)
    key = ("sparse", x.shape, x.dtype, 64, 0)
    assert enc_ops.encode_plan(*key) is enc_ops.encode_plan(*key)


@pytest.mark.parametrize("kind, shape, dtype, k, bits, err", [
    ("sparse", (2, 64), torch.float16, 8, 0, TypeError),
    ("dense", (2, 64), torch.int32, 0, 0, TypeError),
    ("sparse", (1, 16385), torch.float32, 8, 0, ValueError),
    ("dense", (1, 16385), torch.bfloat16, 0, 0, ValueError),
    ("sparse", (2, 64), torch.float32, 0, 0, ValueError),
    ("mask", (2, 64), torch.float32, 65, 0, ValueError),
    ("slice", (2, 64), torch.float32, 0, 0, ValueError),
    ("quant", (2, 64), torch.float32, 0, 0, ValueError),
    ("sparse_quant", (2, 64), torch.float32, 8, 9, ValueError),
    ("bogus", (2, 64), torch.float32, 8, 0, ValueError),
])
def test_encode_plan_raises(kind, shape, dtype, k, bits, err):
    with pytest.raises(err):
        enc_ops.encode_plan(kind, torch.Size(shape), dtype, k, bits)


def test_encode_launch_raises_on_bad_mask(fake):
    x, mask = _x_mask("sparse", (2,), 64, 8)
    plan = enc_ops.encode_plan("sparse", x.shape, x.dtype, 8, 0)
    with pytest.raises(ValueError, match="mask"):
        enc_ops.launch_encode(plan, x, None)
    with pytest.raises(ValueError, match="mask"):
        enc_ops.launch_encode(plan, x, mask[:, :32])
    assert not fake.encode_rows.calls


def _payload(kind, lead, d, dtype=torch.float32):
    k, bits = _k_bits(kind, d)
    x, mask = _x_mask(kind, lead, d, k)
    return enc_ops.encode_rows(x.to(dtype), kind, k=k, bits=bits, mask=mask,
                               backend="torch")


def _rows_plan(p, dtype):
    return dec_ops.rows_plan(p.meta, dtype, dec_ops._sig(p.values),
                             dec_ops._sig(p.indices), dec_ops._sig(p.header))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("kind", list(KIND_LEAVES))
def test_decode_launch_passes_signature_args(fake, kind, d, dtype):
    p = _payload(kind, (2, 3), d)
    plan = _rows_plan(p, dtype)
    assert plan.convert is None      # the plain encode gives kernel dtypes
    out = dec_ops.launch_rows(plan, p.values, p.indices, p.header, dtype)
    want = dec_ref.decode_rows(p, dtype)
    assert out.shape == want.shape and out.dtype == want.dtype
    (args,) = fake.decode_rows.calls
    _assert_signature("decode_rows", args)
    idx = p.indices.data_ptr() if kind in ("sparse", "sparse_quant",
                                           "mask") else 0
    hdr = p.header.data_ptr() if kind in QUANT else 0
    assert args == (p.values.data_ptr(), 0, idx, hdr, 6, d,
                    KINDS.index(kind), p.meta.k, out.data_ptr(),
                    int(dtype == torch.bfloat16), STREAM)
    assert _lib.launch_counts()["decode_rows"] == 1


def test_decode_launch_with_projection_passes_scratch(fake):
    p = _payload("sparse", (4,), 1000)
    w = torch.randn(1000, 96)
    plan = _rows_plan(p, torch.bfloat16)
    out = dec_ops.launch_rows(plan, p.values, p.indices, p.header,
                              torch.bfloat16, w)
    assert out.shape == (4, 96) and out.dtype == torch.bfloat16
    assert not fake.decode_rows.calls
    (args,) = fake.decode_rows_project.calls
    _assert_signature("decode_rows_project", args)
    assert args[:8] == (p.values.data_ptr(), 0, p.indices.data_ptr(), 0, 4,
                        1000, KINDS.index("sparse"), 64)
    assert args[8] == w.data_ptr() and args[9] == 96
    assert args[10] != 0 and args[11] == out.data_ptr() and args[12] == 1
    assert _lib.launch_counts()["decode_rows_project"] == 1


def test_decode_converts_only_leaves_off_the_kernel_dtypes(fake):
    """Wire dtypes (u16 indices as int64, f64 values) are converted; bf16
    values and int32 indices are handed over as they are."""
    p = _payload("sparse", (2,), 1000)
    wide = p.with_leaves(values=p.values.double(),
                         indices=p.indices.long())
    plan = _rows_plan(wide, torch.float32)
    assert plan.convert == (torch.float32, torch.int32, None)
    assert plan.vals_bf16 == 0
    dec_ops.launch_rows(plan, wide.values, wide.indices, None,
                        torch.float32)
    half = p.with_leaves(values=p.values.bfloat16())
    plan = _rows_plan(half, torch.float32)
    assert plan.convert is None and plan.vals_bf16 == 1
    dec_ops.launch_rows(plan, half.values, half.indices, None,
                        torch.float32)
    assert fake.decode_rows.calls[-1][0] == half.values.data_ptr()


def test_decode_plan_is_resolved_once_per_key():
    p = _payload("sparse", (2,), 4096)
    assert _rows_plan(p, torch.bfloat16) is _rows_plan(p, torch.bfloat16)


def _bad_payloads():
    p = _payload("sparse", (2,), 1000)
    q = _payload("quant", (2,), 1000)
    yield p.with_leaves(indices=p.indices[:, :-1]), torch.float32, ValueError
    yield p.with_leaves(values=p.values[:, :-1]), torch.float32, ValueError
    yield p, torch.float16, TypeError
    yield p.with_leaves(values=p.values.long()), torch.float32, TypeError
    yield p.with_leaves(indices=p.indices.float()), torch.float32, TypeError
    yield q.with_leaves(values=q.values.float()), torch.float32, TypeError
    yield q.with_leaves(header=None), torch.float32, ValueError
    big = PayloadMeta("sparse", d=16385, k=8)
    yield (p.with_leaves(meta=big, values=p.values[:, :8],
                         indices=p.indices[:, :8]), torch.float32,
           ValueError)


@pytest.mark.parametrize("case", range(8))
def test_decode_plan_raises(case):
    p, dtype, err = list(_bad_payloads())[case]
    with pytest.raises(err):
        _rows_plan(p, dtype)


# decode_rows_to_slots: the serving flush's decode into the arena's xbuf

def _on_card(t):
    """`decode.ops._slot_sig` of `t` as if it lay on the card."""
    if t is None:
        return None
    return t.shape, t.dtype, True, t.is_contiguous()


def _flush(kind, d, n=4, cap=6, dtype=torch.bfloat16):
    """A flush payload of n rows (leading dims (n, 1, 1)), its slot vector
    (the last row a pad row on the scratch slot cap) and the arena's xbuf
    (cap + 1, 1, 1, d)."""
    p = _payload(kind, (n, 1, 1), d)
    slots = torch.tensor(list(range(n - 1)) + [cap], dtype=torch.int32)
    xbuf = torch.zeros((cap + 1, 1, 1, d), dtype=dtype)
    return p, slots, xbuf


def _leaf_sigs(p, sig=_on_card):
    return tuple(None if t is None else sig(t)
                 for t in (p.values, p.indices, p.header))


def _slots_plan(p, slots, xbuf):
    return dec_ops.slots_plan(p.meta, _on_card(xbuf), _on_card(slots),
                              *_leaf_sigs(p))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", (70, 4096, 16384))
@pytest.mark.parametrize("kind", list(KIND_LEAVES))
def test_slots_launch_passes_signature_args(fake, kind, d, dtype):
    p, slots, xbuf = _flush(kind, d, dtype=dtype)
    plan = _slots_plan(p, slots, xbuf)
    dec_ops.launch_slots(plan, xbuf, slots, p.values, p.indices, p.header)
    (args,) = fake.decode_to_slots.calls
    _assert_signature("decode_to_slots", args)
    idx = p.indices.data_ptr() if kind in ("sparse", "sparse_quant",
                                           "mask") else 0
    hdr = p.header.data_ptr() if kind in QUANT else 0
    assert args == (xbuf.data_ptr(), int(dtype == torch.bfloat16), 7, d,
                    slots.data_ptr(), 4, KINDS.index(kind), p.meta.k,
                    p.values.data_ptr(), idx, hdr, STREAM)
    assert _lib.launch_counts()["decode_to_slots"] == 1


def test_slots_launch_skips_an_empty_flush(fake):
    p, slots, xbuf = _flush("sparse", 1000, n=1)
    p = p.with_leaves(values=p.values[:0], indices=p.indices[:0])
    plan = _slots_plan(p, slots[:0], xbuf)
    assert plan.n == 0
    dec_ops.launch_slots(plan, xbuf, slots[:0], p.values, p.indices, None)
    assert not fake.decode_to_slots.calls
    assert _lib.launch_counts()["decode_to_slots"] == 0


def test_slots_plan_is_resolved_once_per_key(fake, monkeypatch):
    """A second flush of one key is one cache hit and the launch."""
    p, slots, xbuf = _flush("sparse", 4096)
    assert _slots_plan(p, slots, xbuf) is _slots_plan(p, slots, xbuf)
    monkeypatch.setattr(dec_ops, "_slot_sig", _on_card)
    monkeypatch.setattr(_lib, "resolve_backend", lambda b, t: "cuda")
    dec_ops.decode_rows_to_slots(xbuf, p, slots)
    before = dec_ops.slots_plan.cache_info()
    assert dec_ops.decode_rows_to_slots(xbuf, p, slots) is xbuf
    after = dec_ops.slots_plan.cache_info()
    assert (after.hits, after.misses) == (before.hits + 1, before.misses)
    assert len(fake.decode_to_slots.calls) == 2


def _bad_flushes():
    p, slots, xbuf = _flush("sparse", 1000)
    q, _, _ = _flush("quant", 1000)
    off = lambda t: (t.shape, t.dtype, False, t.is_contiguous())  # noqa
    ok = _on_card
    big = PayloadMeta("sparse", d=16385, k=64)
    wide = torch.zeros((7, 16385))
    yield (p.meta, ok(xbuf), ok(slots),
           (ok(p.values), ok(p.indices[:, :, :, :-1]), None), ValueError)
    yield (p.meta, ok(xbuf), ok(slots),
           (ok(p.values[:3]), ok(p.indices), None), ValueError)
    yield (p.meta, ok(xbuf), ok(slots),
           (ok(p.values.double()), ok(p.indices), None), TypeError)
    yield (p.meta, ok(xbuf), ok(slots),
           (ok(p.values), ok(p.indices.long()), None), TypeError)
    yield (q.meta, ok(xbuf), ok(slots),
           (ok(q.values.float()), None, ok(q.header)), TypeError)
    yield (q.meta, ok(xbuf), ok(slots),
           (ok(q.values), None, ok(q.header.double())), TypeError)
    yield (q.meta, ok(xbuf), ok(slots), (ok(q.values), None, None),
           ValueError)
    yield (big, ok(wide), ok(slots),
           (ok(p.values), ok(p.indices), None), ValueError)
    yield (p.meta, ok(xbuf.half()), ok(slots), _leaf_sigs(p), TypeError)
    yield (p.meta, ok(xbuf[:, :, :, :500]), ok(slots), _leaf_sigs(p),
           ValueError)
    yield (p.meta, ok(xbuf.transpose(0, 3)), ok(slots), _leaf_sigs(p),
           ValueError)
    yield (p.meta, off(xbuf), ok(slots), _leaf_sigs(p), ValueError)
    yield (p.meta, ok(xbuf), ok(slots.long()), _leaf_sigs(p), TypeError)
    yield (p.meta, ok(xbuf), off(slots), _leaf_sigs(p), TypeError)
    yield (p.meta, ok(xbuf), ok(slots[None]), _leaf_sigs(p), TypeError)
    yield (p.meta, ok(xbuf), ok(slots),
           (off(p.values), off(p.indices), None), ValueError)


@pytest.mark.parametrize("case", range(16))
def test_slots_plan_raises(case):
    """A wrong leaf shape, dtype or count, a d above MAX_D, an xbuf or
    slot vector of the wrong dtype, shape or layout, and a tensor off the
    card."""
    meta, xbuf, slots, leaves, err = list(_bad_flushes())[case]
    with pytest.raises(err):
        dec_ops.slots_plan(meta, xbuf, slots, *leaves)


# quantize

QUANT_SHAPES = [(4, 64), (3, 5, 96), (1, 70), (2, 16384), (0, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", QUANT_SHAPES)
def test_quant_launch_passes_signature_args(fake, shape, dtype):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        shape).astype(np.float32)).to(dtype)
    plan = q_ops.quant_plan(x.shape, x.dtype, 4)
    out = q_ops.launch_quant(plan, x)
    for a, b in zip(out, q_ref.quantize(x, 4)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.is_contiguous()
    rows = int(np.prod(shape[:-1]))
    if not rows:
        assert not fake.quantize.calls
        return
    (args,) = fake.quantize.calls
    _assert_signature("quantize", args)
    assert args == (x.data_ptr(), int(dtype == torch.bfloat16), rows,
                    shape[-1], 4, *(t.data_ptr() for t in out), STREAM)
    assert _lib.launch_counts()["quantize"] == 1


def test_quant_launch_makes_a_strided_x_contiguous(fake):
    x = torch.randn(64, 6).t()
    plan = q_ops.quant_plan(x.shape, x.dtype, 8)
    q_ops.launch_quant(plan, x)
    (args,) = fake.quantize.calls
    assert args[0] != x.data_ptr() and args[2:5] == (6, 64, 8)


def test_quant_plan_is_resolved_once_per_key():
    key = (torch.Size((1024, 4096)), torch.bfloat16, 4)
    assert q_ops.quant_plan(*key) is q_ops.quant_plan(*key)


@pytest.mark.parametrize("shape, dtype, bits, err", [
    ((2, 64), torch.float32, 0, ValueError),
    ((2, 64), torch.float32, 9, ValueError),
    ((2, 64), torch.float16, 4, TypeError),
    ((2, 64), torch.int32, 4, TypeError),
    ((2, 0), torch.float32, 4, ValueError),
    ((1, 16385), torch.bfloat16, 4, ValueError),
    ((), torch.float32, 4, ValueError),
])
def test_quant_plan_raises(shape, dtype, bits, err):
    with pytest.raises(err):
        q_ops.quant_plan(torch.Size(shape), dtype, bits)


# pack_bits

PACK_CASES = [(64, 12), (4096, 4), (33, 32), (1, 1), (0, 7)]


@pytest.mark.parametrize("n, width", PACK_CASES)
def test_pack_launch_passes_signature_args(fake, n, width):
    vals = torch.arange(n, dtype=torch.int32)
    plan = enc_ops.pack_plan(n, width, torch.int32)
    out = enc_ops.launch_pack(plan, vals)
    want = enc_ref.pack_bits(vals, width)
    assert out.shape == want.shape and out.dtype == want.dtype
    if not n:
        assert not fake.pack_bits.calls
        return
    (args,) = fake.pack_bits.calls
    _assert_signature("pack_bits", args)
    assert args == (vals.data_ptr(), n, width, out.data_ptr(), STREAM)
    assert _lib.launch_counts()["pack_bits"] == 1


def test_pack_launch_makes_a_strided_stream_contiguous(fake):
    vals = torch.arange(64, dtype=torch.int32).reshape(8, 8).t()
    enc_ops.launch_pack(enc_ops.pack_plan(64, 6, torch.int32), vals)
    (args,) = fake.pack_bits.calls
    assert args[0] != vals.data_ptr() and args[1:3] == (64, 6)


def test_pack_plan_is_resolved_once_per_key():
    key = (64, 12, torch.int32)
    assert enc_ops.pack_plan(*key) is enc_ops.pack_plan(*key)


@pytest.mark.parametrize("width, dtype, err", [
    (0, torch.int32, ValueError), (33, torch.int32, ValueError),
    (8, torch.int64, TypeError), (8, torch.float32, TypeError)])
def test_pack_plan_raises(width, dtype, err):
    with pytest.raises(err):
        enc_ops.pack_plan(16, width, dtype)
