"""The host side of the fused client codec and of the top-k wrapper, on
the CPU with a fake library in place of the built kernels: the fused
launch (`encode_sections`) gets the pointers and scalars its C signature
(`_lib.SIGNATURES`) declares; its leaves and sections have the plain
version's shapes and dtypes and lie apart, except where a leaf is meant
to be a view of a section; `client_encode_device` on a path that resolves
to the kernels makes one launch per served token and two per training
randtopk encode; and the top-k plan raises where the kernel cannot take
an input."""
import ctypes

import pytest
import torch

from repro_torch.core import compressors as C
from repro_torch.core.payload import KIND_LEAVES, KINDS
from repro_torch.kernels import _lib
from repro_torch.kernels.encode import ops as enc_ops
from repro_torch.kernels.encode import ref as enc_ref
from repro_torch.kernels.randtopk import ops as tk_ops
from repro_torch.kernels.randtopk import ref as tk_ref
from repro_torch.split import protocol

STREAM = 0xBEEF
KINDS_KB = [("dense", 0, 0), ("slice", 64, 0), ("sparse", 64, 0),
            ("quant", 0, 4), ("sparse_quant", 64, 8), ("mask", 64, 0)]
# a leaf that is a prefix of a section, by kind: (leaf, section index)
VIEWS = {"dense": ("values", 0), "slice": ("values", 0),
         "sparse": ("values", 0), "quant": ("header", 0),
         "sparse_quant": ("header", 0), "mask": ("values", 0)}


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
    lib = _FakeLib()
    monkeypatch.setattr(_lib, "_LIB", None)
    monkeypatch.setattr(_lib, "_FNS", {})
    monkeypatch.setattr(_lib, "_load", lambda: lib)
    monkeypatch.setattr(_lib, "stream_handle", lambda t: STREAM)
    _lib.reset_launch_counts()
    yield lib
    _lib.reset_launch_counts()


@pytest.fixture
def on_card(fake, monkeypatch):
    """Every wrapper resolves to its kernel (the fake library), CPU tensors
    and all, as they would for CUDA tensors."""
    def cuda(backend, t):
        return "cuda" if (backend or "auto") != "torch" else "torch"

    monkeypatch.setattr(_lib, "resolve_backend", cuda)
    monkeypatch.setattr(protocol, "resolve_backend", cuda)
    return fake


def _assert_signature(name, args):
    types = _lib.SIGNATURES[name]
    assert len(args) == len(types)
    for a, t in zip(args, types):
        assert isinstance(a, int), (name, args)
        if t is ctypes.c_int:
            assert -2 ** 31 <= a < 2 ** 31 and t(a).value == a
        else:
            assert t is ctypes.c_void_p and 0 <= a < 2 ** 64
            assert (t(a).value or 0) == a


def _span(t):
    return t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()


def _launch(kind, k, bits, select, lead=(3,), d=1000,
            dtype=torch.float32):
    x = torch.randn(lead + (d,)).to(dtype)
    mask = (tk_ref.topk_mask_threshold(x, k)[0]
            if kind in enc_ops.MASK_KINDS and not select else None)
    plan = enc_ops.sections_plan(kind, x.shape, x.dtype, k, bits, select)
    p, sections = enc_ops.launch_sections(plan, x, mask)
    return x, mask, plan, p, sections


@pytest.mark.parametrize("kind,k,bits,select", [
    c + (s,) for c in KINDS_KB for s in (False, True)
    if not s or c[0] in enc_ops.MASK_KINDS])
def test_fused_launch_passes_signature_args(fake, kind, k, bits, select):
    x, mask, plan, p, sections = _launch(kind, k, bits, select,
                                         dtype=torch.bfloat16)
    (args,) = fake.encode_sections.calls
    _assert_signature("encode_sections", args)
    assert args[:9] == (x.data_ptr(), 1,
                        0 if mask is None else mask.data_ptr(), 3, 1000,
                        KINDS.index(kind), p.meta.k, p.meta.bits,
                        int(select))
    assert args[-1] == STREAM
    out0, out1, out2, idx_w, code_w = args[9:14]
    names = KIND_LEAVES[kind]
    assert out0 == getattr(p, names[0]).data_ptr()
    assert out1 == (getattr(p, names[1]).data_ptr() if len(names) > 1
                    else 0)
    assert out2 == (p.header.data_ptr() if kind == "sparse_quant" else 0)
    # the packed streams start right after the words that precede them
    n, kk = 3, p.meta.k
    if kind == "sparse":
        assert idx_w == sections[0].data_ptr() + 4 * n * kk
    elif kind == "sparse_quant":
        assert idx_w == sections[0].data_ptr() + 8 * n
        assert code_w == sections[1].data_ptr()
    elif kind == "quant":
        assert code_w == sections[0].data_ptr() + 8 * n
    else:
        assert idx_w == code_w == 0
    assert (idx_w != 0) == (kind in ("sparse", "sparse_quant"))
    for sec, nb in zip(sections, enc_ops.section_nbytes(p.meta, (n,))):
        assert sec.numel() * 4 >= nb
    assert _lib.launch_counts()["encode_sections"] == 1
    assert not fake.topk_mask_threshold.calls and not fake.pack_bits.calls


@pytest.mark.parametrize("lead", [(1, 1), (4,), (2, 3)])
@pytest.mark.parametrize("kind,k,bits", KINDS_KB)
def test_fused_outputs_match_plain_layout(fake, kind, k, bits, lead):
    select = kind in enc_ops.MASK_KINDS
    x, mask, plan, p, sections = _launch(kind, k, bits, select, lead=lead,
                                         d=4096)
    leaves, want = enc_ref.encode_sections(x, kind, k, bits, mask, select)
    assert p.batch_shape == lead
    for name, b in zip(KIND_LEAVES[kind], leaves):
        a = getattr(p, name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert a.is_contiguous() and a.data_ptr() % 16 == 0
    assert len(sections) == len(want)
    for a, b in zip(sections, want):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.int32
        assert a.is_contiguous()
    # leaves and sections lie apart, but for the leaf that is a prefix of
    # a section: that one starts where the section starts
    view_name, view_sec = VIEWS[kind]
    spans = []
    for name in KIND_LEAVES[kind]:
        leaf = getattr(p, name)
        if name == view_name:
            assert leaf.data_ptr() == sections[view_sec].data_ptr()
            assert _span(leaf)[1] <= _span(sections[view_sec])[1]
            continue
        if kind == "mask" and name == "indices":
            assert leaf.data_ptr() == sections[1].data_ptr()
            continue
        spans.append(_span(leaf))
    spans += [_span(s) for s in sections]
    spans.sort()
    assert all(e <= s for (_, e), (s, _) in zip(spans, spans[1:]))


def test_fused_plan_is_resolved_once_per_key(fake):
    key = ("sparse", torch.Size((1, 1, 4096)), torch.bfloat16, 64, 0, True)
    assert enc_ops.sections_plan(*key) is enc_ops.sections_plan(*key)


@pytest.mark.parametrize("kind,k,bits,select,err", [
    ("quant", 0, 4, True, ValueError),
    ("dense", 0, 0, True, ValueError),
    ("sparse", 0, 0, True, ValueError),
    ("sparse_quant", 8, 9, False, ValueError),
    ("mask", 65, 0, True, ValueError),
])
def test_fused_plan_raises(kind, k, bits, select, err):
    with pytest.raises(err):
        enc_ops.sections_plan(kind, torch.Size((2, 64)), torch.float32, k,
                              bits, select)


def test_fused_launch_needs_the_mask_when_not_selecting(on_card):
    x = torch.randn(2, 64)
    with pytest.raises(ValueError, match="mask"):
        enc_ops.encode_sections(x, "sparse", k=8)
    with pytest.raises(ValueError, match="mask"):
        enc_ops.encode_sections(x, "mask", k=8, mask=torch.ones(2, 32))
    assert not on_card.encode_sections.calls


SERVING = [("topk", {"k": 64}), ("randtopk", {"k": 64}),
           ("randtopk_mask", {"k": 64}), ("randtopk_quant",
                                          {"k": 64, "bits": 8}),
           ("quant", {"bits": 4}), ("identity", {}),
           ("size_reduction", {"k": 64})]


@pytest.mark.parametrize("name,kw", SERVING, ids=[s[0] for s in SERVING])
def test_served_token_is_one_launch(on_card, name, kw):
    comp = C.make_compressor(name, **kw)
    x = torch.randn(1, 1, 4096).to(torch.bfloat16)
    p, sections = protocol.client_encode_device(comp, x)
    counts = {n: c for n, c in _lib.launch_counts().items() if c}
    assert counts == {"encode_sections": 1}
    (args,) = on_card.encode_sections.calls
    assert args[8] == int(comp.wire_kind in enc_ops.MASK_KINDS)  # select
    assert args[2] == 0                                      # no mask in
    assert p.meta.kind == comp.wire_kind and p.batch_shape == (1, 1)


@pytest.mark.parametrize("name", ["randtopk", "randtopk_mask",
                                  "randtopk_quant"])
def test_training_randtopk_encode_is_two_launches(on_card, name):
    """In training the Eq. (7) mask is drawn first by its own kernel and
    handed to the fused encode; a plain top-k compressor still selects in
    the encode launch."""
    comp = C.make_compressor(name, k=3)
    x = torch.randn(128, 128)
    g = torch.Generator().manual_seed(0)
    protocol.client_encode_device(comp, x, generator=g, training=True)
    counts = {n: c for n, c in _lib.launch_counts().items() if c}
    assert counts == {"randtopk_mask": 1, "encode_sections": 1}
    (m_args,) = on_card.randtopk_mask.calls
    (args,) = on_card.encode_sections.calls
    assert args[8] == 0 and args[2] == m_args[7]    # the drawn mask goes in
    _lib.reset_launch_counts()
    protocol.client_encode_device(C.make_compressor("topk", k=3), x,
                                  generator=g, training=True)
    assert {n: c for n, c in _lib.launch_counts().items() if c} == \
        {"encode_sections": 1}


def test_plain_dense_compressor_launches_nothing(on_card):
    """L1's dense transport is `comp.encode` and the plain packer: no
    kernel launch."""
    comp = C.make_compressor("l1")
    protocol.client_encode_device(comp, torch.randn(1, 1, 64))
    assert not any(_lib.launch_counts().values())


def test_topk_launch_passes_signature_args(fake, monkeypatch):
    monkeypatch.setattr(_lib, "resolve_backend", lambda b, t: "cuda")
    x = torch.randn(2, 3, 1000).to(torch.bfloat16)
    mask, thr = tk_ops.topk_mask_threshold(x, 7)
    assert mask.shape == x.shape and mask.dtype == torch.bool
    assert thr.shape == (2, 3) and thr.dtype == torch.float32
    (args,) = fake.topk_mask_threshold.calls
    _assert_signature("topk_mask_threshold", args)
    assert args == (x.data_ptr(), 1, 6, 1000, 7, mask.data_ptr(),
                    thr.data_ptr(), STREAM)


def test_topk_plan_is_resolved_once_per_key():
    key = (torch.Size((1, 4096)), torch.bfloat16, 64)
    assert tk_ops.topk_plan(*key) is tk_ops.topk_plan(*key)
    assert tk_ops.topk_plan(*key) == (1, 4096, 1)


@pytest.mark.parametrize("shape,dtype,k,err", [
    ((2, 64), torch.float16, 8, TypeError),
    ((2, 64), torch.int32, 8, TypeError),
    ((1, 16385), torch.float32, 8, ValueError),
    ((2, 64), torch.float32, 0, ValueError),
    ((2, 64), torch.float32, 65, ValueError),
])
def test_topk_plan_raises(shape, dtype, k, err):
    with pytest.raises(err):
        tk_ops.topk_plan(torch.Size(shape), dtype, k)
