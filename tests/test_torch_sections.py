"""The fused client codec's plain version (`kernels/encode/ref.py`
`encode_sections`) against the JAX reference: the same numpy rows go to
`repro.split.protocol.client_encode_device` (its sections cut to wire
bytes) and to `repro.core.wire.encode_payload`, and to the port's
`encode_sections` with the support selected in the launch (`select`) or
given as the top-k mask (`mask=`). Every packed kind, widths d in {70,
128, 1000, 4096, 4097, 16384}, k in {1, 3, 64, d}, bits in {3, 4, 8}, and
the rows a selection can trip on: ties at the kth, all zeros, -0.0 beside
+0.0, and bf16 rows with many equal magnitudes. Bytes must be equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as JC
from repro.core import wire as jwire
from repro.kernels.encode import ops as jenc
from repro.split import protocol as jprotocol
from repro_torch.core import compressors as C
from repro_torch.core.payload import KIND_LEAVES, Payload, PayloadMeta
from repro_torch.kernels.encode import ops as enc_ops
from repro_torch.kernels.encode import ref as enc_ref
from repro_torch.kernels.randtopk import ref as tk_ref
from repro_torch.split import protocol

WIDTHS = (70, 128, 1000, 4096, 4097, 16384)
ROWS = ("random", "ties", "zeros", "signed_zeros", "bf16_few")
# (compressor, wire kind, bit widths)
PACKED = (("topk", "sparse", (0,)), ("randtopk_quant", "sparse_quant",
                                     (3, 4, 8)),
          ("randtopk_mask", "mask", (0,)), ("quant", "quant", (3, 4, 8)))


def _rows(name: str, n: int, d: int, seed: int):
    """(numpy f32 rows, torch dtype) of one hostile family; bf16 rows are
    bf16-exact in f32 so both packages see the same values."""
    g = np.random.default_rng(seed)
    x = g.standard_normal((n, d)).astype(np.float32)
    if name == "ties":
        x = np.round(x * 2) / 2
    elif name == "zeros":
        x = np.zeros_like(x)
    elif name == "signed_zeros":
        x = np.where(x < 0, np.float32(-0.0), np.float32(0.0))
        x[:, ::7] = 1.0                 # a few nonzeros among the zeros
    elif name == "bf16_few":
        x = np.array([0.5, -0.5, 1.0, -1.0, 2.0],
                     np.float32)[g.integers(0, 5, (n, d))]
        x[:, ::97] = 3.0
        return x, torch.bfloat16
    return x.astype(np.float32), torch.float32


def _ks(d: int):
    return sorted({min(k, d) for k in (1, 3, 64)} | {d})


def _cases():
    """Every width with every k (quant: every bit width); sparse_quant
    walks the bit widths along its k's, so each width and each k meets
    some bit width and every bit width occurs at every d."""
    for d in WIDTHS:
        for name, kind, bits_list in PACKED:
            if kind == "quant":
                for bits in bits_list:
                    yield d, name, kind, 0, bits
                continue
            for i, k in enumerate(_ks(d)):
                yield d, name, kind, k, bits_list[i % len(bits_list)]


CASES = list(_cases())


def _reference_bytes(name, x, k, bits):
    """The reference's device wire path and its host codec, as bytes."""
    kw = {}
    if name != "quant":
        kw["k"] = k
    if bits:
        kw["bits"] = bits
    jc = JC.make_compressor(name, **kw)
    xj = jnp.asarray(x)
    jp, secs = jprotocol.client_encode_device(jc, xj)
    dev = jenc.sections_to_bytes(jp.meta, jp.batch_shape, secs)
    host = jwire.encode_payload(jprotocol.client_encode(jc, xj))
    return dev, host


@pytest.mark.parametrize("d,name,kind,k,bits", CASES,
                         ids=[f"{c[1]}-d{c[0]}-k{c[3]}-b{c[4]}"
                              for c in CASES])
def test_encode_sections_bytes_match_reference(d, name, kind, k, bits):
    n = 2 if d >= 4096 else 3
    for i, family in enumerate(ROWS):
        x, dtype = _rows(family, n, d, seed=d + k + bits + i)
        want_dev, want_host = _reference_bytes(name, x, k, bits)
        assert want_dev == want_host
        xt = torch.from_numpy(x).to(dtype)
        modes = [(False, None)]
        if kind != "quant":
            modes = [(True, None),
                     (False, tk_ref.topk_mask_threshold(xt, k)[0])]
        for select, mask in modes:
            leaves, sections = enc_ref.encode_sections(xt, kind, k, bits,
                                                       mask, select)
            meta = PayloadMeta(kind, d=d, k=k, bits=bits)
            got = enc_ops.sections_to_bytes(meta, (n,), sections)
            assert got == want_host, (family, select)
            # the leaves are the plain encode's, and the sections its pack
            p = enc_ops.encode_rows(
                xt, kind, k=k, bits=bits,
                mask=tk_ref.topk_mask_threshold(xt, k)[0] if k else None,
                backend="torch")
            for nm, leaf in zip(KIND_LEAVES[kind], leaves):
                assert torch.equal(leaf, getattr(p, nm)), (family, nm)
            for a, b in zip(sections, enc_ops.pack_payload(p)):
                assert torch.equal(a, b), family


@pytest.mark.parametrize("name,kind,bits", [(n, k, b[-1])
                                            for n, k, b in PACKED])
@pytest.mark.parametrize("lead", [(1, 1), (4,), (2, 3)])
def test_client_encode_device_cpu_path_equals_encode_sections(name, kind,
                                                              bits, lead):
    """On the CPU `client_encode_device` runs `comp.encode` and the plain
    packer; the fused codec's plain version gives the same leaves and
    sections for a serving row batch."""
    d, k = 4096, 64
    x = torch.from_numpy(_rows("ties", int(np.prod(lead)), d, 3)[0]).view(
        lead + (d,)).to(torch.bfloat16)
    kw = {} if name == "quant" else {"k": k}
    if kind in ("quant", "sparse_quant"):
        kw["bits"] = bits
    comp = C.make_compressor(name, **kw)
    p, sections = protocol.client_encode_device(comp, x)
    k = p.meta.k
    leaves, want = enc_ops.encode_sections(
        x, kind, k=k, bits=p.meta.bits, select=kind != "quant")
    assert leaves.meta == p.meta and leaves.batch_shape == lead
    for nm in KIND_LEAVES[kind]:
        assert torch.equal(getattr(leaves, nm), getattr(p, nm)), nm
    assert len(want) == len(sections)
    for a, b in zip(want, sections):
        assert a.dtype == b.dtype == torch.int32 and torch.equal(a, b)


def test_encode_sections_plain_wrapper_returns_payload():
    x = torch.randn(3, 200)
    p, sections = enc_ops.encode_sections(x, "sparse_quant", k=5, bits=4,
                                          select=True)
    assert isinstance(p, Payload)
    assert p.meta == PayloadMeta("sparse_quant", d=200, k=5, bits=4)
    assert [tuple(s.shape) for s in sections] == [(6 + 8,), (4,)]
    body = enc_ops.sections_to_bytes(p.meta, p.batch_shape, sections)
    assert len(body) == sum(enc_ops.section_nbytes(p.meta, (3,)))
