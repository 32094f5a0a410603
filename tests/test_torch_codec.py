"""Port parity: the codec — compressors, the encode family's plain versions,
the device wire path and `repro_torch.core.wire` — against the JAX
reference, on numpy inputs made from a seed.

Non-quant leaves, packed words and frame bytes are exact; the quant kinds'
codes are exact and their (lo, step) headers within 1 ulp (the reference's
FMA convention). Frames must be byte-identical to `repro.core.wire` and to
the committed `tests/golden/*.bin`.
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as JC
from repro.core import wire as jwire
from repro.core.payload import Payload as JPayload
from repro.core.payload import PayloadMeta as JMeta
from repro.kernels.encode import ops as jenc
from repro.split import protocol as jprotocol
from repro_torch.core import compressors as C
from repro_torch.core import wire
from repro_torch.core.payload import Payload, PayloadMeta, to_device, to_host
from repro_torch.kernels.encode import ops as enc_ops
from repro_torch.kernels.encode import ref as enc_ref
from repro_torch.split import protocol

GOLDEN_DIR = pathlib.Path(__file__).resolve().parent / "golden"

SPECS = [
    ("dense", "identity", {}),
    ("slice", "size_reduction", {"k": 6}),
    ("sparse", "topk", {"k": 6}),
    ("sparse", "randtopk", {"k": 6}),
    ("quant", "quant", {"bits": 4}),
    ("sparse_quant", "randtopk_quant", {"k": 6, "bits": 8}),
    ("mask", "randtopk_mask", {"k": 6}),
    ("dense", "l1", {"tol": 0.5}),
]
SPEC_IDS = [s[1] for s in SPECS]


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _assert_leaves(kind, want: JPayload, got: Payload):
    """`got` (port, host dtypes) against `want` (reference, numpy)."""
    for name in ("values", "indices", "header"):
        a, b = getattr(want, name), getattr(got, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name == "header":
            spacing = np.spacing(np.abs(a).astype(np.float32))
            assert (np.abs(a - b) <= spacing).all(), name
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{kind} {name}")


@pytest.mark.parametrize("kind,name,kw", SPECS, ids=SPEC_IDS)
@pytest.mark.parametrize("shape", [(5, 1, 32), (3, 70)])
def test_compressor_encode_matches_reference(kind, name, kw, shape):
    x = _x(shape)
    jc, tc = JC.make_compressor(name, **kw), C.make_compressor(name, **kw)
    assert tc.wire_kind == jc.wire_kind == kind
    want = jax.tree.map(np.asarray, jc.encode(jnp.asarray(x),
                                              training=False))
    got = to_host(tc.encode(torch.from_numpy(x), training=False))
    assert got.meta == PayloadMeta(**want.meta.__dict__)
    _assert_leaves(kind, want, got)
    assert tc.fwd_bits(shape[-1]) == jc.fwd_bits(shape[-1])
    assert tc.bwd_bits(shape[-1]) == jc.bwd_bits(shape[-1])


@pytest.mark.parametrize("kind,name,kw", SPECS[:-1], ids=SPEC_IDS[:-1])
def test_encode_rows_plain_matches_pallas_kernel(kind, name, kw):
    """The encode kernel's plain version vs the reference's Pallas kernel
    (interpret mode), odd widths included."""
    for shape, seed in (((4, 32), 0), ((3, 1, 70), 1)):
        x = _x(shape, seed)
        d = shape[-1]
        k = min(kw.get("k", 0), d)
        bits = kw.get("bits", 0)
        jmask = (jax.numpy.asarray(np.asarray(
            JC.make_compressor(name, **kw)._mask(jnp.asarray(x), None,
                                                 False)))
            if kind in ("sparse", "sparse_quant", "mask") else None)
        want = jax.tree.map(np.asarray, jenc.encode_rows(
            jnp.asarray(x), kind, k=k, bits=bits, mask=jmask,
            interpret=True))
        tmask = None if jmask is None else torch.from_numpy(
            np.asarray(jmask))
        got = to_host(enc_ops.encode_rows(torch.from_numpy(x), kind, k=k,
                                          bits=bits, mask=tmask))
        assert got.meta == PayloadMeta(**want.meta.__dict__)
        _assert_leaves(kind, want, got)


@pytest.mark.parametrize("width", range(1, 33))
def test_pack_bits_matches_host_packer(width):
    rng = np.random.RandomState(width)
    for n in (1, 31, 64, 100):
        vals = rng.randint(0, 2 ** min(width, 31), n).astype(np.int64)
        if width == 32:
            vals |= rng.randint(0, 2, n).astype(np.int64) << 31
        want = jwire._pack_bits(vals.astype(np.uint32), width)
        got = enc_ref.pack_bits(torch.from_numpy(
            vals.astype(np.uint32).view(np.int32)), width)
        assert got.numel() == (n + 31) // 32 * width
        assert got.numpy().tobytes()[:len(want)] == want
        assert wire._pack_bits(vals.astype(np.uint32), width) == want


@pytest.mark.parametrize("kind,name,kw", SPECS, ids=SPEC_IDS)
def test_device_wire_path_frames_match_reference(kind, name, kw):
    """`client_encode_device` sections -> bytes -> frame, byte-identical to
    the reference's host codec frame of the same activation."""
    x = _x((1, 1, 70), 5)
    jc, tc = JC.make_compressor(name, **kw), C.make_compressor(name, **kw)
    jp = jprotocol.client_encode(jc, jnp.asarray(x))
    want = jwire.encode_payload_frame(3, 9, jp)
    p, sections = protocol.client_encode_device(tc, torch.from_numpy(x))
    body = enc_ops.sections_to_bytes(p.meta, p.batch_shape, sections)
    got = wire.encode_payload_frame_from_bytes(3, 9, p.meta, p.batch_shape,
                                               body)
    assert got == want
    assert wire.encode_payload_frame(3, 9, to_host(p)) == want


@pytest.mark.parametrize("kind,name,kw", SPECS, ids=SPEC_IDS)
def test_frame_round_trip_and_dense_view(kind, name, kw):
    x = _x((2, 3, 40), 7)
    tc = C.make_compressor(name, **kw)
    host = protocol.client_encode(tc, torch.from_numpy(x))
    frame, used = wire.decode_frame(wire.encode_payload_frame(1, 2, host))
    assert frame.payload.meta == host.meta and used == frame.nbytes
    jframe, _ = jwire.decode_frame(wire.encode_payload_frame(1, 2, host))
    want = np.asarray(JC.payload_to_dense(jframe.payload, backend="xla"))
    got = protocol.server_decode(frame.payload).numpy()
    if kind in ("quant", "sparse_quant"):
        spacing = np.spacing(np.abs(want).max().astype(np.float32))
        np.testing.assert_allclose(got, want, rtol=0, atol=spacing)
    else:
        np.testing.assert_array_equal(got, want)
    dev = to_device(frame.payload, "cpu")
    assert all(a.dtype in (torch.float32, torch.int32)
               for _, a in dev.wire_leaves())


def _golden_payloads():
    """The fixed payloads of tests/test_golden.py, as port Payloads."""
    return {
        "dense": Payload(PayloadMeta("dense", d=8),
                         np.arange(16, dtype=np.float32).reshape(2, 8) / 4),
        "slice": Payload(PayloadMeta("slice", d=8, k=3),
                         np.asarray([[1.0, -2.0, 0.5]], np.float32)),
        "sparse": Payload(PayloadMeta("sparse", d=16, k=2),
                          np.asarray([[1.5, -2.0]], np.float32),
                          indices=np.asarray([[3, 9]], np.uint16)),
        "quant": Payload(PayloadMeta("quant", d=8, bits=4),
                         np.tile(np.arange(8, dtype=np.uint8), (2, 1)),
                         header=np.asarray([[-1.0, 0.125], [0.0, 0.25]],
                                           np.float32)),
        "sparse_quant": Payload(
            PayloadMeta("sparse_quant", d=16, k=3, bits=8),
            np.asarray([[0, 128, 255]], np.uint8),
            indices=np.asarray([[1, 8, 15]], np.uint16),
            header=np.asarray([[-2.0, 0.015625]], np.float32)),
        "mask": Payload(PayloadMeta("mask", d=40, k=3),
                        np.asarray([[1.0, -0.5, 2.25]], np.float32),
                        indices=np.asarray([[1 << 1, (1 << 1) | (1 << 6)]],
                                           np.uint32)),
    }


def _golden_frames():
    p = _golden_payloads()
    frames = {f"payload_{k}": wire.encode_payload_frame(7, 3, v)
              for k, v in p.items()}
    frames["grad_slice"] = wire.encode_grad_frame(7, 3, p["slice"], loss=2.5)
    frames["grad_dense"] = wire.encode_grad_frame(7, 3, p["dense"],
                                                  loss=0.25)
    frames["tokens"] = wire.encode_token_frame(7, 4, [42, 7, 123456])
    frames["close"] = wire.encode_close_frame(7, 5)
    frames["error"] = wire.encode_error_frame(
        7, 6, wire.ERR_BAD_COUNT, "sparse payload k=99 out of range for d=16")
    return frames


def test_goldens_are_all_covered():
    assert sorted(_golden_frames()) == sorted(
        f.stem for f in GOLDEN_DIR.glob("*.bin"))
    assert len(_golden_frames()) == 11


@pytest.mark.parametrize("name", sorted(_golden_frames()))
def test_golden_frames_byte_identical(name):
    golden = (GOLDEN_DIR / f"{name}.bin").read_bytes()
    assert _golden_frames()[name] == golden
    frame, used = wire.decode_frame(golden)
    assert used == len(golden) == frame.nbytes


def test_golden_payloads_from_device_dtypes():
    """Device-dtype leaves (int32 codes/indices/words) serialize to the same
    golden bytes as the wire dtypes."""
    for kind, p in _golden_payloads().items():
        dev = to_device(p, "cpu")
        golden = (GOLDEN_DIR / f"payload_{kind}.bin").read_bytes()
        assert wire.encode_payload_frame(7, 3, dev) == golden, kind
        back = to_host(dev)
        for (_, a), (_, b) in zip(p.wire_leaves(), back.wire_leaves()):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_wire_error_taxonomy_matches_reference():
    blob = bytearray((GOLDEN_DIR / "payload_sparse.bin").read_bytes())
    blob[-6] ^= 0x10
    with pytest.raises(wire.ChecksumError):
        wire.decode_frame(bytes(blob))
    with pytest.raises(jwire.ChecksumError):
        jwire.decode_frame(bytes(blob))
    reader = wire.FrameReader()
    good = (GOLDEN_DIR / "tokens.bin").read_bytes()
    for i in range(len(good)):
        reader.feed(good[i:i + 1])
    assert [f.tokens.tolist() for f in reader.frames()] == [[42, 7, 123456]]
    assert issubclass(wire.WireError, ValueError)
    for a, b in ((wire.TruncatedFrame, jwire.TruncatedFrame),
                 (wire.UnknownKind, jwire.UnknownKind),
                 (wire.BadCount, jwire.BadCount),
                 (wire.VersionMismatch, jwire.VersionMismatch)):
        assert a.__name__ == b.__name__ and wire.error_code(a()) == \
            jwire.error_code(b())


def test_section_nbytes_sum_to_expected():
    for kind, p in _golden_payloads().items():
        assert sum(enc_ops.section_nbytes(p.meta, p.batch_shape)) == \
            wire.payload_expected_nbytes(p.meta, p.batch_shape) == \
            jwire.payload_expected_nbytes(JMeta(**p.meta.__dict__),
                                          p.batch_shape), kind


def test_ste_is_identity_in_backward():
    x = torch.randn(3, 16, requires_grad=True)
    y, _ = C.make_compressor("quant", bits=2).forward(x)
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_port_never_imports_jax_or_reference():
    """AST scan: no module of src/repro_torch, and not chip_smoke.py,
    imports jax or anything of the `repro` package."""
    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), \
                    f"{path.relative_to(root)} imports {n}"
