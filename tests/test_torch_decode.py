"""Port parity: the decode family against the JAX reference.

* The server's decode into the arena's slot rows
  (`repro_torch.split.protocol.server_decode_to_slots`, whose CPU path is
  the plain version of the `decode_to_slots` launcher of
  `csrc/decode_rows.cu`) against the reference's
  `protocol.server_decode_to_slots`, with `backend="pallas"` (interpret
  mode) and `backend="xla"`. Untouched rows keep their contents; pad rows
  all aimed at the scratch row write identical zero rows.
* `decode_rows` and `scatter_rows` (the plain versions of
  `csrc/decode_rows.cu`) against the reference's Pallas
  `decode_rows_kernel` and `scatter_rows_kernel` in interpret mode,
  projection epilogue and hostile leaves included.

Both sides decode the same frame bytes. dense, slice, sparse and mask rows
are bit-exact; the quant kinds are within 1 ulp at the largest decoded
magnitude (the reference's FMA convention, `compressors.py:153-164`);
projected rows within rtol 1e-5 (the product sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as JC
from repro.core import wire as jwire
from repro.core.payload import Payload as JPayload
from repro.core.payload import PayloadMeta as JMeta
from repro.kernels.decode import kernel as jdec_kernel
from repro.kernels.randtopk import kernel as jtk_kernel
from repro.split import protocol as jprotocol
from repro_torch.core import compressors as C
from repro_torch.core import wire
from repro_torch.core.payload import Payload, PayloadMeta, to_device
from repro_torch.kernels.decode import ops as dec_ops
from repro_torch.kernels.decode import ref as dec_ref
from repro_torch.kernels.randtopk import ops as tk_ops
from repro_torch.split import protocol

KINDS = [
    ("dense", "identity", {}),
    ("slice", "size_reduction", {"k": 6}),
    ("sparse", "randtopk", {"k": 6}),
    ("quant", "quant", {"bits": 4}),
    ("sparse_quant", "randtopk_quant", {"k": 6, "bits": 8}),
    ("mask", "randtopk_mask", {"k": 6}),
]
IDS = [k[0] for k in KINDS]
BACKENDS = ["pallas", "xla"]


def _frame_bytes(name, kw, x):
    """One stacked payload frame from the reference's encode half."""
    jc = JC.make_compressor(name, **kw)
    return jwire.encode_payload_frame(0, 0, jprotocol.client_encode(
        jc, jnp.asarray(x), training=False))


def _pad(p, n_pad):
    """Append `n_pad` zero rows to every leaf (the server's flush padding)."""
    def pad(a):
        return np.concatenate([a, np.zeros((n_pad,) + a.shape[1:], a.dtype)])
    return p.with_leaves(**{n: pad(np.asarray(a)) for n, a in p.wire_leaves()})


def _both(blob, n_pad):
    jp = jwire.decode_frame(blob)[0].payload
    tp = wire.decode_frame(blob)[0].payload
    return _pad(jp, n_pad), to_device(_pad(tp, n_pad), "cpu")


def _assert_rows(kind, want, got):
    if kind in ("quant", "sparse_quant"):
        atol = float(np.spacing(np.float32(np.abs(want).max())))
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind,name,kw", KINDS, ids=IDS)
def test_decode_to_slots_matches_reference(kind, name, kw, backend):
    """Three live rows into slots (4, 0, 2) plus two pad rows aimed at the
    scratch slot 5 (duplicate targets); slots 1 and 3 stay untouched."""
    n, d, cap = 3, 40, 5
    x = np.random.RandomState(5).randn(n, 1, 1, d).astype(np.float32)
    jp, tp = _both(_frame_bytes(name, kw, x), n_pad=2)
    assert tp.meta.kind == kind
    slots = np.array([4, 0, 2, cap, cap])
    base = np.full((cap + 1, 1, 1, d), 7.0, np.float32)
    want = np.asarray(jprotocol.server_decode_to_slots(
        jnp.asarray(base), jp, slots, backend=backend))
    xbuf = torch.from_numpy(base.copy())
    out = protocol.server_decode_to_slots(
        xbuf, tp, torch.from_numpy(slots.astype(np.int32)))
    assert out is xbuf                  # decoded in place
    got = xbuf.numpy()
    _assert_rows(kind, want, got)
    np.testing.assert_array_equal(got[[1, 3]], 7.0)
    np.testing.assert_array_equal(got[cap], 0.0)


@pytest.mark.parametrize("kind,name,kw", [k for k in KINDS
                                          if k[0] not in ("quant",
                                                          "sparse_quant")],
                         ids=[i for i in IDS if "quant" not in i])
def test_decode_to_slots_bf16_xbuf_matches_reference(kind, name, kw):
    """A bf16 arena (the card's activation dtype): rows are decoded in f32
    and rounded once to bf16 on the store, as the reference does."""
    n, d, cap = 2, 70, 3
    x = np.random.RandomState(6).randn(n, 1, 1, d).astype(np.float32)
    jp, tp = _both(_frame_bytes(name, kw, x), n_pad=1)
    slots = np.array([2, 0, cap])
    base = np.zeros((cap + 1, 1, 1, d), np.float32)
    want = np.asarray(jprotocol.server_decode_to_slots(
        jnp.asarray(base, jnp.bfloat16), jp, slots, dtype=jnp.bfloat16,
        backend="pallas")).astype(np.float32)
    xbuf = torch.zeros((cap + 1, 1, 1, d), dtype=torch.bfloat16)
    protocol.server_decode_to_slots(xbuf, tp,
                                    torch.tensor(slots, dtype=torch.int32))
    np.testing.assert_array_equal(xbuf.float().numpy(), want)


def test_duplicate_sparse_indices_sum_like_the_pallas_kernel():
    """A hostile sparse frame repeating an index: the kernel's plain
    version sums the duplicates, as the Pallas accumulate does."""
    d, cap = 16, 2
    vals = np.asarray([[1.5, 2.0, -0.25]], np.float32)
    idx = np.asarray([[3, 3, 9]], np.uint16)
    jp = JPayload(meta=JMeta("sparse", d=d, k=3), values=vals, indices=idx)
    want = np.asarray(jprotocol.server_decode_to_slots(
        jnp.zeros((cap + 1, d), jnp.float32), jp, np.array([1]),
        backend="pallas"))
    tp = to_device(Payload(meta=PayloadMeta("sparse", d=d, k=3),
                           values=vals, indices=idx), "cpu")
    xbuf = torch.zeros((cap + 1, d))
    protocol.server_decode_to_slots(xbuf, tp, torch.tensor([1],
                                                           dtype=torch.int32))
    np.testing.assert_array_equal(xbuf.numpy(), want)
    assert xbuf[1, 3] == 3.5


@pytest.mark.parametrize("kind,name,kw", KINDS, ids=IDS)
def test_plain_decode_rows_matches_payload_to_dense(kind, name, kw):
    """`decode_rows` (the plain version of `csrc/decode_rows.cu`) against
    `payload_to_dense(backend="pallas")`."""
    x = np.random.RandomState(7).randn(4, 1, 33).astype(np.float32)
    jp, tp = _both(_frame_bytes(name, kw, x), n_pad=0)
    want = np.asarray(JC.payload_to_dense(jp, backend="pallas"))
    _assert_rows(kind, want, dec_ref.decode_rows(tp).numpy())
    before = protocol.HOST_DENSIFY_COUNT.value
    host = wire.decode_frame(_frame_bytes(name, kw, x))[0].payload
    _assert_rows(kind, want, protocol.server_decode(host).numpy())
    assert protocol.HOST_DENSIFY_COUNT.value == before + 1


def _hostile(jp):
    """Sparse kinds: repeat the first index of each row and push one past
    d (both reach the decoder from a hostile frame); mask kind: extra set
    bits past k."""
    kind = jp.meta.kind
    if kind in ("sparse", "sparse_quant"):
        idx = np.array(jp.indices)
        idx[..., 1::3] = idx[..., :1]
        idx[..., 2] = jp.meta.d + 7
        return jp.with_leaves(indices=idx)
    if kind == "mask":
        return jp.with_leaves(indices=np.array(jp.indices) | np.uint32(0x11))
    return jp


@pytest.mark.parametrize("hostile", [False, True], ids=["clean", "hostile"])
@pytest.mark.parametrize("kind,name,kw", KINDS, ids=IDS)
def test_decode_rows_plain_matches_pallas_kernel(kind, name, kw, hostile):
    """Every kind, f32 rows, without and with the (d, P) projection
    epilogue: dense, slice, sparse and mask rows exact, quant within 1 ulp;
    projected rows within rtol 1e-5 (the product sums in another order).
    Hostile leaves: duplicate indices sum, indices past d are dropped, mask
    bits past k expand to zero, as in the Pallas kernel."""
    x = np.random.RandomState(11).randn(5, 1, 37).astype(np.float32)
    jp, tp = _both(_frame_bytes(name, kw, x), n_pad=0)
    if hostile:
        jp = _hostile(jp)
        tp = to_device(jp, "cpu")
    leaves = tuple(jnp.asarray(getattr(jp, n))
                   for n in jdec_kernel.KIND_LEAVES[kind])
    want = np.asarray(jdec_kernel.decode_rows_kernel(leaves, kind, 37,
                                                     interpret=True))
    got = dec_ops.decode_rows(tp)
    assert got.dtype == torch.float32 and got.shape == (5, 1, 37)
    _assert_rows(kind, want, got.numpy())
    w = np.random.RandomState(12).randn(37, 9).astype(np.float32)
    want_p = np.asarray(jdec_kernel.decode_rows_kernel(
        leaves, kind, 37, jnp.asarray(w), interpret=True))
    got_p = dec_ops.decode_rows(tp, project=torch.from_numpy(w))
    assert got_p.shape == (5, 1, 9)
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind,name,kw", [k for k in KINDS
                                          if "quant" not in k[0]],
                         ids=[i for i in IDS if "quant" not in i])
def test_decode_rows_bf16_rows_match_pallas_kernel(kind, name, kw):
    """bf16 output (the training path's activation dtype): decoded in f32,
    rounded once, exactly as the Pallas kernel's store."""
    x = np.random.RandomState(13).randn(3, 2, 40).astype(np.float32)
    jp, tp = _both(_frame_bytes(name, kw, x), n_pad=0)
    leaves = tuple(jnp.asarray(getattr(jp, n))
                   for n in jdec_kernel.KIND_LEAVES[kind])
    want = np.asarray(jdec_kernel.decode_rows_kernel(
        leaves, kind, 40, dtype="bfloat16", interpret=True)).astype(
            np.float32)
    got = dec_ops.decode_rows(tp, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("kind,name,kw", KINDS, ids=IDS)
def test_payload_to_dense_with_projection_matches_reference(kind, name, kw):
    """The plain path of `payload_to_dense(project=)` against the
    reference's XLA path (the rows are projected in `dtype`)."""
    x = np.random.RandomState(14).randn(4, 30).astype(np.float32)
    jp, tp = _both(_frame_bytes(name, kw, x), n_pad=0)
    w = np.random.RandomState(15).randn(30, 6).astype(np.float32)
    want = np.asarray(JC.payload_to_dense(jp, backend="xla",
                                          project=jnp.asarray(w)))
    got = C.payload_to_dense(tp, project=torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k,d", [((4,), 8, 50), ((2, 3), 1, 17),
                                       ((3,), 40, 40)])
def test_scatter_rows_plain_matches_pallas_kernel(shape, k, d, dtype):
    """Values in f32 or bf16, output in the values' dtype; duplicates sum
    in f32 (values are multiples of 1/8, so every order of the sum is
    exact) — exactly the Pallas kernel's rows."""
    rng = np.random.RandomState(k + d)
    vals = (np.round(rng.randn(*shape, k) * 8) / 8).astype(np.float32)
    idx = rng.randint(0, d, (*shape, k)).astype(np.uint16)
    jv = jnp.asarray(vals, dtype)
    want = np.asarray(jtk_kernel.scatter_rows_kernel(
        jv, jnp.asarray(idx), d, interpret=True)).astype(np.float32)
    tv = torch.from_numpy(vals).to(getattr(torch, dtype))
    got = tk_ops.scatter_rows(tv, torch.from_numpy(idx.astype(np.int32)), d)
    assert got.dtype == tv.dtype and got.shape == (*shape, d)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("kind,name,kw", [k for k in KINDS
                                          if k[0].startswith("sparse")],
                         ids=["sparse", "sparse_quant"])
def test_payload_to_dense_hostile_sparse_matches_pallas_kernel(kind, name,
                                                               kw):
    """The CPU path of `payload_to_dense` on a hostile sparse frame decodes
    as the card's kernel does (the Pallas `decode_rows_kernel`): duplicate
    indices sum, indices past d are dropped."""
    x = np.random.RandomState(16).randn(4, 1, 29).astype(np.float32)
    jp, _ = _both(_frame_bytes(name, kw, x), n_pad=0)
    jp = _hostile(jp)
    leaves = tuple(jnp.asarray(getattr(jp, n))
                   for n in jdec_kernel.KIND_LEAVES[kind])
    want = np.asarray(jdec_kernel.decode_rows_kernel(leaves, kind, 29,
                                                     interpret=True))
    _assert_rows(kind, want, C.payload_to_dense(to_device(jp, "cpu")).numpy())
