"""Port parity: the server's decode into the arena's slot rows
(`repro_torch.split.protocol.server_decode_to_slots`, whose CPU path is the
plain version of `csrc/decode_to_slots.cu`) against the JAX reference's
`protocol.server_decode_to_slots`, with `backend="pallas"` (interpret mode)
and `backend="xla"`.

Both sides decode the same frame bytes. dense, slice, sparse and mask rows
are bit-exact; the quant kinds are within 1 ulp at the largest decoded
magnitude (the reference's FMA convention, `compressors.py:153-164`).
Untouched rows keep their contents; pad rows all aimed at the scratch row
write identical zero rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as JC
from repro.core import wire as jwire
from repro.core.payload import Payload as JPayload
from repro.core.payload import PayloadMeta as JMeta
from repro.split import protocol as jprotocol
from repro_torch.core import wire
from repro_torch.core.payload import Payload, PayloadMeta, to_device
from repro_torch.kernels.decode import ref as dec_ref
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
    """`decode_rows` (the plain version of the reference's unported
    `decode_rows_kernel`) against `payload_to_dense(backend="pallas")`."""
    x = np.random.RandomState(7).randn(4, 1, 33).astype(np.float32)
    jp, tp = _both(_frame_bytes(name, kw, x), n_pad=0)
    want = np.asarray(JC.payload_to_dense(jp, backend="pallas"))
    _assert_rows(kind, want, dec_ref.decode_rows(tp).numpy())
    before = protocol.HOST_DENSIFY_COUNT.value
    host = wire.decode_frame(_frame_bytes(name, kw, x))[0].payload
    _assert_rows(kind, want, protocol.server_decode(host).numpy())
    assert protocol.HOST_DENSIFY_COUNT.value == before + 1
