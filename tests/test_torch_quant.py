"""Port parity: the fused quantize kernel's plain version
(`repro_torch.kernels.quant`) against the reference's Pallas kernel (in
interpret mode) and its plain version (`repro.kernels.quant.ref`), on the
CPU, at the reference's kernel-test shapes for bits 2, 4 and 8 in f32 and
bf16. Inputs come from numpy with a seed and cross as data.

Tolerances: codes, lo and step exact; dequantized values within one f32
ulp at the largest term of `lo + (code + 0.5) * step`, and for bf16 one
bf16 ulp of the value: the reference's kernel may fuse that sum into one
FMA while the port rounds the product and the sum on their own, and under
cancellation the product's rounding moves a small result by more than
its own ulp."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant import kernel as jkernel, ref as jref
from repro_torch.kernels.quant import ops, ref

SHAPES = [(4, 64), (17, 128), (128, 256), (3, 5, 96), (1, 8192)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ulp(a: np.ndarray, bf16: bool) -> np.ndarray:
    """One ulp at each magnitude of `a` (f32 numbers) in f32 or bf16."""
    if not bf16:
        return np.spacing(np.abs(a).astype(np.float32))
    _, e = np.frexp(np.abs(a))
    return np.ldexp(1.0, e - 8).astype(np.float32)


def _check(want, got, bf16: bool):
    wc, wdeq, wlo, wstep = (np.asarray(a, dtype=np.float32)
                            if i else np.asarray(a)
                            for i, a in enumerate(want))
    gc, gdeq, glo, gstep = got
    assert gc.dtype == torch.uint8
    np.testing.assert_array_equal(gc.numpy(), wc)
    np.testing.assert_array_equal(glo.numpy(), wlo.reshape(glo.shape))
    np.testing.assert_array_equal(gstep.numpy(), wstep.reshape(gstep.shape))
    g = gdeq.float().numpy()
    lo = wlo.reshape(wlo.shape + (1,))
    prod = (wc.astype(np.float32) + 0.5) * wstep.reshape(lo.shape)
    terms = np.maximum(np.maximum(np.abs(lo), np.abs(prod)), np.abs(wdeq))
    tol = _ulp(terms, False)
    if bf16:
        tol = np.maximum(tol, _ulp(np.abs(wdeq), True))
    assert (np.abs(g - wdeq) <= tol).all(), np.abs(g - wdeq).max()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_matches_reference_kernel_and_ref(shape, bits, dtype):
    jdt, tdt = DTYPES[dtype]
    x = _x(shape)
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(x).to(tdt)
    got = ops.quantize(tx, bits)
    assert got[1].dtype == tdt
    assert got[2].shape == shape[:-1] and got[3].dtype == torch.float32
    _check(jkernel.quantize(jx, bits), got, dtype == "bf16")
    _check(jref.quantize(jx, bits), got, dtype == "bf16")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_constant_rows_give_unit_step_and_no_nan(dtype):
    jdt, tdt = DTYPES[dtype]
    x = np.ones((4, 32), np.float32)
    x[1] = -3.5
    code, deq, lo, step = ops.quantize(torch.from_numpy(x).to(tdt), 4)
    assert not torch.isnan(deq).any()
    assert (step == 1.0).all() and (code == 0).all()
    _check(jkernel.quantize(jnp.asarray(x, jdt), 4),
           (code, deq, lo, step), dtype == "bf16")


def _signed_zero_rows(case):
    """Rows whose least value is a zero, with -0.0 in places; `listed`
    holds a row with -0.0 after +0.0, one of zeros only with -0.0 last,
    one with -0.0 first, an all-(+0.0) row, an all-(-0.0) row and one
    with a negative min; `wide` is 96-wide rows of non-negative values
    with zeros of both signs scattered in."""
    if case == "listed":
        return np.array([[0.0, -0.0, 1.0, 2.0], [0.0, 0.0, -0.0, -0.0],
                         [-0.0, 0.0, 1.0, 2.0], [0.0, 0.0, 0.0, 0.0],
                         [-0.0, -0.0, -0.0, -0.0], [0.0, -0.0, -1.0, 2.0]],
                        np.float32)
    g = np.random.RandomState(7)
    x = np.abs(g.randn(6, 96)).astype(np.float32)
    for r in range(6):
        at = g.choice(96, size=1 + r, replace=False)
        x[r, at] = 0.0
        x[r, at[r % len(at):]] *= -1.0          # some of them -0.0
    x[0, :] = 0.0
    x[0, 95] = -0.0
    return x


def _u32(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("case", ["listed", "wide"])
def test_quantize_signed_zero_lo_matches_reference_bits(case, bits, dtype):
    """XLA's min orders -0.0 below +0.0, so a row whose min is a zero and
    that holds a -0.0 reports lo = -0.0: `ref.quantize` and `ops.quantize`
    (CPU) give the reference kernel's lo and step bit for bit, and its
    codes."""
    jdt, tdt = DTYPES[dtype]
    x = _signed_zero_rows(case)
    want = jkernel.quantize(jnp.asarray(x, jdt), bits)
    tx = torch.from_numpy(x).to(tdt)
    for got in (ref.quantize(tx, bits), ops.quantize(tx, bits)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(_u32(got[2].numpy()), _u32(want[2]))
        np.testing.assert_array_equal(_u32(got[3].numpy()), _u32(want[3]))
        _check(want, got, dtype == "bf16")
    assert _u32(want[2])[0] == 0x80000000        # the listed rows' first


def test_quantize_dequantize_is_the_deq_output():
    x = torch.from_numpy(_x((6, 40), seed=3))
    np.testing.assert_array_equal(ops.quantize_dequantize(x, 4).numpy(),
                                  ref.quantize(x, 4)[1].numpy())


def test_quantize_checks_bits_and_backend():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="bits"):
        ops.quantize(x, 9)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.quantize(x, 4, backend="cuda")
