"""Port parity: `repro_torch.core.selection` and the randtopk family's plain
versions against the JAX reference, on numpy inputs made from a seed.

Masks are exact (the XLA tie rule included); the randomized Eq. (7) mask is
exact when both sides get the same Gumbel noise and pick counts as data.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import selection as jsel
from repro.kernels.randtopk import kernel as jkernel
from repro_torch.core import selection
from repro_torch.kernels.randtopk import ops as tk_ops
from repro_torch.kernels.randtopk import ref as tk_ref

ADVERSARIAL = [
    ("ties", np.tile(np.array([[3.0, 1.0, 1.0, 1.0, 1.0, 2.0, 2.0, 0.5]],
                              np.float32), (3, 1)), 4),
    ("all_equal", np.full((4, 32), 1.5, np.float32), 5),
    ("zeros", np.zeros((4, 32), np.float32), 6),
    ("negatives", -np.abs(np.random.RandomState(8).randn(5, 64)).astype(
        np.float32), 7),
    ("mixed_sign_ties", np.array([[-2.0, 2.0, -2.0, 1.0, -1.0, 0.0]],
                                 np.float32), 3),
    ("k_equals_d", np.random.RandomState(9).randn(3, 16).astype(np.float32),
     16),
    ("single_spike", (np.eye(8, 128) * 100.0).astype(np.float32), 2),
    ("signed_zeros", np.array([[0.0, -0.0, 0.0, -0.0, 1.0]], np.float32), 3),
]


@pytest.mark.parametrize("shape,k", [((6, 256), 16), ((3, 1, 70), 1),
                                     ((2, 1000), 999), ((1, 4096), 64)])
def test_topk_mask_matches_xla(shape, k):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(jsel.topk_mask(jnp.asarray(x), k, backend="xla"))
    got = selection.topk_mask(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.sum(-1) == k).all()


@pytest.mark.parametrize("name,x,k", ADVERSARIAL,
                         ids=[a[0] for a in ADVERSARIAL])
def test_topk_mask_adversarial_tie_rule(name, x, k):
    want = np.asarray(jsel.topk_mask(jnp.asarray(x), k, backend="xla"))
    got = selection.topk_mask(torch.from_numpy(x), k, backend="torch")
    np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_topk_threshold_is_the_kth_magnitude():
    x = np.random.RandomState(1).randn(7, 300).astype(np.float32)
    mask, thr = tk_ops.topk_mask_threshold(torch.from_numpy(x), 20)
    want = np.asarray(jsel.kth_magnitude_threshold(jnp.asarray(x), 20))
    np.testing.assert_array_equal(thr.numpy(), want)
    np.testing.assert_array_equal(
        selection.kth_magnitude_threshold(torch.from_numpy(x), 20).numpy(),
        want)
    assert mask.dtype == torch.bool and (mask.sum(-1) == 20).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randtopk_with_injected_noise_matches_pallas_kernel(seed):
    rng = np.random.RandomState(seed)
    d, k = 96, 12
    x = rng.randn(5, d).astype(np.float32)
    g = rng.gumbel(size=(5, d)).astype(np.float32)
    m = rng.binomial(k, 0.3, size=(5, 1)).clip(0, min(k, d - k)).astype(
        np.int32)
    want = np.asarray(jkernel.randtopk_mask_kernel(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(m), k, interpret=True))
    got = tk_ref.randtopk_mask(torch.from_numpy(x), torch.from_numpy(g),
                               torch.from_numpy(m), k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.sum(-1) == k).all()


def test_randtopk_statistics_track_alpha():
    d, k, alpha = 64, 8, 0.3
    x = torch.from_numpy(np.random.RandomState(0).randn(1, d).astype(
        np.float32))
    is_top = selection.topk_mask(x, k)[0]
    gen = torch.Generator().manual_seed(7)
    masks = torch.stack([selection.randtopk_mask(x, k, alpha, gen)[0]
                         for _ in range(300)])
    assert (masks.sum(-1) == k).all()
    non_top = masks[:, ~is_top].sum(-1).float()
    assert abs(non_top.mean().item() - alpha * k) < 0.35


@pytest.mark.parametrize("d", [1, 31, 32, 33, 40, 256])
def test_mask_words_pack_unpack_match_reference(d):
    mask = np.random.RandomState(d).rand(3, d) < 0.5
    want = np.asarray(jsel.pack_mask_words(jnp.asarray(mask)))
    got = selection.pack_mask_words(torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    back = selection.unpack_mask_words(got, d)
    np.testing.assert_array_equal(back.numpy(), mask)
    np.testing.assert_array_equal(
        selection.unpack_mask_words(torch.from_numpy(want), d).numpy(), mask)


def test_mask_from_indices_matches_reference():
    idx = np.random.RandomState(3).randint(0, 50, (4, 7)).astype(np.int32)
    want = np.asarray(jsel.mask_from_indices(jnp.asarray(idx), 50))
    got = selection.mask_from_indices(torch.from_numpy(idx), 50)
    np.testing.assert_array_equal(got.numpy(), want)


def test_binomial_count_clipped_to_pools():
    gen = torch.Generator().manual_seed(0)
    m = selection.binomial_nontop_count(gen, 0.9, 10, 14, (500,))
    assert m.shape == (500, 1) and int(m.max()) <= 4 and int(m.min()) >= 0


def test_backend_resolver():
    x = torch.zeros(2, 8)
    assert selection.resolve_backend(None, x) == "torch"
    assert selection.resolve_backend("auto", x) == "torch"
    assert selection.resolve_backend("torch", x) == "torch"
    with pytest.raises(ValueError):
        selection.resolve_backend("cuda", x)
    with pytest.raises(ValueError):
        selection.resolve_backend("pallas", x)


def _wrapper_calls():
    from repro_torch.core.payload import Payload, PayloadMeta
    from repro_torch.kernels.decode import ops as dec_ops
    from repro_torch.kernels.encode import ops as enc_ops

    x = torch.zeros(2, 8)
    p = Payload(meta=PayloadMeta("dense", d=8), values=torch.zeros(1, 8))
    slots = torch.zeros(1, dtype=torch.int32)
    return {
        "topk_mask_threshold": lambda b: tk_ops.topk_mask_threshold(
            x, 2, backend=b),
        "encode_rows": lambda b: enc_ops.encode_rows(x, "dense", backend=b),
        "pack_bits": lambda b: enc_ops.pack_bits(
            torch.zeros(4, dtype=torch.int32), 3, backend=b),
        "decode_rows_to_slots": lambda b: dec_ops.decode_rows_to_slots(
            torch.zeros(2, 8), p, slots, backend=b),
    }


@pytest.mark.parametrize("name", ["topk_mask_threshold", "encode_rows",
                                  "pack_bits", "decode_rows_to_slots"])
def test_kernel_wrapper_backend_on_cpu(name):
    """Each wrapper takes its plain version for a CPU tensor under the
    default and "torch" backends, and raises when asked for the kernel."""
    call = _wrapper_calls()[name]
    call(None)
    call("torch")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        call("cuda")
