"""Port parity: `repro_torch.optim` against the JAX reference's
`repro.optim`, on the same inputs made with numpy from a seed.

SGD with momentum and AdamW (with and without clipping and weight decay)
over a nested dict of f32 and bf16 params, several steps: f32 params and
moments within rtol 1e-6, bf16 params exact up to 1 bf16 ulp (the f32
update sums in another order before the one rounding). The LR schedules
within rtol 1e-6 (the reference computes in f32, the port in Python
floats).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim
from repro_torch.optim.adamw import tree_leaves

SHAPES = {"w": (6, 5), "blk": {"b": (5,), "s": (3, 4)}}
DTYPES = {"w": np.float32, "blk": {"b": "bfloat16", "s": np.float32}}


def _tree(rng):
    def leaf(shape, dt):
        return (rng.randn(*shape).astype(np.float32), dt)
    return {"w": leaf(SHAPES["w"], DTYPES["w"]),
            "blk": {k: leaf(SHAPES["blk"][k], DTYPES["blk"][k])
                    for k in SHAPES["blk"]}}


def _as_jax(tree):
    return {"w": jnp.asarray(*tree["w"]),
            "blk": {k: jnp.asarray(*v) for k, v in tree["blk"].items()}}


def _as_torch(tree):
    def conv(t):
        x = torch.from_numpy(t[0])
        return x.to(torch.bfloat16) if t[1] == "bfloat16" else x
    return {"w": conv(tree["w"]),
            "blk": {k: conv(v) for k, v in tree["blk"].items()}}


def _jleaves(tree):
    return [tree["w"]] + [tree["blk"][k] for k in tree["blk"]]


def _assert_close(jtree, ttree):
    for j, t in zip(_jleaves(jtree), tree_leaves(ttree)):
        want = np.asarray(j.astype(jnp.float32))
        got = t.float().numpy()
        if t.dtype == torch.bfloat16:
            ulp = np.abs(want) * 2.0 ** -7
            np.testing.assert_array_less(np.abs(got - want), ulp + 1e-30)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_steps_match_reference(momentum):
    rng = np.random.RandomState(0)
    init = _tree(rng)
    jp, tp = _as_jax(init), _as_torch(init)
    js, ts = joptim.sgd_init(jp), optim.sgd_init(tp)
    for i in range(3):
        g = _tree(rng)
        jp, js = joptim.sgd_update(jp, _as_jax(g), js, lr=0.05,
                                   momentum=momentum)
        tp, ts = optim.sgd_update(tp, _as_torch(g), ts, lr=0.05,
                                  momentum=momentum)
        _assert_close(jp, tp)
        _assert_close(js["mom"], ts["mom"])
        assert int(js["step"]) == int(ts["step"]) == i + 1


@pytest.mark.parametrize("grad_clip,weight_decay", [(1.0, 0.0), (0.0, 0.1),
                                                    (0.5, 0.01)])
def test_adamw_steps_match_reference(grad_clip, weight_decay):
    rng = np.random.RandomState(1)
    init = _tree(rng)
    jp, tp = _as_jax(init), _as_torch(init)
    js, ts = joptim.adamw_init(jp), optim.adamw_init(tp)
    for _ in range(3):
        g = _tree(rng)
        jp, js, jn = joptim.adamw_update(jp, _as_jax(g), js, lr=1e-2,
                                         weight_decay=weight_decay,
                                         grad_clip=grad_clip)
        tp, ts, tn = optim.adamw_update(tp, _as_torch(g), ts, lr=1e-2,
                                        weight_decay=weight_decay,
                                        grad_clip=grad_clip)
        _assert_close(jp, tp)
        _assert_close(js["mu"], ts["mu"])
        _assert_close(js["nu"], ts["nu"])
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)


@pytest.mark.parametrize("base_lr,total,min_frac", [(3e-4, 100, 0.1),
                                                    (1.0, 7, 0.0)])
def test_cosine_schedule_matches_reference(base_lr, total, min_frac):
    want = joptim.cosine_schedule(base_lr, total, min_frac)
    got = optim.cosine_schedule(base_lr, total, min_frac)
    for step in range(0, total + 5):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 20), (5, 5)])
def test_linear_warmup_cosine_matches_reference(warmup, total):
    want = joptim.linear_warmup_cosine(2e-3, warmup, total)
    got = optim.linear_warmup_cosine(2e-3, warmup, total)
    for step in range(0, total + 5):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-12)
