"""Port parity: the mixture-of-experts block (`repro_torch.models.moe`)
against the JAX reference's `repro.models.moe`, at granite-moe-1b-a400m
and qwen3-moe-235b-a22b SMOKE in f32, from the reference's weights.

  * the full-sequence block (one routing group of B*S tokens): y, the
    balance loss, each expert's kept tokens in arrival order and which of
    its slots hold a kept token, at the default capacity factor and at 0.5,
    where tokens are dropped, on random rows and on rows of zeros (a
    uniform router: the top-k ties break to the lower expert index);
  * its gradients with respect to x and every weight;
  * the decode block (`per_row=True`): each row equals the reference's
    block on that row alone (its vmapped per-session step), and does not
    depend on the other rows.

y, aux and gradients within rtol 1e-5, atol 1e-6; expert ids, orders,
slots and drop counts exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.models.config import Runtime as JRuntime
from repro_torch import configs
from repro_torch.models import moe, transformer
from repro_torch.models.config import Runtime
from repro_torch.models.convert import params_from_jax

ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b"]
TOL = dict(rtol=1e-5, atol=1e-6)
B, S = 2, 12


@pytest.fixture(scope="module", params=ARCHS)
def block(request):
    """(reference cfg, port cfg, reference layer-0 moe weights, the port's
    converted copy)."""
    jcfg = jconfigs.get(request.param, smoke=True)
    cfg = configs.get(request.param, smoke=True)
    jp = jtr.init_model(jax.random.key(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    return jcfg, cfg, jl, transformer.layer_params(tp, 0)["moe"]


def _x(d, zeros):
    x = np.random.RandomState(7).randn(B, S, d).astype(np.float32)
    if zeros:
        x[0, 2] = 0.0
        x[1, 5:7] = 0.0
    return x


def _reference_routing(probs, cfg, capacity):
    """Each expert's (order, valid) from the reference's router
    probabilities: `one_expert` of `repro/models/moe.py` `_local_moe`,
    transcribed line for line (the reference keeps them internal)."""
    T = probs.shape[0]
    _, top_i = jax.lax.top_k(probs, cfg.topk_experts)

    def one_expert(gid):
        hit = jnp.any(top_i == gid, axis=-1)
        order_rank = jnp.cumsum(hit.astype(jnp.int32)) - 1
        prio = jnp.where(hit, order_rank, T + 1)
        order = jnp.argsort(prio)[:capacity]
        valid = jnp.take(prio, order) <= capacity - 1
        return order, valid

    order, valid = jax.vmap(one_expert)(jnp.arange(cfg.n_experts))
    return np.asarray(top_i), np.asarray(order), np.asarray(valid)


@pytest.mark.parametrize("zeros", [False, True], ids=["random", "zero rows"])
@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_moe_matches_reference(block, factor, zeros):
    jcfg, cfg, jl, tl = block
    x = _x(cfg.d_model, zeros)
    jy, jaux = jmoe.moe(jl, jcfg, JRuntime(moe_capacity=factor),
                        jnp.asarray(x))
    y, aux = moe.moe(tl, cfg, Runtime(moe_capacity=factor),
                     torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)

    T = B * S
    C = moe._capacity(T, cfg, factor)
    assert C == jmoe._capacity(T, jcfg, factor)
    _, jprobs = jmoe._local_moe(
        jnp.asarray(x.reshape(T, -1)), jl["router"], jl["w_gate"],
        jl["w_up"], jl["w_down"], cfg=jcfg, e_offset=0, capacity=C)
    want_i, want_order, want_valid = _reference_routing(jprobs, jcfg, C)
    logits = torch.from_numpy(x.reshape(T, -1)) @ tl["router"]
    r = moe.route(torch.softmax(logits, -1)[None], cfg.topk_experts, C)
    np.testing.assert_array_equal(r.top_i[0].numpy(), want_i)
    np.testing.assert_array_equal(r.order[:, 0].numpy(), want_order)
    np.testing.assert_array_equal(r.valid[:, 0].numpy(), want_valid)
    kept = r.slot < cfg.n_experts * C
    assert int(kept.sum()) == int(want_valid.sum())
    dropped = T * cfg.topk_experts - int(want_valid.sum())
    if factor < 1:
        assert dropped > 0
    if zeros:   # a uniform router: the lower expert ids win the ties
        tied = r.top_i[0, 2].numpy()
        np.testing.assert_array_equal(tied, np.arange(cfg.topk_experts))
        np.testing.assert_array_equal(tied, want_i[2])


def test_moe_gradients_match_reference(block):
    """d(sum(y * w) + aux) with respect to x and every weight, at capacity
    0.5 (drops) so dropped pairs must carry no gradient."""
    jcfg, cfg, jl, tl = block
    x = _x(cfg.d_model, True)
    w = np.random.RandomState(8).randn(*x.shape).astype(np.float32)
    rt = 0.5

    def jloss(p, xx):
        y, aux = jmoe.moe(p, jcfg, JRuntime(moe_capacity=rt), xx)
        return jnp.sum(y * w) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jl, jnp.asarray(x))
    tp = {k: ({"scale": v["scale"].clone().requires_grad_(True)}
              if isinstance(v, dict) else v.clone().requires_grad_(True))
          for k, v in tl.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe(tp, cfg, Runtime(moe_capacity=rt), xt)
    (torch.sum(y * torch.from_numpy(w)) + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **TOL)
    for name in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(tp[name].grad.numpy(),
                                   np.asarray(jgp[name]), **TOL,
                                   err_msg=name)


def test_decode_rows_are_independent_and_match_the_reference(block):
    """`per_row=True` on (4, 1, d): each row equals the reference's block
    on that row alone (capacity 1, nothing dropped), bit for bit whatever
    the other rows hold; rows 1 and 3 tie."""
    jcfg, cfg, jl, tl = block
    rng = np.random.RandomState(9)
    x = rng.randn(4, 1, cfg.d_model).astype(np.float32)
    x[1] = 0.0
    x[3] = 0.0
    y, _ = moe.moe(tl, cfg, Runtime(), torch.from_numpy(x), per_row=True)
    one = jax.jit(lambda xx: jmoe.moe(jl, jcfg, JRuntime(), xx)[0])
    for r in range(4):
        np.testing.assert_allclose(y[r].numpy(),
                                   np.asarray(one(x[r:r + 1]))[0], **TOL)
    x2 = x.copy()
    x2[[0, 1, 3]] = rng.randn(3, 1, cfg.d_model)
    y2, _ = moe.moe(tl, cfg, Runtime(), torch.from_numpy(x2), per_row=True)
    assert torch.equal(y2[2], y[2])
