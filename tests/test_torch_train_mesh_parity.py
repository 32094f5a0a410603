"""Port parity of a training step on a mesh against the JAX reference:
yi-6b SMOKE, qwen3-8b SMOKE (qk-norm) and granite-moe-1b-a400m SMOKE in
f32 on the CPU, cut at layer 1, randtopk k 16 alpha 0.3, moe capacity
8.0 (no token is dropped at any batch shard), batch 8 x seq 16, one
torch thread.

Both packages start from the reference's weights (converted by
`models.convert`) and one numpy batch; RandTopK's draws for the whole
batch cross as data (the reference's for a step key, handed to the
port's `selection.binomial_nontop_count` and `selection.gumbel_noise`),
and the mesh slices them by batch shard.

Loss: within 2e-4 of the reference's mesh-less loss (its own bound,
tests/test_distributed.py:56). The moe's balance loss on a mesh is the
mean over the batch shards of each shard's (the reference's `ranked`,
`src/repro/models/moe.py:138-148`), so for the moe the reference's loss
is its mesh-less cross entropy over the batch plus AUX_WEIGHT times the
mean of the balance losses its mesh-less layers give each shard's rows
(the whole-batch loss where the mesh has one batch shard); the cross
entropy alone is held to the reference's mesh-less one for every family.

Gradients and one step's weights: against the port's mesh=None, run on
each batch shard with that shard's draws and averaged (for the dense
families that is the whole batch's gradient; for the moe it carries the
per-shard balance loss). Gradients within rtol 1e-4 and atol 1e-6 of
each tensor's largest magnitude; weights by the rule of
tests/test_torch_training.py: every element within 2 * lr, all but 1e-4
of each tensor's elements within 1e-2 * lr plus rtol 1e-5.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import selection as jsel
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.models.config import Runtime as JRuntime
from repro.models.config import SplitConfig as JSplitConfig
from repro.split import protocol as jprotocol
from repro_torch import configs
from repro_torch.core import selection
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import convert
from repro_torch.models.config import Runtime, SplitConfig
from repro_torch.optim.adamw import adamw_init, adamw_update, tree_leaves

ARCHS = ["yi-6b", "qwen3-8b", "granite-moe-1b-a400m"]
B, S, K, ALPHA, LR = 8, 16, 16, 0.3, 1e-3
MESHES = [((2, 1), {}), ((1, 2), {}), ((2, 4), {}), ((4, 2), {}),
          ((2, 4), {"dp_only": True}), ((2, 2, 2), {}),
          ((2, 4), {"seq_shard": False})]
MESH_IDS = ["2x1", "1x2", "2x4", "4x2", "dp_only_2x4", "2x2x2",
            "no_seq_shard_2x4"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """Both packages' config, weights and batch, the reference's draws and
    its losses, by the number of batch shards."""
    arch = request.param
    split = dict(cut_layer=1, compressor="randtopk", k=K, alpha=ALPHA)
    jcfg = jconfigs.get(arch, smoke=True).with_(split=JSplitConfig(**split))
    cfg = configs.get(arch, smoke=True).with_(split=SplitConfig(**split))
    jparams = jtr.init_model(jax.random.key(0), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     "cpu")
    rng = np.random.RandomState(11)
    tok = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    lab = np.roll(tok, -1, axis=1)
    key = jax.random.key(7)
    kb, kg = jax.random.split(key)
    d = cfg.d_model
    draws = (np.asarray(jsel.binomial_nontop_count(kb, ALPHA, K, d, (B, S))),
             np.asarray(jax.random.gumbel(kg, (B, S, d), dtype=jnp.float32)))
    jrt = JRuntime(training=True, moe_capacity=8.0)
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    _, (ce, aux) = jax.jit(lambda p, b: jsteps.loss_fn(
        p, jcfg, jrt, b, key))(jparams, jb)
    return {"cfg": cfg, "jcfg": jcfg, "jparams": jparams, "params": params,
            "batch": {"tokens": torch.from_numpy(tok),
                      "labels": torch.from_numpy(lab)},
            "jbatch": jb, "key": key, "draws": draws, "ce": float(ce),
            "aux": {1: float(aux)}, "jrt": jrt}


def _reference_aux(model, n):
    """Mean over n batch shards of the balance loss the reference's
    mesh-less layers give each shard's rows: the bottom layers on the
    shard's tokens, the top layers on its rows of the whole batch's cut
    view (the same draws)."""
    if n not in model["aux"]:
        jcfg, jp, jrt = model["jcfg"], model["jparams"], model["jrt"]
        cut, L = jcfg.split.cut_layer, jcfg.n_layers

        @jax.jit
        def per_shard(tokens):
            x = jtr.embed(jp, jcfg, jrt, tokens)
            xb, _ = jtr.apply_layers(jp, jcfg, jrt, x, {}, 0, cut)
            y, _ = jprotocol.cut_boundary(xb, jcfg, jrt, model["key"])
            bl = B // n
            out = []
            for b in range(n):
                rows = slice(b * bl, (b + 1) * bl)
                _, a1 = jtr.apply_layers(jp, jcfg, jrt, x[rows], {}, 0, cut)
                _, a2 = jtr.apply_layers(jp, jcfg, jrt, y[rows], {}, cut, L)
                out.append(a1 + a2)
            return jnp.mean(jnp.stack(out))

        model["aux"][n] = float(per_shard(model["jbatch"]["tokens"]))
    return model["aux"][n]


def _inject(monkeypatch, model, rows=slice(None)):
    m, g = model["draws"]
    monkeypatch.setattr(selection, "binomial_nontop_count",
                        lambda *a, **kw: torch.from_numpy(m[rows].copy()))
    monkeypatch.setattr(selection, "gumbel_noise",
                        lambda *a, **kw: torch.from_numpy(g[rows].copy()))


def _grads(cfg, params, rt, batch):
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    it = iter(leaves)

    def rebuild(tree):
        return {k: rebuild(v) if isinstance(v, dict) else next(it)
                for k, v in tree.items()}

    total, (ce, aux) = steps.loss_fn(rebuild(params), cfg, rt, batch,
                                     torch.Generator())
    return (float(total.detach()), float(ce.detach()), float(aux.detach()),
            torch.autograd.grad(total, leaves))


def _shards_of(shape, kw):
    n = int(np.prod(shape))
    return n if kw.get("dp_only") else n // shape[-1]


@pytest.mark.parametrize("shape,kw", MESHES, ids=MESH_IDS)
def test_mesh_step_matches_reference_and_mesh_less(monkeypatch, model,
                                                   shape, kw):
    cfg, params, batch = model["cfg"], model["params"], model["batch"]
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    rt = Runtime(mesh=make_mesh(shape, axes, devices="cpu"),
                 moe_capacity=8.0, **kw)
    n = _shards_of(shape, kw)
    _inject(monkeypatch, model)
    loss, ce, aux, grads = _grads(cfg, params, rt, batch)
    new, _, m = steps.make_train_step(cfg, rt, lr=LR)(
        copy.deepcopy(params), adamw_init(params), batch, torch.Generator())
    assert float(m["loss"]) == loss

    ref_aux = _reference_aux(model, n) if cfg.family == "moe" else 0.0
    assert abs(ce - model["ce"]) <= 2e-4
    assert abs(loss - (model["ce"] + steps.AUX_WEIGHT * ref_aux)) <= 2e-4
    np.testing.assert_allclose(aux, ref_aux, rtol=1e-5, atol=1e-6)

    # the port's mesh=None on each batch shard, averaged
    bl, acc = B // n, None
    for b in range(n):
        rows = slice(b * bl, (b + 1) * bl)
        _inject(monkeypatch, model, rows)
        g = _grads(cfg, params, Runtime(moe_capacity=8.0),
                   {k: v[rows] for k, v in batch.items()})[3]
        acc = list(g) if acc is None else [a + x for a, x in zip(acc, g)]
    want = [a / n for a in acc]
    for got_g, want_g in zip(grads, want):
        scale = float(want_g.abs().max())
        torch.testing.assert_close(got_g, want_g, rtol=1e-4,
                                   atol=1e-6 * max(scale, 1.0))
    it = iter(want)
    oracle, _, _ = adamw_update(
        params, {k: v for k, v in _tree_like(params, it).items()},
        adamw_init(params), lr=LR)
    for a, b in zip(tree_leaves(oracle), tree_leaves(new)):
        diff = (b - a).abs()
        assert float(diff.max()) <= 2 * LR
        close = diff <= 1e-5 * a.abs() + 1e-2 * LR
        assert float(close.float().mean()) >= 1 - 1e-4


def _tree_like(tree, it):
    return {k: _tree_like(v, it) if isinstance(v, dict) else next(it)
            for k, v in tree.items()}
