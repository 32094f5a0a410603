"""The hybrid, ssm, vlm and audio families on the training mesh, against
the JAX reference: zamba2-7b, rwkv6-1.6b, llama-3.2-vision-90b (with
patches) and whisper-tiny (with frames) at SMOKE in f32 on the CPU, cut
by `configs.cut_for`, randtopk k 16 alpha 0.3, batch 8 x seq 16, one
torch thread.

Both packages start from the reference's weights (converted by
`models.convert`; every cross `gate` at 0.5, as
`test_torch_multimodal.gated_weights` sets them, so the cross branches
count) and one numpy batch; RandTopK's draws for the whole batch cross
as data (the reference's for a step key), and the mesh slices them by
batch shard.

  * Loss at (2, 1), (1, 2), (2, 4), (2, 2, 2), `dp_only` (2, 4) and
    `seq_shard=False` (2, 4): within 2e-4 of the reference's mesh-less
    loss, its own bound (tests/test_distributed.py:56). Gradients and one
    AdamW step against the port's mesh=None on each batch shard with that
    shard's draws, averaged, under `test_torch_train_mesh_parity.py`'s
    rule. The step's counted collective bytes =
    `roofline.analysis.training_collective_costs`.
    rwkv6 is held looser, by its own conditioning: its mesh-less
    gradient moves by 2.3e-4 of a tensor's largest magnitude when the
    weights are scaled by 1 + 1e-7 N(0, 1) (the WKV recurrence and the
    per-head group norm amplify an ulp), and the mesh's reduce-scatters
    sum in another order; so its gradients are held within 1e-3 of each
    tensor's largest magnitude (`GRAD_ATOL`), and all but 1% of each
    weight tensor's elements (`WEIGHT_SPARE`; an element whose gradient
    is near 0 takes AdamW's first step of +-lr by its sign) within
    1e-2 * lr.
  * (1, 1) = mesh=None bit for bit: loss, every gradient, every weight.
  * Counted bytes at a 'model' of 3, which divides neither the heads nor
    d_ff (seq 48: every mixer whole, the norm gathers only), at (1, 4)
    and at (2, 2, 2) without the pod transfer; whisper SMOKE's 2 heads
    split at 'model' 2 and stay whole at 4, its counts written out here.
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
from test_torch_multimodal import set_gates
from test_torch_train_mesh_parity import _grads, _tree_like
from repro_torch import configs
from repro_torch import mesh as mesh_mod
from repro_torch.core import selection
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import convert, transformer
from repro_torch.models.config import Runtime, SplitConfig
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.optim.adamw import adamw_init, adamw_update, tree_leaves
from repro_torch.roofline import analysis

ARCHS = ["zamba2-7b", "rwkv6-1.6b", "llama-3.2-vision-90b", "whisper-tiny"]
B, S, K, ALPHA, LR = 8, 16, 16, 0.3, 1e-3
AXES2, AXES3 = ("data", "model"), ("pod", "data", "model")
MESHES = [((2, 1), {}), ((1, 2), {}), ((2, 4), {}), ((2, 2, 2), {}),
          ((2, 4), {"dp_only": True}), ((2, 4), {"seq_shard": False})]
MESH_IDS = ["2x1", "1x2", "2x4", "2x2x2", "dp_only_2x4", "no_seq_shard_2x4"]
# per family (default: test_torch_train_mesh_parity.py's rule): gradients
# within atol GRAD_ATOL * a tensor's largest magnitude (rtol 1e-4), and
# the fraction of each updated weight tensor that may miss 1e-2 * lr
GRAD_ATOL = {"ssm": 1e-3}
WEIGHT_SPARE = {"ssm": 1e-2}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(arch, **split):
    """(reference config, port config), randtopk at `configs.cut_for`."""
    cfg = configs.get(arch, smoke=True)
    split = dict(dict(cut_layer=configs.cut_for(cfg), compressor="randtopk",
                      k=K, alpha=ALPHA), **split)
    return (jconfigs.get(arch, smoke=True).with_(split=JSplitConfig(**split)),
            cfg.with_(split=SplitConfig(**split)))


def _batch(cfg, seq=S, seed=11):
    """The numpy batch: tokens, labels and the vlm's patches or whisper's
    frames, N(0, 1) * 0.02."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab, (B, seq)).astype(np.int32)
    nb = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    side = {"vlm": ("patches", cfg.n_image_tokens),
            "audio": ("frames", cfg.n_frames)}.get(cfg.family)
    if side:
        nb[side[0]] = (rng.randn(B, side[1], cfg.d_model) * 0.02).astype(
            np.float32)
    return nb


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """Both packages' config, weights and batch, the reference's draws and
    its mesh-less loss."""
    jcfg, cfg = _config(request.param)
    npp = set_gates(jax.tree.map(np.asarray, jtr.init_model(
        jax.random.key(0), jcfg)))
    jparams = jax.tree.map(jnp.asarray, npp)
    nb = _batch(cfg)
    key = jax.random.key(7)
    kb, kg = jax.random.split(key)
    d = cfg.d_model
    draws = (np.asarray(jsel.binomial_nontop_count(kb, ALPHA, K, d, (B, S))),
             np.asarray(jax.random.gumbel(kg, (B, S, d), dtype=jnp.float32)))
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    loss, _ = jax.jit(lambda p, b: jsteps.loss_fn(
        p, jcfg, JRuntime(training=True), b, key))(jparams, jb)
    return {"cfg": cfg, "params": convert.params_from_jax(npp, cfg, "cpu"),
            "batch": {k: torch.from_numpy(v) for k, v in nb.items()},
            "draws": draws, "loss": float(loss)}


def _inject(monkeypatch, model, rows=slice(None)):
    m, g = model["draws"]
    monkeypatch.setattr(selection, "binomial_nontop_count",
                        lambda *a, **kw: torch.from_numpy(m[rows].copy()))
    monkeypatch.setattr(selection, "gumbel_noise",
                        lambda *a, **kw: torch.from_numpy(g[rows].copy()))


def _mesh(shape):
    return make_mesh(shape, AXES3 if len(shape) == 3 else AXES2,
                     devices="cpu")


def _counted(rt):
    return {op: float(v) for op, v in
            mesh_mod.collective_bytes(rt.registry.snapshot()).items()}


def _costs(cfg, shape, seq=S, **kw):
    axes = AXES3 if len(shape) == 3 else AXES2
    return analysis.training_collective_costs(
        cfg, B, seq, dict(zip(axes, shape)), **kw)[0]


@pytest.mark.parametrize("shape,kw", MESHES, ids=MESH_IDS)
def test_mesh_step_matches_reference_and_mesh_less(monkeypatch, model,
                                                   shape, kw):
    cfg, params, batch = model["cfg"], model["params"], model["batch"]
    rt = Runtime(mesh=_mesh(shape), registry=MetricsRegistry(), **kw)
    n = int(np.prod(shape)) // (1 if kw.get("dp_only") else shape[-1])
    costs = _costs(cfg, shape, **kw)       # its probe encode draws: first
    _inject(monkeypatch, model)
    loss, _, _, grads = _grads(cfg, params, rt, batch)
    assert _counted(rt) == costs
    new, _, m = steps.make_train_step(cfg, rt, lr=LR)(
        copy.deepcopy(params), adamw_init(params), batch, torch.Generator())
    assert float(m["loss"]) == loss
    assert abs(loss - model["loss"]) <= 2e-4

    # the port's mesh=None on each batch shard, averaged
    bl, acc = B // n, None
    for b in range(n):
        rows = slice(b * bl, (b + 1) * bl)
        _inject(monkeypatch, model, rows)
        g = _grads(cfg, params, Runtime(),
                   {k: v[rows] for k, v in batch.items()})[3]
        acc = list(g) if acc is None else [a + x for a, x in zip(acc, g)]
    want = [a / n for a in acc]
    for got_g, want_g in zip(grads, want):
        scale = float(want_g.abs().max())
        atol = (GRAD_ATOL[cfg.family] * scale if cfg.family in GRAD_ATOL
                else 1e-6 * max(scale, 1.0))
        torch.testing.assert_close(got_g, want_g, rtol=1e-4, atol=atol)
    oracle, _, _ = adamw_update(params, _tree_like(params, iter(want)),
                                adamw_init(params), lr=LR)
    for a, b in zip(tree_leaves(oracle), tree_leaves(new)):
        diff = (b - a).abs()
        assert float(diff.max()) <= 2 * LR
        close = diff <= 1e-5 * a.abs() + 1e-2 * LR
        assert float(close.float().mean()) >= 1 - WEIGHT_SPARE.get(
            cfg.family, 1e-4)


def _step(cfg, params, batch, mesh, **kw):
    """One AdamW step from a seeded generator: (loss, gradients, new
    weights, counted bytes of the loss and its gradients)."""
    rt = Runtime(mesh=mesh, registry=MetricsRegistry(), **kw)
    loss, _, _, grads = _grads(cfg, params, rt, batch)
    counted = _counted(rt)
    new, _, m = steps.make_train_step(cfg, rt, lr=LR)(
        copy.deepcopy(params), adamw_init(params), batch,
        torch.Generator().manual_seed(5))
    return m, grads, tree_leaves(new), counted


def test_mesh_1x1_equals_no_mesh_bit_for_bit(model):
    """Loss, aux, grad norm, every gradient and every weight."""
    cfg, params, batch = model["cfg"], model["params"], model["batch"]
    m0, g0, w0, _ = _step(cfg, params, batch, None)
    m1, g1, w1, counted = _step(cfg, params, batch, _mesh((1, 1)))
    assert counted == {}
    for key in m0:
        assert torch.equal(m0[key], m1[key]), key
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(w0, w1))


def _port_params(cfg):
    """The port's own random weights, every cross `gate` at 0.5."""
    params = transformer.init_model(cfg, torch.Generator().manual_seed(0))
    for sub in params.get("cross_layers", {}).values():
        sub["gate"].fill_(0.5)
    return params


BYTE_CASES = [("1x3_seq48", (1, 3), 48, {}), ("1x4", (1, 4), S, {}),
              ("2x2x2_no_pod", (2, 2, 2), S, {"transfer_over_pod": False})]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name,shape,seq,over", BYTE_CASES,
                         ids=[c[0] for c in BYTE_CASES])
def test_counted_bytes_equal_training_collective_costs(arch, name, shape,
                                                       seq, over):
    """A step's forward, recompute and backward collectives per op =
    `training_collective_costs`, and its loss within 2e-4 of mesh=None's
    (a generator of the same seed: the draws are made for all rows at
    once)."""
    _, cfg = _config(arch, **over)
    params = _port_params(cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seq).items()}
    with torch.no_grad():
        want, _ = steps.loss_fn(params, cfg, Runtime(), batch,
                                torch.Generator())
    rt = Runtime(mesh=_mesh(shape), registry=MetricsRegistry())
    loss, _, _, _ = _grads(cfg, params, rt, batch)
    assert _counted(rt) == _costs(cfg, shape, seq)
    assert abs(loss - float(want)) <= 2e-4


WHISPER_G = B * S * 128 * 4


@pytest.mark.parametrize("shape,want", [
    ((1, 2), {"all-gather": 33 * WHISPER_G,
              "reduce-scatter": 14.5 * WHISPER_G}),
    ((1, 4), {"all-gather": 27 * WHISPER_G,
              "reduce-scatter": 4.25 * WHISPER_G})], ids=["split", "whole"])
def test_whisper_heads_split_at_model_2_and_whole_at_4(shape, want):
    """whisper SMOKE (2 heads, d_ff 256, 2 encoder and 2 decoder layers of
    d 128 over F = S = 16 frames, cut 1) at (1, 2) and (1, 4), f32, with
    G = 8 x 16 x 128 x 4 B a gathered activation. Per decoder layer three
    norm gathers (all-gather G twice under remat, reduce-scatter G / M
    back); per encoder layer two; the MLP's reduce-scatter G / M once
    (trailing; all-gather G back); at M = 2 attention's and cross
    attention's reduce-scatters G / 2 twice each (all-gather G back), at
    M = 4 none (the heads stay whole); the encoder output's gather, the
    cut's and the head's once (reduce-scatter G / M back)."""
    _, cfg = _config("whisper-tiny")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    rt = Runtime(mesh=_mesh(shape), registry=MetricsRegistry())
    _grads(cfg, _port_params(cfg), rt, batch)
    assert _counted(rt) == want == _costs(cfg, shape)
