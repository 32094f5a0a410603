"""The hybrid, ssm, vlm and audio families on the training mesh across
processes (`mesh.ProcessMesh`, `launch.mesh.spawn`) on the CPU over
gloo, against the single controller and the JAX package.

zamba2-7b, rwkv6-1.6b, llama-3.2-vision-90b (with patches, every cross
`gate` at 0.5) and whisper-tiny (with frames) at SMOKE in f32, cut by
`configs.cut_for`, randtopk k 16 alpha 0.3, batch 8 x seq 16, from the
reference's weights (`models.convert`) with the reference's RandTopK
draws for the whole batch handed to every process
(`test_torch_train_mesh_families.py`'s inputs). Each mesh is spawned
once, 4 processes at ('data', 'model') (2, 2) and at ('pod', 'data',
'model') (2, 1, 2) (the pod ring: the vlm's top layers read the origin
shard's patches, whisper's encoder output crosses the ring), every
process on one torch thread. In each:

  * the first step's loss equals the single controller's on the same
    mesh bit for bit, and lies within 2e-4 of the reference's mesh-less
    loss (tests/test_distributed.py:52);
  * the gradient blocks each process hands AdamW (each process holds its
    block of every parameter and moment, `launch.specs.param_shardings`)
    lie within rtol 1e-5, atol 1e-6 of the same slices of the single
    controller's gradients; rwkv6's within atol 1e-3 of each whole
    tensor's largest magnitude, by `test_torch_train_mesh_families.py`'s
    `GRAD_ATOL` rule (its f32 gradient moves by 2.3e-4 of that scale
    under a 1e-7 relative weight perturbation, and the processes sum in
    another order);
  * after two steps the gathered weights are equal on every rank, and so
    are the blocks that two ranks both hold;
  * every rank counts the single controller's collective bytes;
  * while a step runs each rank holds its use blocks
    (`launch.specs.use_layouts(..., "train")`), below the whole
    parameters' bytes.
"""
from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import selection as jsel
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.models.config import Runtime as JRuntime
from test_torch_mesh_procs import _draws
from test_torch_multimodal import set_gates
from test_torch_train_mesh_families import GRAD_ATOL, _batch, _config
from repro_torch import mesh as mesh_mod
from repro_torch.launch import specs, steps
from repro_torch.launch.mesh import make_mesh, make_process_mesh, spawn
from repro_torch.models import convert
from repro_torch.models.config import Runtime
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.optim.adamw import adamw_init, tree_leaves

ARCHS = ["zamba2-7b", "rwkv6-1.6b", "llama-3.2-vision-90b", "whisper-tiny"]
B, S, K, ALPHA, LR = 8, 16, 16, 0.3, 1e-3
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
JOIN_S = 240


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(arch):
    """The reference's weights (converted, gates at 0.5), batch, draws and
    mesh-less loss."""
    jcfg, cfg = _config(arch)
    npp = set_gates(jax.tree.map(np.asarray, jtr.init_model(
        jax.random.key(0), jcfg)))
    nb = _batch(cfg)
    key = jax.random.key(7)
    kb, kg = jax.random.split(key)
    d = cfg.d_model
    draws = (np.asarray(jsel.binomial_nontop_count(kb, ALPHA, K, d, (B, S))),
             np.asarray(jax.random.gumbel(kg, (B, S, d), dtype=jnp.float32)))
    loss, _ = jax.jit(lambda p, b: jsteps.loss_fn(
        p, jcfg, JRuntime(training=True), b, key))(
        jax.tree.map(jnp.asarray, npp),
        {k: jnp.asarray(v) for k, v in nb.items()})
    return {"params": convert.params_from_jax(npp, cfg, "cpu"),
            "batch": {k: torch.from_numpy(v) for k, v in nb.items()},
            "draws": draws, "loss": float(loss)}


def _train(arch, ref, mesh, steps_n):
    """`steps_n` training steps of `arch` on `mesh` from the reference's
    weights and draws: (the first step's metrics, its summed gradients
    (AdamW's input), its collective bytes, the weights after the last
    step)."""
    cfg = _config(arch)[1]
    params, seen = ref["params"], []
    update = steps.adamw_update

    def recorded(params_, grads, *a, **kw):
        if not seen:
            seen.append([g.clone() for g in tree_leaves(grads)])
        return update(params_, grads, *a, **kw)

    reg = MetricsRegistry()
    rt = Runtime(mesh=mesh, registry=reg)
    step = steps.make_train_step(cfg, rt, lr=LR)
    p = copy.deepcopy(params)
    if mesh.procs:
        layouts = specs.param_shardings(cfg, rt, params)
        p = specs.shard_tree(mesh, p, layouts)
    steps.adamw_update = recorded
    try:
        with _draws(ref["draws"]):
            p, o, m = step(p, adamw_init(p), ref["batch"],
                           torch.Generator())
            first = {k: float(v) for k, v in m.items()}
            counted = mesh_mod.collective_bytes(reg.snapshot())
            for _ in range(steps_n - 1):
                p, o, _ = step(p, o, ref["batch"], torch.Generator())
    finally:
        steps.adamw_update = update
    out = {"metrics": first, "grads": seen[0], "bytes": counted,
           "weights": [t.detach() for t in tree_leaves(p)]}
    if mesh.procs:
        out["gathered"] = tree_leaves(specs.gather_tree(mesh, p, layouts,
                                                        params))
    return out


def _rank(rank, dev, shape, axes, refs):
    torch.set_num_threads(1)
    mesh = make_process_mesh(shape, axes, dev)
    return {arch: _train(arch, ref, mesh, 2) for arch, ref in refs.items()}


@pytest.fixture(scope="module")
def refs():
    return {arch: _reference(arch) for arch in ARCHS}


@pytest.fixture(scope="module", params=list(MESHES))
def run(request, refs, tmp_path_factory):
    shape, axes = MESHES[request.param]
    ranks = spawn(_rank, int(np.prod(shape)), (shape, axes, {
        a: {k: r[k] for k in ("params", "batch", "draws")}
        for a, r in refs.items()}), device="cpu", timeout=JOIN_S,
        store_dir=tmp_path_factory.mktemp("store"))
    mesh = make_mesh(shape, axes, devices="cpu")
    return {"ranks": ranks, "mesh": mesh, "single": {
        arch: _train(arch, r, mesh, 1) for arch, r in refs.items()},
        "layouts": {arch: tree_leaves(specs.param_shardings(
            _config(arch)[1], Runtime(mesh=mesh), r["params"]))
            for arch, r in refs.items()}}


@pytest.mark.parametrize("arch", ARCHS)
def test_first_step_loss_equals_the_single_controller(run, arch):
    want = run["single"][arch]["metrics"]
    for got in run["ranks"]:
        m = got[arch]["metrics"]
        assert m["loss"] == want["loss"]
        assert m["ce"] == want["ce"] and m["aux"] == want["aux"]


@pytest.mark.parametrize("arch", ARCHS)
def test_first_step_loss_is_the_reference_mesh_less_loss(run, refs, arch):
    for got in run["ranks"]:
        assert abs(got[arch]["metrics"]["loss"] - refs[arch]["loss"]) \
            <= 2e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_the_single_controller(run, arch):
    family = _config(arch)[1].family
    want, mesh = run["single"][arch]["grads"], run["mesh"]
    for r, got in enumerate(run["ranks"]):
        got = got[arch]["grads"]
        assert len(got) == len(want)
        for g, w, lay in zip(got, want, run["layouts"][arch]):
            blk = w[mesh_mod.block_slices(mesh, r, lay, w.shape)]
            if family in GRAD_ATOL:
                atol = GRAD_ATOL[family] * float(w.abs().max())
                torch.testing.assert_close(g, blk, rtol=1e-5, atol=atol)
            else:
                torch.testing.assert_close(g, blk, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_are_equal_across_ranks(run, arch):
    ranks = run["ranks"]
    first = ranks[0][arch]["gathered"]
    for got in ranks[1:]:
        for a, b in zip(got[arch]["gathered"], first):
            assert torch.equal(a, b)
    held = {}
    for r, got in enumerate(ranks):
        for i, (blk, lay) in enumerate(zip(got[arch]["weights"],
                                           run["layouts"][arch])):
            key = (i, mesh_mod.block_of(run["mesh"], r, lay))
            assert torch.equal(held.setdefault(key, blk), blk)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_rank_counts_the_single_controllers_bytes(run, arch):
    want = run["single"][arch]["bytes"]
    assert want
    for got in run["ranks"]:
        assert got[arch]["bytes"] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_use_blocks_in_a_step(run, refs, arch):
    cfg = _config(arch)[1]
    params = refs[arch]["params"]
    mesh = run["mesh"]
    uses = specs.use_layouts(cfg, Runtime(mesh=mesh), "train", params,
                             seq=S)
    want = specs.block_bytes(params, uses, mesh.shape)
    assert want < sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    for got in run["ranks"]:
        assert got[arch]["metrics"]["param_bytes"] == want
