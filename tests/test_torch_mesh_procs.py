"""The training mesh across processes (`mesh.ProcessMesh`,
`launch.mesh.spawn`) on the CPU over gloo, against the single
controller and the JAX package.

Each mesh is spawned once (4 processes at (2, 2) and at ('pod', 'data',
'model') (2, 1, 2), 2 at (1, 2)), every process on one torch thread, the
rendezvous through a file under the test's temporary directory, the
process group's time limit 60 s and the join's 240 s. In each:

  * the four collectives and their backward along every axis (and a
    pair of axes) equal the single-controller `Mesh`'s, bit for bit,
    and so do the bytes they count (a permute along an axis of one
    position, and any collective over a group of one, is the identity);
  * yi-6b SMOKE and granite-moe-1b-a400m SMOKE in f32, cut at layer 1,
    randtopk k 16 alpha 0.3, moe capacity 8.0, batch 8 x seq 16, from
    the reference's weights (`models.convert`) with the reference's
    RandTopK draws for the whole batch handed to every process: the
    first step's loss equals the single controller's on the same mesh
    bit for bit and lies within 2e-4 of the reference's mesh-less loss
    (tests/test_distributed.py:52; for the moe its balance loss is the
    mean over the batch shards of each shard's, as
    tests/test_torch_train_mesh_parity.py computes it); the gradients
    summed over the processes lie within rtol 1e-5, atol 1e-6 of the
    single controller's; every rank counts the single controller's
    collective bytes;
  * the sharded step (each process holds its block of every parameter
    and AdamW moment, `launch.specs.param_shardings`): each gradient
    block AdamW takes is its slice of the whole sum of
    `mesh.sum_processes` bit for bit (the same adds in the same order),
    the grad norm lies within rtol 1e-6 of that sum's (another order of
    the squares' sum), the blocks that two ranks hold are equal and the
    gathered weights are equal on every rank after two steps, each
    block's weights after one step and after two lie within the weight
    rule below of the single controller's, its first moment after one
    step within rtol 2e-5, atol 1e-7 (0.1 of the clipped gradient: the
    gradients' rtol 1e-5 twice, through the gradient and the clip scale,
    and 0.1 of their atol), and each rank's resident bytes are its
    blocks' (params and both moments); yi-6b also under `dp_only` (the
    ZeRO-3 layout: every 'data' dimension over ('data', 'model')) against
    the single controller's `dp_only` step. While a step runs each
    rank holds its use blocks (`launch.specs.use_layouts(..., "train")`:
    the 'model' block of each leaf its position reads as one, else the
    whole leaf), below the whole parameters' bytes wherever 'model'
    splits; the gather sends each rank's rest blocks to the holders of
    the same use block only (its bytes: the use blocks' less the rest
    blocks'), and the reduce sends among those holders only, less than
    the whole-world all-to-all of every rest block sends.

`launch/train --procs` trains what `--mesh` trains, for yi-6b and for
rwkv6-1.6b (SMOKE at (1, 2)): the same logged losses and checkpoint files
(the same arrays under the same keys: the processes' weights within the
weight rule of the single controller's, the processes summing the
gradients in another order), and resumed from its first step's
checkpoint it writes what the uninterrupted run writes, array for
array. The hybrid, ssm, vlm and audio families across processes:
`tests/test_torch_mesh_procs_families.py`; the decode mesh:
`tests/test_torch_decode_mesh_procs.py`; the sharded serving arena:
`tests/test_torch_arena_procs.py`.
"""
from __future__ import annotations

import contextlib
import copy
import math
import shutil
import tempfile

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
from repro_torch import mesh as mesh_mod
from repro_torch.checkpoint import store
from repro_torch.core import selection
from repro_torch.launch import dryrun, specs, steps
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import (backend_for, make_mesh,
                                     make_process_mesh, spawn)
from repro_torch.models import convert
from repro_torch.models.config import Runtime, SplitConfig
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.optim.adamw import adamw_init, global_norm, tree_leaves

ARCHS = ["yi-6b", "granite-moe-1b-a400m"]
# the trained runs: (arch, dp_only)
RUNS = {"yi-6b": ("yi-6b", False),
        "granite-moe-1b-a400m": ("granite-moe-1b-a400m", False),
        "yi-6b-dp_only": ("yi-6b", True)}
B, S, K, ALPHA, LR = 8, 16, 16, 0.3, 1e-3
AXES2, AXES3 = ("data", "model"), ("pod", "data", "model")
MESHES = {"2x2": ((2, 2), AXES2), "1x2": ((1, 2), AXES2),
          "2x1x2": ((2, 1, 2), AXES3)}
OPS = ["all_gather", "reduce_scatter", "all_reduce", "permute"]
JOIN_S = 240


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _draws(draws):
    """RandTopK's draws for the whole batch: the reference's, as data."""
    m, g = draws
    saved = selection.binomial_nontop_count, selection.gumbel_noise
    selection.binomial_nontop_count = lambda *a, **kw: torch.from_numpy(
        m.copy())
    selection.gumbel_noise = lambda *a, **kw: torch.from_numpy(g.copy())
    try:
        yield
    finally:
        selection.binomial_nontop_count, selection.gumbel_noise = saved


def _cfg(arch):
    return configs.get(arch, smoke=True).with_(split=SplitConfig(
        cut_layer=1, compressor="randtopk", k=K, alpha=ALPHA))


def _reference(arch):
    """The reference's weights (converted), batch, draws, mesh-less cross
    entropy and, by the number of batch shards, the balance loss."""
    split = dict(cut_layer=1, compressor="randtopk", k=K, alpha=ALPHA)
    jcfg = jconfigs.get(arch, smoke=True).with_(split=JSplitConfig(**split))
    cfg = _cfg(arch)
    jp = jtr.init_model(jax.random.key(0), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
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
        p, jcfg, jrt, b, key))(jp, jb)
    auxes = {1: float(aux)}
    if cfg.family == "moe":
        cut, L = jcfg.split.cut_layer, jcfg.n_layers

        @jax.jit
        def two_shards(tokens):
            x = jtr.embed(jp, jcfg, jrt, tokens)
            xb, _ = jtr.apply_layers(jp, jcfg, jrt, x, {}, 0, cut)
            y, _ = jprotocol.cut_boundary(xb, jcfg, jrt, key)
            out = []
            for b in range(2):
                rows = slice(b * B // 2, (b + 1) * B // 2)
                _, a1 = jtr.apply_layers(jp, jcfg, jrt, x[rows], {}, 0, cut)
                _, a2 = jtr.apply_layers(jp, jcfg, jrt, y[rows], {}, cut, L)
                out.append(a1 + a2)
            return jnp.mean(jnp.stack(out))

        auxes[2] = float(two_shards(jb["tokens"]))
    return {"params": params, "draws": draws, "ce": float(ce),
            "aux": auxes if cfg.family == "moe" else {1: 0.0, 2: 0.0},
            "batch": {"tokens": torch.from_numpy(tok).long(),
                      "labels": torch.from_numpy(lab).long()}}


def _xs(n):
    g = torch.Generator().manual_seed(0)
    return [torch.randn((4, 4, 6), generator=g, dtype=torch.float64)
            for _ in range(n)]


def _collectives(mesh, xs):
    """Each collective along every axis and ('pod' or 'data', 'model'):
    each position's output and input gradient, under a loss that weighs
    position p by p + 1, and the bytes counted."""
    reg, out = MetricsRegistry(), {}
    axes = list(mesh.axis_names) + [(mesh.axis_names[0], "model")]
    for axis in axes:
        for op in OPS:
            if op == "permute" and not isinstance(axis, str):
                continue
            n = mesh.group_size(axis)
            fn = {"all_gather": lambda a: mesh_mod.all_gather(
                      mesh, a, axis, dim=1, registry=reg),
                  "reduce_scatter": lambda a: mesh_mod.reduce_scatter(
                      mesh, a, axis, dim=1, registry=reg),
                  "all_reduce": lambda a: mesh_mod.all_reduce(
                      mesh, a, axis, "sum", registry=reg),
                  "permute": lambda a: mesh_mod.permute(
                      mesh, a, axis, [(i, (i + 1) % n) for i in range(n)],
                      registry=reg)}[op]
            ins = mesh_mod.pmap(
                lambda _, x: x.clone().requires_grad_(True), xs)
            ys = fn(ins)
            sum(y.sum() * (p + 1) for p, y in enumerate(ys)
                if y is not None).backward()
            out[op, axis] = (mesh_mod.pmap(lambda _, y: y.detach(), ys),
                             mesh_mod.pmap(lambda _, x: x.grad, ins))
    return out, mesh_mod.collective_bytes(reg.snapshot())


def _grads(cfg, params, rt, batch, procs):
    params = {k: v for k, v in copy.deepcopy(params).items()}
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    if procs:
        objective = steps._loss_procs(params, cfg, rt, batch,
                                      torch.Generator())[0]
        grads = list(torch.autograd.grad(objective, leaves))
        mesh_mod.sum_processes(rt.mesh, grads)
        return grads
    total, _ = steps.loss_fn(params, cfg, rt, batch, torch.Generator())
    return list(torch.autograd.grad(total, leaves))


@contextlib.contextmanager
def _recorded(seen):
    """The gradients AdamW takes in the first step, recorded in `seen`."""
    update = steps.adamw_update

    def recorded(params_, grads, *a, **kw):
        if not seen:
            seen.append([g.clone() for g in tree_leaves(grads)])
        return update(params_, grads, *a, **kw)

    steps.adamw_update = recorded
    try:
        yield
    finally:
        steps.adamw_update = update


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _train(cfg, params, mesh, batch, draws, procs, dp_only=False):
    """The gradients, then two training steps: (grads, first step's
    metrics, its collective bytes, the parameters and first moment after
    each step (blocks on a process mesh), AdamW's first gradients); on a
    process mesh also the weights gathered after two steps and the
    resident bytes of the blocks after the first."""
    with _draws(draws):
        grads = _grads(cfg, params, Runtime(mesh=mesh, moe_capacity=8.0,
                                            dp_only=dp_only), batch, procs)
        reg = MetricsRegistry()
        rt = Runtime(mesh=mesh, moe_capacity=8.0, registry=reg,
                     dp_only=dp_only)
        step = steps.make_train_step(cfg, rt, lr=LR)
        p = copy.deepcopy(params)
        if procs:
            layouts = specs.param_shardings(cfg, rt, params)
            p = specs.shard_tree(mesh, p, layouts)
        seen = []
        with _recorded(seen):
            p, o, m = step(p, adamw_init(p), batch, torch.Generator())
        out = {"grads": grads, "metrics": {k: float(v) for k, v in
                                          m.items()},
               "bytes": mesh_mod.collective_bytes(reg.snapshot()),
               "adamw_grads": seen[0],
               "step1": [t.detach().clone() for t in tree_leaves(p)],
               "mu1": [t.clone() for t in tree_leaves(o["mu"])],
               "resident": _nbytes(p) + _nbytes(o["mu"]) + _nbytes(o["nu"])}
        p, o, _ = step(p, o, batch, torch.Generator())
    out["step2"] = [t.detach() for t in tree_leaves(p)]
    if procs:
        out["gathered2"] = tree_leaves(specs.gather_tree(mesh, p, layouts,
                                                         params))
    return out


def _rank(rank, dev, shape, axes, refs):
    torch.set_num_threads(1)
    mesh = make_process_mesh(shape, axes, dev)
    out = {"collectives": _collectives(mesh, mesh.each(
        lambda p: _xs(mesh.size)[p]))}
    for name, (arch, dp_only) in RUNS.items():
        ref = refs[arch]
        out[name] = _train(_cfg(arch), ref["params"], mesh, ref["batch"],
                           ref["draws"], procs=True, dp_only=dp_only)
        if rank:   # every rank's sum is the same: rank 0 carries it
            out[name]["grads"] = None
    return out


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
    single = {"collectives": _collectives(mesh, _xs(mesh.size))}
    for name, (arch, dp_only) in RUNS.items():
        r = refs[arch]
        single[name] = _train(_cfg(arch), r["params"], mesh, r["batch"],
                              r["draws"], procs=False, dp_only=dp_only)
    return {"id": request.param, "ranks": ranks, "single": single,
            "mesh": mesh, "shards": {
                dp_only: math.prod(shape[:-1]) * (shape[-1] if dp_only
                                                  else 1)
                for dp_only in (False, True)}}


def _layouts(run, name, refs):
    arch, dp_only = RUNS[name]
    return tree_leaves(specs.param_shardings(_cfg(arch), Runtime(
        mesh=run["mesh"], dp_only=dp_only), refs[arch]["params"]))


def _blocks(run, name, refs, rank, whole):
    """Rank `rank`'s blocks of the whole tensors `whole`, the run's
    leaves in order."""
    return [w[mesh_mod.block_slices(run["mesh"], rank, lay, w.shape)]
            for w, lay in zip(whole, _layouts(run, name, refs))]


def _weight_rule(a, b, bound):
    """The weights `a` against `b`: no element off by more than `bound`,
    all but 1e-4 of them within 1e-5 |b| + 1e-2 lr (the rule of
    tests/test_torch_train_mesh_parity.py)."""
    diff = (a - b).abs()
    assert float(diff.max()) <= bound
    close = diff <= 1e-5 * b.abs() + 1e-2 * LR
    assert float(close.float().mean()) >= 1 - 1e-4


@pytest.mark.parametrize("op", OPS)
def test_collectives_match_the_single_controller(run, op):
    want, want_bytes = run["single"]["collectives"]
    seen = 0
    for rank, got in enumerate(run["ranks"]):
        outs, counted = got["collectives"]
        assert counted == want_bytes
        for (o, axis), (ys, gs) in outs.items():
            if o != op:
                continue
            seen += 1
            assert torch.equal(ys[rank], want[o, axis][0][rank]), axis
            assert torch.equal(gs[rank], want[o, axis][1][rank]), axis
            assert all(y is None for p, y in enumerate(ys) if p != rank)
    assert seen


@pytest.mark.parametrize("arch", list(RUNS))
def test_first_step_loss_equals_the_single_controller(run, arch):
    want = run["single"][arch]["metrics"]
    for got in run["ranks"]:
        m = got[arch]["metrics"]
        assert m["loss"] == want["loss"]
        assert m["ce"] == want["ce"] and m["aux"] == want["aux"]


@pytest.mark.parametrize("arch", list(RUNS))
def test_first_step_loss_is_the_reference_mesh_less_loss(run, refs, arch):
    name, (arch, dp_only) = arch, RUNS[arch]
    ref = refs[arch]
    want = ref["ce"] + steps.AUX_WEIGHT * (
        ref["aux"][run["shards"][dp_only]] if _cfg(arch).family == "moe"
        else 0.0)
    for got in run["ranks"]:
        m = got[name]["metrics"]
        assert abs(m["ce"] - ref["ce"]) <= 2e-4
        assert abs(m["loss"] - want) <= 2e-4


@pytest.mark.parametrize("arch", list(RUNS))
def test_gradients_match_the_single_controller(run, arch):
    got, want = run["ranks"][0][arch]["grads"], run["single"][arch]["grads"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_are_equal_across_ranks(run, refs, arch):
    """The weights gathered after two steps are equal on every rank, and
    so are the blocks that two ranks both hold; each rank's blocks after
    one step and after two lie within the weight rule of the single
    controller's (two steps: twice the bound)."""
    ranks = run["ranks"]
    lays = _layouts(run, arch, refs)
    for got in ranks[1:]:
        for a, b in zip(got[arch]["gathered2"], ranks[0][arch]["gathered2"]):
            assert torch.equal(a, b)
    held = {}
    for r, got in enumerate(ranks):
        for i, (blk, lay) in enumerate(zip(got[arch]["step2"], lays)):
            key = (i, mesh_mod.block_of(run["mesh"], r, lay))
            assert torch.equal(held.setdefault(key, blk), blk)
    single = run["single"][arch]
    for r, got in enumerate(ranks):
        for n, bound in (("step1", 2 * LR), ("step2", 2 * 2 * LR)):
            for a, b in zip(got[arch][n],
                            _blocks(run, arch, refs, r, single[n])):
                _weight_rule(a, b, bound)


@pytest.mark.parametrize("arch", list(RUNS))
def test_gradient_blocks_are_slices_of_the_ordered_sum(run, refs, arch):
    """Each gradient block AdamW takes is its slice of the whole sum in
    position order (`mesh.sum_processes`), bit for bit."""
    whole = run["ranks"][0][arch]["grads"]
    for r, got in enumerate(run["ranks"]):
        blocks = got[arch]["adamw_grads"]
        assert len(blocks) == len(whole)
        for g, w in zip(blocks, _blocks(run, arch, refs, r, whole)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("arch", list(RUNS))
def test_grad_norm_is_the_whole_sums(run, arch):
    """The norm formed from the blocks is the whole sum's (the
    whole-parameter step's) within rtol 1e-6: the squares add in another
    order."""
    whole = run["ranks"][0][arch]["grads"]
    want = float(global_norm(dict(enumerate(whole))))
    for got in run["ranks"]:
        assert abs(got[arch]["metrics"]["grad_norm"] - want) <= 1e-6 * want


@pytest.mark.parametrize("arch", list(RUNS))
def test_first_moment_blocks_match_the_single_controller(run, refs, arch):
    single = run["single"][arch]["mu1"]
    for r, got in enumerate(run["ranks"]):
        for a, b in zip(got[arch]["mu1"], _blocks(run, arch, refs, r,
                                                  single)):
            torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("arch", list(RUNS))
def test_each_rank_holds_only_its_blocks(run, refs, arch):
    """A rank's parameters and moments are its blocks of each leaf, of
    the shapes the layouts give, and their bytes are the blocks' (params
    in their dtype, the two moments in f32)."""
    whole = tree_leaves(refs[RUNS[arch][0]]["params"])
    lays = _layouts(run, arch, refs)
    split = [math.prod(n for _, n in mesh_mod.block_of(run["mesh"], 0, lay))
             for lay in lays]
    want = sum(w.numel() // n * (w.element_size() + 8)
               for w, n in zip(whole, split))
    assert want < sum(w.numel() * (w.element_size() + 8) for w in whole)
    for r, got in enumerate(run["ranks"]):
        assert got[arch]["resident"] == want
        for b, w in zip(got[arch]["step1"], _blocks(run, arch, refs, r,
                                                    whole)):
            assert b.shape == w.shape


def _use_blocks(run, name, refs):
    """(whole, rest layouts, use layouts) of a run's leaves, in order."""
    arch, dp_only = RUNS[name]
    rt = Runtime(mesh=run["mesh"], dp_only=dp_only)
    params = refs[arch]["params"]
    return (tree_leaves(params),
            tree_leaves(specs.param_shardings(_cfg(arch), rt, params)),
            tree_leaves(specs.use_layouts(_cfg(arch), rt, "train", params,
                                          seq=S)))


def _split(mesh, lay):
    return math.prod(n for _, n in mesh_mod.block_of(mesh, 0, lay))


@pytest.mark.parametrize("arch", list(RUNS))
def test_each_rank_holds_its_use_blocks_in_a_step(run, refs, arch):
    """The parameters a step holds are the use blocks, their bytes
    `specs.block_bytes` of the use layouts: below the whole parameters'
    where a leaf is held as its 'model' block (not under dp_only, which
    holds every leaf whole)."""
    mesh = run["mesh"]
    whole, _, uses = _use_blocks(run, arch, refs)
    want = sum(w.numel() // _split(mesh, u) * w.element_size()
               for w, u in zip(whole, uses))
    arch_, dp_only = RUNS[arch]
    assert want == specs.block_bytes(refs[arch_]["params"], specs.use_layouts(
        _cfg(arch_), Runtime(mesh=mesh, dp_only=dp_only), "train", seq=S),
        mesh.shape)
    full = sum(w.numel() * w.element_size() for w in whole)
    held_as_blocks = any("model" in u for u in uses)
    assert held_as_blocks == (not RUNS[arch][1] and mesh.shape["model"] > 1)
    assert (want < full) == held_as_blocks
    for got in run["ranks"]:
        assert got[arch]["metrics"]["param_bytes"] == want


@pytest.mark.parametrize("arch", list(RUNS))
def test_the_moves_send_only_among_holders_of_a_use_block(run, refs, arch):
    """A rank's gather sends its rest block of a leaf to the other
    positions of its use block only: the use blocks' bytes less the rest
    blocks'. Its reduce sends among the positions that hold its use block
    only: to each other holder its piece of the rest block (an all-to-all
    of the k holders), or, where its rest block is the use block, twice
    (k - 1) / k of it (the holders' sum); less than the all-to-all of
    every rest block over the whole world where a leaf is held as a
    'model' block."""
    mesh = run["mesh"]
    world = mesh.size
    gather = reduce = everyone = 0
    for w, lay, use in zip(*_use_blocks(run, arch, refs)):
        el = w.element_size()
        rest, held = (w.numel() // _split(mesh, lay_) * el
                      for lay_ in (lay, use))
        gather += held - rest
        k = world // _split(mesh, use)
        if rest == held:
            reduce += 2 * (k - 1) * -(-w.numel() // _split(mesh, use)
                                      // k) * el
        else:
            reduce += (k - 1) * rest
        everyone += ((world - 1) * rest if rest < w.numel() * el
                     else 2 * (world - 1) * -(-w.numel() // world) * el)
    for got in run["ranks"]:
        m = got[arch]["metrics"]
        assert m["gather_sent"] == gather
        assert m["reduce_sent"] == reduce
    if any("model" in u for u in _use_blocks(run, arch, refs)[2]):
        assert reduce < everyone
    if not RUNS[arch][1]:       # the dry run's reckoning of the same
        want = dryrun.procs_step_bytes(_cfg(RUNS[arch][0]), mesh, S)
        assert (want["gather_sent"], want["reduce_sent"]) == (gather, reduce)
        assert want["whole_reduce_sent"] == everyone


@pytest.mark.parametrize("arch", list(RUNS))
def test_every_rank_counts_the_single_controllers_bytes(run, arch):
    want = run["single"][arch]["bytes"]
    # dp_only has no tensor parallelism: without a pod ring it moves
    # nothing that is counted
    assert want or RUNS[arch][1]
    for got in run["ranks"]:
        assert got[arch]["bytes"] == want


@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-1.6b"])
def test_train_cli_procs_is_the_single_controller_run(capfd, monkeypatch,
                                                      tmp_path, arch):
    """`launch/train --mesh 1,2 --procs` trains what `--mesh 1,2` trains:
    the same logged losses and, after two steps, the same checkpoint
    files (rank 0's, of the gathered blocks): the same arrays under the
    same keys, the weights within the weight rule above (the processes
    sum the gradients in another order). Resumed from its first step's
    checkpoint, the process run writes the uninterrupted run's files,
    array for array."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps",
            "2", "--batch", "4", "--seq", "8", "--split", "randtopk", "--k",
            "16", "--mesh", "1,2", "--log-every", "1"]
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # the processes' threads
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the store
    single = train_cli.main(argv + ["--ckpt-every", "2", "--ckpt-dir",
                                    str(tmp_path / "one")])
    single_log = capfd.readouterr().out
    assert train_cli.main(argv + ["--procs", "--ckpt-every", "1",
                                  "--ckpt-dir", str(tmp_path / "procs")]) \
        is None
    procs_log = capfd.readouterr().out

    def losses(log):
        return [ln.split("(")[0] for ln in log.splitlines()
                if ln.startswith("step")]

    assert len(losses(single_log)) == 2
    assert losses(procs_log) == losses(single_log)
    assert "ProcessMesh" in procs_log
    files = {sub: _arrays(tmp_path / "procs" / sub, 2)
             for sub in ("", "opt", "rng")}
    for sub, arrays in files.items():
        want = _arrays(tmp_path / "one" / sub, 2)
        assert {k: (a.shape, a.dtype) for k, a in arrays.items()} == \
            {k: (a.shape, a.dtype) for k, a in want.items()}
    procs = store.restore(str(tmp_path / "procs"), 2, single)
    for a, b in zip(tree_leaves(procs), tree_leaves(single)):
        diff = (a - b.detach()).abs()
        assert float(diff.max()) <= 2 * 2 * 3e-4
    # resumed from step 1
    resumed = tmp_path / "resumed"
    shutil.copytree(tmp_path / "procs", resumed)
    for sub in ("", "opt", "rng"):
        (resumed / sub / "step_00000002.npz").unlink()
    assert train_cli.main(argv + ["--procs", "--ckpt-every", "1",
                                  "--ckpt-dir", str(resumed)]) is None
    assert "restored step 1" in capfd.readouterr().out
    for sub, arrays in files.items():
        again = _arrays(resumed / sub, 2)
        assert again.keys() == arrays.keys()
        for k, a in arrays.items():
            assert again[k].dtype == a.dtype
            assert np.array_equal(again[k], a), (sub, k)


def _arrays(ckpt_dir, step):
    with np.load(ckpt_dir / f"step_{step:08d}.npz") as data:
        return dict(data)


def test_backend_choice():
    """gloo for a shared device; NCCL only for one distinct card a
    process; any other choice raises before a process starts."""
    assert backend_for(2, "cpu") == ("gloo", [torch.device("cpu")] * 2)
    cards = ["cuda:0", "cuda:1"]
    assert backend_for(2, devices=cards) == (
        "nccl", [torch.device(c) for c in cards])
    for devices in (["cuda:0", "cuda:0"], ["cuda:0"], ["cpu", "cpu"]):
        with pytest.raises(ValueError, match="distinct cards"):
            backend_for(2, devices=devices)
    with pytest.raises(ValueError, match="not both"):
        backend_for(2, "cpu", cards)


@pytest.mark.parametrize("extra", [["--procs", "--devices", "cpu,cpu"],
                                   ["--devices", "cuda:0,cuda:1"]])
def test_train_cli_devices_refused(extra):
    """`--devices` takes distinct cards and only with `--procs`; both
    refusals come before any process or model is made."""
    argv = ["--arch", "yi-6b", "--smoke", "--steps", "1", "--mesh", "1,2"]
    with pytest.raises((ValueError, SystemExit), match="distinct cards|"
                       "needs --procs"):
        train_cli.main(argv + extra)
