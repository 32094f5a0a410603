"""The sharded serving arena across processes (`mesh.ProcessMesh`,
`launch.mesh.spawn`, `run_streaming(mesh=ProcessMesh)`,
`server.serve_follower`, `SlotArena.follow`) on the CPU over gloo,
against the single controller's sharded arena at the same mesh shape and
the JAX package's mesh-less `run_streaming`.

qwen3-8b SMOKE and rwkv6-1.6b SMOKE (its rows hold the WKV state and the
token-shift inputs), cut 1, randtopk k 8, weights converted from the
reference's `init_model(key(0))`, as `tests/test_torch_mesh.py` serves
them. Each mesh is spawned once, 4 processes at ('data', 'model') (4, 1)
and (2, 2) and at ('pod', 'data', 'model') (2, 1, 2) (the pod ring),
every process on one torch thread, and every case of the shape runs in
that one spawn. Position 0's process serves; the others follow it.

  * served tokens (4 clients x (2 + 4), 2 a flush at most) equal the
    single controller's at the same shape and the JAX package's,
    exactly: qwen3 at every shape; at (2, 2) also the five payload kinds,
    rwkv6, and both at capacity 2 (4 clients over 2 slots: evictions and
    re-admissions whose rows cross between processes);
  * every rank's counted collective bytes equal `roofline.analysis.
    serving_collective_costs` times its steps, and the followers take
    rank 0's steps (its flushes and the warm-up's);
  * a direct two-step drive (`tests/test_torch_mesh.py`'s inputs and
    active masks, 8 rows): each rank holds only its own arena block and
    its share of `xbuf`; every block equals the single controller's block
    at the same shape bit for bit after each step, inactive rows
    unchanged; rank 0's tokens equal the single controller's;
  * row ops across processes (at (2, 2), both models): a row fetched from
    another process's block, reset there and restored into a third's
    arrives bit for bit, as on the single controller;
  * an arena capacity the positions do not divide raises on every rank;
  * every rank serves on its use blocks (`launch.specs.use_layouts(...,
    "arena")`: `unembed` as its 'model' columns, the rest whole;
    `run_streaming` makes them, the direct drive through
    `specs.shard_tree`): their bytes are `specs.block_bytes` of the use
    layouts, below the whole parameters' where 'model' splits.

At capacity 2 the eviction counters are held to at least one eviction
and one re-admission each, not to the single controller's counts: which
idle session a full arena evicts follows the threads' timing, in one
process as in several. The tokens do not depend on it.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import transformer as jtr
from repro.models.config import SplitConfig as JSplit
from repro.runtime import engine as jengine
from repro_torch import configs
from repro_torch import mesh as mesh_mod
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_mesh, make_process_mesh, spawn
from repro_torch.models import transformer
from repro_torch.models.config import Runtime, SplitConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.optim.adamw import tree_leaves
from repro_torch.roofline import analysis
from repro_torch.runtime import engine, steps
from repro_torch.runtime.arena import SlotArena

ARCHS = ("qwen3-8b", "rwkv6-1.6b")
CUT, K, CAP, MAX_LEN = 1, 8, 8, 8
MESHES = {"4x1": ((4, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
KINDS = ["identity", "size_reduction:k=8", "randtopk:k=8", "quant:bits=4",
         "randtopk_quant:k=8,bits=8"]
SERVE = dict(n_clients=4, prompt_len=2, gen=4, max_batch=2, seed=0)
# (arch, compressor mix spec or None, capacity or None) by case name
CASES = {"qwen3": ("qwen3-8b", None, None),
         **{f"qwen3-{s}": ("qwen3-8b", s, None) for s in KINDS},
         "qwen3-cap2": ("qwen3-8b", None, 2),
         "rwkv6": ("rwkv6-1.6b", None, None),
         "rwkv6-cap2": ("rwkv6-1.6b", None, 2)}
SHAPE_CASES = {"4x1": ["qwen3"], "2x1x2": ["qwen3"], "2x2": list(CASES)}
DRIVES = {"4x1": ["qwen3-8b"], "2x1x2": ["qwen3-8b"], "2x2": list(ARCHS)}
# row ops of the round trip at (2, 2), 2 rows a position: slot 2 (position
# 1) to slot 5 (position 2), slot 0 (position 0) to slot 7 (position 3)
ROW_OPS = [("fetch", 2), ("reset", 2), ("restore", 5), ("fetch", 0),
           ("restore", 7)]
JOIN_S = 240


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split(cls):
    return cls(cut_layer=CUT, compressor="randtopk", k=K)


@pytest.fixture(scope="module")
def models():
    """arch -> (reference cfg, reference params, port cfg, port params)."""
    out = {}
    for arch in ARCHS:
        jcfg = jconfigs.get(arch, smoke=True).with_(split=_split(JSplit))
        cfg = configs.get(arch, smoke=True).with_(split=_split(SplitConfig))
        jp = jtr.init_model(jax.random.key(0), jcfg)
        out[arch] = (jcfg, jp, cfg,
                     params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                     "cpu"))
    return out


def _prompts(jcfg):
    """The reference engine's prompt draw (engine.py:172-173)."""
    return np.asarray(jax.random.randint(
        jax.random.key(SERVE["seed"] + 1),
        (SERVE["n_clients"], SERVE["prompt_len"]), 0, jcfg.vocab))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v.clone()
    return out


def _serve(case, cfgs, params, prompts, mesh):
    """One case served through `run_streaming` on `mesh`: position 0's
    (or the single controller's) tokens, counted bytes, flushes and slot
    counters; a follower's steps and counted bytes."""
    arch, spec, cap = CASES[case]
    out = engine.run_streaming(
        cfgs[arch], params=params[arch], prompts=prompts[arch],
        device="cpu", mesh=mesh, capacity=cap,
        compressor_mix=[spec] if spec else None, **SERVE)
    got = {"bytes": mesh_mod.collective_bytes(out["metrics"]),
           "param_bytes": out["param_bytes"]}
    if "tokens" not in out:
        return dict(got, steps=out["steps"])
    counters = {name: out["metrics"].get(name, {"series": [{"value": 0}]})
                ["series"][0]["value"]
                for name in ("slot_evictions_total",
                             "slot_readmissions_total")}
    return dict(got, tokens=out["tokens"], flushes=out["flushes"],
                warm=_warm_steps(out),
                counters=counters)


def _warm_steps(out) -> int:
    """The server's warm-up steps: one a flush bucket for each compressor,
    then one plain step."""
    max_batch = out["max_batch"]
    buckets = {1 << i for i in range(max_batch.bit_length())
               if (1 << i) <= max_batch} | {max_batch}
    return len(buckets) * len(set(out["compressor_objs"])) + 1


def _xs():
    g = np.random.RandomState(0)
    return [g.randn(CAP + 1, 1, 1, 256).astype(np.float32) for _ in range(2)]


ACTIVE = [np.ones(CAP, bool), np.array([True, False] * (CAP // 2))]


def _drive(cfg, params, mesh, row_ops):
    """Two direct steps of the arena step on every position's block (all
    rows active, then every other one) on the same activations staged at
    their wire rows by position 0, then, with `row_ops`, `ROW_OPS`.
    Returns (tokens in slot order a step (None off position 0), the
    blocks after each step and after the row ops (None where the process
    holds none), the xbuf's shape, the counted bytes, the states the row
    ops fetched on position 0)."""
    arena = SlotArena(lambda rows: transformer.init_cache(
        cfg, rows, MAX_LEN, device="cpu"), CAP, (1, 1, cfg.d_model),
        torch.float32, "cpu", mesh=mesh)
    registry = MetricsRegistry()
    step = steps.make_arena_top_step(cfg, CUT, mesh=mesh, registry=registry)
    perm = np.asarray([arena.wire_row(s) for s in range(CAP)])
    if mesh.procs:
        params = specs.shard_tree(mesh, params, _uses(cfg, mesh, params))
    leader = not mesh.procs or mesh.rank == 0
    toks, blocks, fetched = [], [], []

    def snap():
        blocks.append([None if b is None else _flat(b) for b in arena.cache])

    for x, active in zip(_xs(), ACTIVE):
        if leader:
            xw = x.copy()
            xw[perm] = x[:CAP]
            arena.xbuf.copy_(torch.from_numpy(xw))
        tok = step(params, arena.xbuf, arena.cache, active)
        toks.append(None if tok is None else tok.numpy()[perm])
        snap()
    if row_ops:
        for kind, slot in ROW_OPS:
            if not leader:
                arena.follow(kind, slot)
            elif kind == "fetch":
                fetched.append(arena.fetch_slot(slot))
            elif kind == "reset":
                arena.reset_slot(slot)
            else:
                arena.restore_slot(slot, fetched[-1])
        snap()
    return (toks, blocks, tuple(arena.xbuf.shape),
            mesh_mod.collective_bytes(registry.snapshot()), fetched)


def _uses(cfg, mesh, params):
    return specs.use_layouts(cfg, Runtime(mesh=mesh), "arena", params)


def _raises_on_indivisible(cfg, params, mesh):
    arena = SlotArena(lambda rows: transformer.init_cache(
        cfg, rows, MAX_LEN, device="cpu"), CAP, (1, 1, cfg.d_model),
        torch.float32, "cpu", mesh=mesh)
    step = steps.make_arena_top_step(cfg, CUT, mesh=mesh)
    try:
        step(params, arena.xbuf, arena.cache, np.ones(CAP - 2, bool))
    except ValueError as e:
        return "not divisible" in str(e)
    return False


def _runs(name, cfgs, params, prompts, mesh):
    return {"serve": {case: _serve(case, cfgs, params, prompts, mesh)
                      for case in SHAPE_CASES[name]},
            "drive": {arch: _drive(cfgs[arch], params[arch], mesh,
                                   name == "2x2")
                      for arch in DRIVES[name]},
            "indivisible": _raises_on_indivisible(
                cfgs["qwen3-8b"], params["qwen3-8b"], mesh)}


def _rank(rank, dev, name, cfgs, params, prompts):
    torch.set_num_threads(1)
    shape, axes = MESHES[name]
    return _runs(name, cfgs, params, prompts,
                 make_process_mesh(shape, axes, dev))


@pytest.fixture(scope="module")
def jax_tokens(models):
    """case -> the JAX package's mesh-less tokens (its capacity changes
    none of them: evicted rows come back exact), each served once."""
    done = {}

    def tokens(case):
        arch, spec, _ = CASES[case]
        if (arch, spec) not in done:
            jcfg, jp = models[arch][:2]
            done[arch, spec] = jengine.run_streaming(
                jcfg, params=jp, compressor_mix=[spec] if spec else None,
                **SERVE)["tokens"]
        return done[arch, spec]
    return tokens


@pytest.fixture(scope="module")
def runs():
    """mesh name -> its spawn's and single controller's results."""
    return {}


@pytest.fixture
def run(request, runs, models, tmp_path_factory):
    """The mesh named by the test's parameter: one spawn and one single
    controller's run of every case, made once a module."""
    name = request.param
    if name not in runs:
        shape, axes = MESHES[name]
        cfgs = {a: m[2] for a, m in models.items()}
        params = {a: m[3] for a, m in models.items()}
        prompts = {a: _prompts(m[0]) for a, m in models.items()}
        ranks = spawn(_rank, int(np.prod(shape)),
                      (name, cfgs, params, prompts), device="cpu",
                      timeout=JOIN_S,
                      store_dir=tmp_path_factory.mktemp("store"))
        runs[name] = {"shape": dict(zip(axes, shape)), "ranks": ranks,
                      "single": _runs(name, cfgs, params, prompts,
                                      make_mesh(shape, axes, devices="cpu"))}
    return runs[name]


PAIRS = [(name, case) for name in MESHES for case in SHAPE_CASES[name]]
IDS = [f"{name}-{case}" for name, case in PAIRS]
DRIVE_PAIRS = [(name, arch) for name in MESHES for arch in DRIVES[name]]


@pytest.mark.parametrize("run,case", PAIRS, ids=IDS, indirect=["run"])
def test_served_tokens_equal_single_controller_and_reference(
        run, jax_tokens, case):
    single = run["single"]["serve"][case]
    got = run["ranks"][0]["serve"][case]
    np.testing.assert_array_equal(got["tokens"], single["tokens"])
    np.testing.assert_array_equal(got["tokens"], jax_tokens(case))
    if CASES[case][2] is not None:
        for who in (single, got):
            assert who["counters"]["slot_evictions_total"] >= 1
            assert who["counters"]["slot_readmissions_total"] >= 1


@pytest.mark.parametrize("run,case", PAIRS, ids=IDS, indirect=["run"])
def test_counted_bytes_equal_serving_collective_costs(run, case):
    """Every rank counts the closed form a step, over rank 0's flushes and
    warm-up steps, which every follower takes too."""
    arch, _, cap = CASES[case]
    per_step, _ = analysis.serving_collective_costs(
        configs.get(arch, smoke=True),
        -(-(cap or SERVE["n_clients"]) // 4) * 4, run["shape"],
        dtype_bytes=4)
    leader = run["ranks"][0]["serve"][case]
    n_steps = leader["flushes"] + leader["warm"]
    single = run["single"]["serve"][case]
    for who, n in [(single, single["flushes"] + single["warm"]),
                   (leader, n_steps)] + [
            (r["serve"][case], n_steps) for r in run["ranks"][1:]]:
        assert {k: float(v) for k, v in who["bytes"].items()} == \
            {op: v * n for op, v in per_step.items()}
    assert [r["serve"][case]["steps"] for r in run["ranks"][1:]] == \
        [n_steps] * 3


@pytest.mark.parametrize("run,arch", DRIVE_PAIRS, indirect=["run"],
                         ids=[f"{n}-{a}" for n, a in DRIVE_PAIRS])
def test_each_rank_holds_its_block_equal_to_the_single_controller(
        run, arch):
    cfg = configs.get(arch, smoke=True)
    s_toks, s_blocks, s_shape, s_bytes = run["single"]["drive"][arch][:4]
    assert s_shape == (CAP + 1, 1, 1, cfg.d_model)
    per_step, _ = analysis.serving_collective_costs(
        cfg, CAP, run["shape"], dtype_bytes=4)
    assert {k: float(v) for k, v in s_bytes.items()} == \
        {op: 2 * v for op, v in per_step.items()}
    for rank, got in enumerate(run["ranks"]):
        toks, blocks, xshape, counted = got["drive"][arch][:4]
        assert xshape == ((CAP + 1) if rank == 0 else CAP // 4,
                          1, 1, cfg.d_model)
        assert counted == s_bytes
        for i, (mine, single) in enumerate(zip(blocks[:2], s_blocks)):
            assert [p for p, b in enumerate(mine) if b is not None] == \
                [rank]
            assert mine[rank].keys() == single[rank].keys()
            for leaf, t in mine[rank].items():
                assert torch.equal(t, single[rank][leaf]), (i, leaf)
        for leaf, t in blocks[1][rank].items():    # odd slots inactive
            assert torch.equal(t[1::2], blocks[0][rank][leaf][1::2]), leaf
        assert blocks[1][rank]["pos"].tolist() == [2, 1]
        if rank == 0:
            for a, b, active in zip(toks, s_toks, ACTIVE):
                np.testing.assert_array_equal(a[active], b[active])
        else:
            assert toks == [None, None]


@pytest.mark.parametrize("run", ["2x2"], indirect=True)
@pytest.mark.parametrize("arch", ARCHS)
def test_row_ops_cross_processes_bit_for_bit(run, arch):
    """`ROW_OPS` after the drive at (2, 2): on the single controller and
    across processes, slot 5 holds slot 2's row, slot 7 slot 0's, slot 2
    the fresh template; the fetched host states are the rows; the
    processes' blocks equal the single controller's."""
    cfg = configs.get(arch, smoke=True)
    fresh = _flat(transformer.init_cache(cfg, 1, MAX_LEN, device="cpu"))
    _, s_blocks, _, _, s_fetched = run["single"]["drive"][arch]
    before, after = s_blocks[1], s_blocks[2]
    fetched = run["ranks"][0]["drive"][arch][4]
    for (src, dst), state_s, state_p in zip(((2, 5), (0, 7)), s_fetched,
                                            fetched):
        state = _flat(state_s)
        for leaf, t in before[src // 2].items():
            row = t[src % 2]
            assert torch.equal(state[leaf], row), leaf
            assert torch.equal(_flat(state_p)[leaf], row), leaf
            assert torch.equal(after[dst // 2][leaf][dst % 2], row), leaf
    for leaf, t in after[1].items():
        assert torch.equal(t[0], fresh[leaf][0]), leaf
    for rank, got in enumerate(run["ranks"]):
        mine = got["drive"][arch][1][2][rank]
        for leaf, t in mine.items():
            assert torch.equal(t, after[rank][leaf]), (rank, leaf)


@pytest.mark.parametrize("run,case", PAIRS, ids=IDS, indirect=["run"])
def test_each_rank_serves_on_its_use_blocks(run, models, case):
    """`unembed` held as its 'model' columns on every rank (rank 0's
    clients never read it), every other leaf whole; the single
    controller keeps the whole parameters."""
    arch = CASES[case][0]
    cfg, params = models[arch][2:]
    mesh = make_mesh(tuple(run["shape"].values()), tuple(run["shape"]),
                     devices="meta")
    want = specs.block_bytes(params, _uses(cfg, mesh, params), mesh.shape)
    whole = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    assert (want < whole) == (mesh.shape["model"] > 1)
    assert run["single"]["serve"][case]["param_bytes"] == whole
    for got in run["ranks"]:
        assert got["serve"][case]["param_bytes"] == want


@pytest.mark.parametrize("run", list(MESHES), indirect=True)
def test_indivisible_capacity_raises_on_every_rank(run):
    assert run["single"]["indivisible"]
    assert [r["indivisible"] for r in run["ranks"]] == [True] * 4


def _failing_warm(rank, dev, cfg, params):
    """Rank 0's warm-up raises: every rank returns what `run_streaming`
    gave or raised."""
    from repro_torch.runtime.server import StreamingServer

    def warm(self, examples):
        raise RuntimeError("warm-up failed")

    torch.set_num_threads(1)
    StreamingServer.warm = warm
    mesh = make_process_mesh((1, 2), ("data", "model"), dev)
    try:
        return engine.run_streaming(cfg, params=params, device="cpu",
                                    mesh=mesh, **SERVE)
    except RuntimeError as e:
        return str(e)


def test_a_failing_server_stops_its_followers(models, tmp_path):
    """The engine's backstop sends the stop record when the serve loop
    never ran: the follower returns with no step taken, well inside the
    process group's time limit that a missed stop would wait out."""
    cfg, params = models["qwen3-8b"][2:]
    got = spawn(_failing_warm, 2, (cfg, params), device="cpu", timeout=30,
                store_dir=tmp_path)
    assert got[0] == "warm-up failed"
    assert got[1]["steps"] == 0
