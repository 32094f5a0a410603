"""The port's sharded serving arena (`repro_torch.mesh`, `launch.mesh`,
`models.tp`, the
sharded `steps.make_arena_top_step`, `SlotArena(mesh=)`,
`run_streaming(mesh=)`) against the reference's single-device serving, on
the CPU: qwen3-8b SMOKE cut at 1, randtopk k 8, weights converted from the
reference's `init_model(key(0))`, as tests/test_mesh_arena.py serves it.
The port's mesh is one process driving every position, so every mesh
shape runs here in-process, every position on the CPU.

Tolerances: tokens exact everywhere. The (1, 1) mesh runs the mesh-less
program's arithmetic on the same shapes, so its cache is held bit for
bit. Larger meshes run each position's rows as a smaller batch, and the
CPU's f32 products may then sum in another order, so their cache leaves
are held within rtol 1e-5, atol 1e-6 of the mesh-less step (the reference
itself differs from its mesh-less step by up to 1.43e-6 there); inactive
rows are held bit-unchanged."""
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import transformer as jtr
from repro.models.config import Runtime as JRuntime
from repro.models.config import SplitConfig as JSplit
from repro.roofline import analysis as janalysis
from repro.runtime import engine as jengine
from repro.runtime import steps as jsteps
from repro_torch import configs
from repro_torch import mesh as mesh_mod
from repro_torch.launch.mesh import (make_mesh, make_production_mesh,
                                     make_serving_mesh, make_test_mesh)
from repro_torch.models import tp, transformer
from repro_torch.models.config import SplitConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.roofline import analysis
from repro_torch.runtime import engine, steps
from repro_torch.runtime.arena import SlotArena
from repro_torch.runtime.server import _EVICTING, StreamingServer

ARCH, CUT, K, CAP, MAX_LEN = "qwen3-8b", 1, 8, 8, 8
MESHES = {"8x1": dict(), "2x4": dict(model=4), "2x2x2": dict(model=2, pod=2)}
KINDS = ["identity", "size_reduction:k=8", "randtopk:k=8", "quant:bits=4",
         "randtopk_quant:k=8,bits=8"]


def _mesh(n=8, **spec):
    return make_serving_mesh(n, devices="cpu", **spec)


@pytest.fixture(scope="module")
def model():
    """(reference cfg, reference params, port cfg, port params)."""
    split = dict(cut_layer=CUT, compressor="randtopk", k=K)
    jcfg = jconfigs.get(ARCH, smoke=True).with_(split=JSplit(**split))
    cfg = configs.get(ARCH, smoke=True).with_(split=SplitConfig(**split))
    jp = jtr.init_model(jax.random.key(0), jcfg)
    tp_ = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, tp_


def _arena(cfg, mesh, cap=CAP):
    return SlotArena(lambda rows: transformer.init_cache(
        cfg, rows, MAX_LEN, device="cpu"), cap, (1, 1, cfg.d_model),
        torch.float32, "cpu", mesh=mesh)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _cache(arena):
    """The arena's cache leaves over all rows, by name."""
    if arena.mesh is None:
        return {k: v.clone() for k, v in _flat(arena.cache).items()}
    blocks = [_flat(b) for b in arena.cache]
    return {k: torch.cat([b[k] for b in blocks]) for k in blocks[0]}


def _xs():
    g = np.random.RandomState(0)
    return [g.randn(CAP + 1, 1, 1, 256).astype(np.float32) for _ in range(2)]


ACTIVE = [np.ones(CAP, bool), np.array([True, False] * (CAP // 2))]


def _drive(cfg, params, mesh):
    """Two steps of the port's arena step, all rows active then every
    other one, on the same activations staged at their wire rows.
    Returns (tokens in slot order per step, cache after each step)."""
    arena = _arena(cfg, mesh)
    step = steps.make_arena_top_step(cfg, CUT, mesh=mesh)
    perm = np.asarray([arena.wire_row(s) for s in range(CAP)])
    toks, caches = [], []
    for x, active in zip(_xs(), ACTIVE):
        xw = x.copy()
        xw[perm] = x[:CAP]
        arena.xbuf.copy_(torch.from_numpy(xw))
        tok = step(params, arena.xbuf, arena.cache, active)
        toks.append(tok.numpy()[perm])
        caches.append(_cache(arena))
    return toks, caches


def _ref_drive(jcfg, jp):
    """The reference's mesh-less arena step, same inputs."""
    rt = JRuntime(mesh=None, training=False)
    step = jax.jit(jsteps.make_arena_top_step(jcfg, rt, CUT))
    cache = jax.tree.map(lambda a: jnp.stack([a] * CAP),
                         jtr.init_cache(jp, jcfg, rt, 1, MAX_LEN))
    toks = []
    for x, active in zip(_xs(), ACTIVE):
        tok, cache = step(jp, jnp.asarray(x), cache, jnp.asarray(active))
        toks.append(np.asarray(tok)[:, 0])
    return toks


def _prompts(jcfg, n, prompt_len, seed=0):
    """The reference engine's prompt draw (engine.py:172-173)."""
    return np.asarray(jax.random.randint(jax.random.key(seed + 1),
                                         (n, prompt_len), 0, jcfg.vocab))


def _serve_both(model, spec=None, mesh_spec=(), **kw):
    """(reference single-device tokens, the port's under the mesh)."""
    jcfg, jp, cfg, tp_ = model
    mix = dict(compressor_mix=[spec]) if spec else {}
    kw = dict(dict(n_clients=2, prompt_len=2, gen=4, max_batch=2, seed=0),
              **kw)
    want = jengine.run_streaming(jcfg, params=jp, **mix, **kw)
    got = engine.run_streaming(
        cfg, params=tp_, device="cpu", mesh=_mesh(**dict(mesh_spec)),
        prompts=_prompts(jcfg, kw["n_clients"], kw["prompt_len"]), **mix,
        **kw)
    return want, got


# (a)

def test_mesh_1x1_equals_mesh_none(model):
    """`make_serving_mesh(1)`: served tokens equal `mesh=None`'s, and a
    direct drive leaves tokens and every cache leaf bit for bit equal."""
    jcfg, _, cfg, tp_ = model
    kw = dict(n_clients=2, prompt_len=2, gen=4, max_batch=2, params=tp_,
              seed=0, device="cpu")
    ref = engine.run_streaming(cfg, **kw)
    got = engine.run_streaming(cfg, mesh=_mesh(1), **kw)
    np.testing.assert_array_equal(ref["tokens"], got["tokens"])
    t0, c0 = _drive(cfg, tp_, None)
    t1, c1 = _drive(cfg, tp_, _mesh(1))
    for a, b in zip(t0, t1):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(c0, c1):
        assert a.keys() == b.keys()
        for name in a:
            assert a[name].shape == b[name].shape
            assert torch.equal(a[name], b[name]), name


# (b)

def test_wire_row_identity_without_pod_and_block_swap_with(model):
    cfg = model[2]
    for spec in (dict(), dict(model=4)):
        arena = _arena(cfg, _mesh(**spec))
        assert [arena.wire_row(s) for s in range(CAP + 1)] == \
            list(range(CAP + 1))
    arena = _arena(cfg, _mesh(model=2, pod=2))
    assert arena.capacity == CAP
    rows = [arena.wire_row(s) for s in range(CAP)]
    assert rows == [4, 5, 6, 7, 0, 1, 2, 3]
    assert arena.wire_row(CAP) == CAP            # scratch row pinned


# (c)

@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_step_matches_unsharded_and_freezes_inactive(model, name):
    """Direct drive: active rows' tokens equal the reference's mesh-less
    step and the port's own; cache leaves within rtol 1e-5 / atol 1e-6
    of the port's mesh-less step; rows inactive in the second step
    bit-unchanged."""
    jcfg, jp, cfg, tp_ = model
    want = _ref_drive(jcfg, jp)
    t0, c0 = _drive(cfg, tp_, None)
    t1, c1 = _drive(cfg, tp_, _mesh(**MESHES[name]))
    for w, a, b, active in zip(want, t0, t1, ACTIVE):
        # an inactive row's token is discarded: only active rows count
        np.testing.assert_array_equal(a[active], w[active])
        np.testing.assert_array_equal(b[active], w[active])
    for a, b in zip(c0, c1):
        for leaf in a:
            torch.testing.assert_close(b[leaf], a[leaf], rtol=1e-5,
                                       atol=1e-6)
    for leaf in c1[0]:
        assert torch.equal(c1[1][leaf][1::2], c1[0][leaf][1::2]), leaf
    assert c1[1]["pos"].tolist() == [2, 1] * (CAP // 2)


# (d)

@pytest.mark.parametrize("spec", KINDS)
def test_sharded_serving_equals_reference_all_payload_kinds(model, spec):
    """`run_streaming` under (8, 1) and (2, 4) serves the reference's
    single-device tokens for every payload kind."""
    for mesh_spec in (dict(), dict(model=4)):
        want, got = _serve_both(model, spec, mesh_spec.items())
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


# (e)

def test_pod_mesh_serves_reference_tokens_over_the_ring(model):
    want, got = _serve_both(model, mesh_spec=dict(model=2, pod=2).items(),
                            n_clients=3)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    counted = mesh_mod.collective_bytes(got["metrics"])
    assert counted.get("collective-permute", 0) > 0


# (f)

def test_sharded_eviction_keeps_uncontended_tokens(model):
    """6 clients over 2 resident slots under (2, 4): evictions and
    readmissions through sharded rows, the uncontended tokens."""
    want, got = _serve_both(model, mesh_spec=dict(model=4).items(),
                            n_clients=6, capacity=2)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    snap = got["metrics"]
    assert snap["slot_evictions_total"]["series"][0]["value"] >= 1
    assert snap["slot_readmissions_total"]["series"][0]["value"] >= 1


def test_sharded_fetch_restore_round_trip(model):
    """An evicted row reaches the host exactly and restores into another
    row of the sharded arena (tests/test_mesh_arena.py:205-231)."""
    cfg, tp_ = model[2], model[3]
    mesh = _mesh(model=2)
    server = StreamingServer(
        tp_, steps.make_arena_top_step(cfg, CUT, mesh=mesh),
        lambda rows=1: transformer.init_cache(cfg, rows, MAX_LEN,
                                              device="cpu"),
        device="cpu", max_batch=2, capacity=2,
        x_shape=(1, 1, cfg.d_model), mesh=mesh)
    assert server.arena.capacity == 8 and \
        server.arena.requested_capacity == 2
    s1 = server._session_for(1, endpoint=None)
    s2 = server._session_for(2, endpoint=None)
    s1.last_active, s2.last_active = 1.0, 2.0
    block, row = server.arena.locate(s1.slot)
    block["pos"][row] = 5
    s3 = server._session_for(3, endpoint=None)        # evicts LRU s1
    assert s1.slot == -1 and s1.host_state is _EVICTING
    server._process([])                               # fetch -> reset
    assert int(s1.host_state["pos"]) == 5
    assert int(block["pos"][row]) == 0
    s3.closed = True
    with server._lock:
        server._ensure_resident(s1)
    server._process([])                               # restore
    assert s1.host_state is None and s1.slot >= 0
    block, row = server.arena.locate(s1.slot)
    assert int(block["pos"][row]) == 5


# (g)

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vocab_parallel_argmax_is_first_occurrence(dtype):
    """Against `torch.argmax` of the whole row, ties inside a shard and
    across shard borders included, at every position of each group."""
    mesh, V = _mesh(model=4), 32
    vl = V // 4
    g = np.random.default_rng(0)
    full = []
    for _ in range(2):                                # one per model group
        x = torch.from_numpy(g.standard_normal((6, V)).astype(np.float32))
        x[1] = 0.0                                    # all tied: column 0
        x[2, vl - 1] = x[2, vl] = 9.0                 # across a border
        x[3, 2 * vl + 1] = x[3, 3 * vl + 5] = 9.0     # across two shards
        x[4, 3] = x[4, 5] = 9.0                       # inside a shard
        x[5, V - 1] = 9.0                             # the last column
        full.append(x.to(dtype))
    shards = [full[p // 4][:, (p % 4) * vl:(p % 4 + 1) * vl]
              for p in range(mesh.size)]
    got = tp.vocab_parallel_argmax(mesh, shards)
    for p in range(mesh.size):
        want = torch.argmax(full[p // 4], dim=-1).to(torch.int32)
        assert torch.equal(got[p], want), p
    assert torch.equal(got[0][1:], torch.tensor([0, vl - 1, 2 * vl + 1, 3,
                                                  V - 1], dtype=torch.int32))


# (h)

def _costs_case(model, name, dtype):
    cfg, tp_ = model[2], model[3]
    if dtype == "bfloat16":
        cfg = cfg.with_(dtype=dtype, param_dtype=dtype)
        tp_ = transformer.init_model(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    mesh = _mesh(**MESHES[name]) if name != "1x1" else _mesh(1)
    arena = SlotArena(lambda rows: transformer.init_cache(
        cfg, rows, MAX_LEN, device="cpu"), 6, (1, 1, cfg.d_model),
        cfg.adtype(), "cpu", mesh=mesh)
    registry = MetricsRegistry()
    step = steps.make_arena_top_step(cfg, CUT, mesh=mesh, registry=registry)
    step(tp_, arena.xbuf, arena.cache, np.ones(arena.capacity, bool))
    return cfg, mesh, arena, mesh_mod.collective_bytes(registry.snapshot())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["1x1"] + list(MESHES))
def test_counted_collective_bytes_equal_the_closed_form(model, name, dtype):
    """One step's counted bytes per op equal `serving_collective_costs`
    exactly (the padded capacity 8 from a requested 6), and lie in the
    reference's audit band [predicted, predicted + slack]."""
    cfg, mesh, arena, got = _costs_case(model, name, dtype)
    nbytes = 4 if dtype == "float32" else 2
    per_op, _ = analysis.serving_collective_costs(
        cfg, arena.capacity, mesh.shape, dtype_bytes=nbytes)
    assert {k: float(v) for k, v in got.items()} == per_op
    jcfg = jconfigs.get(ARCH, smoke=True)
    want, _ = janalysis.serving_collective_costs(
        jcfg, arena.capacity, mesh.shape, dtype_bytes=nbytes)
    slack = janalysis.serving_collective_slack(
        jcfg, arena.capacity, mesh.shape, dtype_bytes=nbytes)
    for op in set(want) | set(got):
        assert want.get(op, 0.0) <= got.get(op, 0) <= \
            want.get(op, 0.0) + slack.get(op, 0.0), op


def test_collective_bytes_count_into_the_run_registry_only(model):
    """Each step counts into its own registry: a registry that saw two
    steps holds twice one step's bytes, another step's registry once."""
    cfg, tp_ = model[2], model[3]
    mesh = _mesh(model=2, pod=2)
    counted = []
    for n_steps in (2, 1):
        arena = _arena(cfg, mesh)
        registry = MetricsRegistry()
        step = steps.make_arena_top_step(cfg, CUT, mesh=mesh,
                                         registry=registry)
        for _ in range(n_steps):
            step(tp_, arena.xbuf, arena.cache, np.ones(CAP, bool))
        counted.append(mesh_mod.collective_bytes(registry.snapshot()))
    assert set(counted[1]) == {"all-gather", "all-reduce",
                               "collective-permute"}
    assert counted[0] == {k: 2 * v for k, v in counted[1].items()}
    # a step built without a registry counts nowhere
    steps.make_arena_top_step(cfg, CUT, mesh=mesh)(
        tp_, arena.xbuf, arena.cache, np.ones(CAP, bool))
    assert mesh_mod.collective_bytes(registry.snapshot()) == counted[1]


def test_positions_off_the_params_device_read_one_copy(model, monkeypatch):
    """Positions whose device is not the params' (here `cpu:0`, which
    torch holds unequal to `cpu`) read a copy made once per device and
    params object, and serve the same tokens and cache."""
    cfg, tp_ = model[2], model[3]
    copies = []
    orig = steps._to

    def counting(tree, dev):
        if tree is tp_:
            copies.append(dev)
        return orig(tree, dev)

    monkeypatch.setattr(steps, "_to", counting)
    t0, c0 = _drive(cfg, tp_, _mesh(model=2, pod=2))
    assert copies == []
    t1, c1 = _drive(cfg, tp_, make_serving_mesh(
        8, model=2, pod=2, devices=["cpu:0"] * 8))
    assert copies == [torch.device("cpu", 0)]         # two steps, one copy
    for a, b in zip(t0, t1):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(c0, c1):
        for leaf in a:
            assert torch.equal(a[leaf], b[leaf]), leaf


def test_mesh_builders_take_the_reference_shapes_and_axes():
    """`make_test_mesh`, `make_production_mesh` and `make_serving_mesh`
    build the reference's shapes and axes (src/repro/launch/mesh.py);
    positions flatten in axis order."""
    cases = [
        (make_test_mesh(devices="cpu"), {"data": 1, "model": 1}),
        (make_test_mesh((2, 4), devices="cpu"), {"data": 2, "model": 4}),
        (make_production_mesh(devices="cpu"), {"data": 16, "model": 16}),
        (make_production_mesh(multi_pod=True, devices="cpu"),
         {"pod": 2, "data": 16, "model": 16}),
        (make_serving_mesh(devices=["cpu"] * 4), {"data": 4, "model": 1}),
        (_mesh(model=2, pod=2), {"pod": 2, "data": 2, "model": 2}),
    ]
    for mesh, shape in cases:
        assert mesh.shape == shape and list(mesh.shape) == list(shape)
        assert mesh.size == len(mesh.devices) == int(np.prod(
            list(shape.values())))
    mesh = _mesh(model=2, pod=2)
    assert [mesh.coord(p, "pod") for p in range(8)] == [0] * 4 + [1] * 4
    assert mesh.groups("model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert mesh.groups("pod") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert mesh.shift(1, "pod", 1) == 5
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 3)


# (i)

def test_indivisible_vocab_or_device_count_raises(model):
    cfg = model[2]
    with pytest.raises(ValueError):
        steps.make_arena_top_step(cfg, CUT, mesh=_mesh(3, model=3))
    with pytest.raises(ValueError):
        make_serving_mesh(6, model=4, devices="cpu")
    with pytest.raises(ValueError):
        make_serving_mesh(8, model=2, pod=3, devices="cpu")
    with pytest.raises(ValueError):
        engine.run_streaming(cfg, n_clients=1, gen=1, device="cpu",
                             mesh=make_mesh((1, 1), ("data", "model"),
                                            devices="meta"))


# (j)

def test_new_modules_import_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "import repro_torch.mesh, repro_torch.launch.mesh\n"
            "import repro_torch.models.tp\n"
            "import repro_torch.roofline.analysis\n"
            "import repro_torch.runtime.engine\n"
            "bad = [m for m in sys.modules if m == 'jax' or\n"
            "       m.startswith(('jax.', 'repro.')) or m == 'repro']\n"
            "assert not bad, bad\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=root,
                       env={"PYTHONPATH": str(root / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr
