"""The training mesh's parts on the CPU: the collectives with their
autograd (`repro_torch.mesh`), the training half of `models.tp`, a (1, 1)
mesh against `mesh=None` bit for bit, the counted collective bytes of a
step against a closed form written here from the shapes, `launch/train
--mesh` (for every family), and the refusals.

Every mesh position lies on the CPU (`make_mesh(devices="cpu")`), one
torch thread. Collective gradients are checked by
`torch.autograd.gradcheck` in f64.
"""
import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch import mesh as mesh_mod
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe, tp, transformer
from repro_torch.models.config import Runtime, SplitConfig
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.optim.adamw import adamw_init, tree_leaves
from repro_torch.roofline import analysis

AXES2, AXES3 = ("data", "model"), ("pod", "data", "model")
ARCHS = ["yi-6b", "qwen3-8b", "granite-moe-1b-a400m"]
B, S = 8, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape, axes=None):
    return make_mesh(shape, axes or (AXES3 if len(shape) == 3 else AXES2),
                     devices="cpu")


def _xs(mesh, shape, seed=0, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g, dtype=dtype)
            for _ in range(mesh.size)]


# -- the collectives ----------------------------------------------------------

def test_groups_over_several_axes():
    mesh = _mesh((2, 2, 2))
    assert mesh.groups(("pod", "data")) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert mesh.groups("model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert mesh.groups(AXES3) == [list(range(8))]
    assert mesh.group_size(("pod", "model")) == 4


@pytest.mark.parametrize("axis,dim", [("model", 1), ("data", 0),
                                      ("pod", 2)])
def test_all_gather_and_reduce_scatter_forward(axis, dim):
    mesh = _mesh((2, 2, 2))
    xs = _xs(mesh, (2, 4, 6))
    reg = MetricsRegistry()
    got = mesh_mod.all_gather(mesh, xs, axis, dim=dim, registry=reg)
    rs = mesh_mod.reduce_scatter(mesh, xs, axis, dim=dim, registry=reg)
    for group in mesh.groups(axis):
        whole = torch.cat([xs[q] for q in group], dim)
        total = sum(xs[q] for q in group)
        c = xs[0].shape[dim] // len(group)
        for i, p in enumerate(group):
            assert torch.equal(got[p], whole)
            torch.testing.assert_close(rs[p], total.narrow(dim, i * c, c),
                                       rtol=0, atol=1e-12)
    n = xs[0].numel() * 8
    assert mesh_mod.collective_bytes(reg.snapshot()) == {
        "all-gather": 2 * n, "reduce-scatter": n // 2}


def test_all_reduce_sum_and_permute_forward():
    mesh = _mesh((2, 2, 2))
    xs = _xs(mesh, (3,))
    reg = MetricsRegistry()
    got = mesh_mod.all_reduce(mesh, xs, ("pod", "data"), "sum", registry=reg)
    for group in mesh.groups(("pod", "data")):
        for p in group:
            torch.testing.assert_close(got[p], sum(xs[q] for q in group),
                                       rtol=0, atol=1e-12)
    moved = mesh_mod.permute(mesh, xs, "pod", [(0, 1), (1, 0)], registry=reg)
    for p in range(8):
        assert torch.equal(moved[mesh.shift(p, "pod", 1 - mesh.coord(
            p, "pod"))], xs[p])
    assert mesh_mod.collective_bytes(reg.snapshot()) == {
        "all-reduce": 24, "collective-permute": 24}


def _gradcheck(fn, xs):
    xs = [x.detach().requires_grad_(True) for x in xs]
    assert torch.autograd.gradcheck(lambda *a: tuple(fn(list(a))), xs)


@pytest.mark.parametrize("which", ["all_gather", "reduce_scatter",
                                   "all_reduce", "permute"])
def test_collective_backward_is_the_transpose(which):
    """gradcheck in f64 on a (2, 2, 2) mesh, and a backward counts its
    own collective: all-gather <-> reduce-scatter, psum <-> psum, permute
    <-> the inverse permute."""
    mesh = _mesh((2, 2, 2))
    fns = {
        "all_gather": lambda r: lambda xs: mesh_mod.all_gather(
            mesh, xs, "model", dim=1, registry=r),
        "reduce_scatter": lambda r: lambda xs: mesh_mod.reduce_scatter(
            mesh, xs, "model", dim=1, registry=r),
        "all_reduce": lambda r: lambda xs: mesh_mod.all_reduce(
            mesh, xs, ("pod", "data"), "sum", registry=r),
        "permute": lambda r: lambda xs: mesh_mod.permute(
            mesh, xs, "pod", [(0, 1), (1, 0)], registry=r),
    }
    xs = _xs(mesh, (2, 4))
    _gradcheck(fns[which](None), xs)
    reg = MetricsRegistry()
    leaves = [x.detach().requires_grad_(True) for x in xs]
    outs = fns[which](reg)(leaves)
    fwd = dict(mesh_mod.collective_bytes(reg.snapshot()))
    torch.autograd.grad(sum((o * (i + 1)).sum() for i, o in
                            enumerate(outs)), leaves)
    got = mesh_mod.collective_bytes(reg.snapshot())
    back = {"all_gather": ("reduce-scatter", 2 * 4 * 8),
            "reduce_scatter": ("all-gather", 2 * 4 * 8),
            "all_reduce": ("all-reduce", 8 * 8),
            "permute": ("collective-permute", 8 * 8)}[which]
    want = dict(fwd)
    want[back[0]] = want.get(back[0], 0) + back[1]
    assert got == want


def test_a_group_of_one_moves_nothing():
    mesh = _mesh((1, 1))
    xs = _xs(mesh, (2, 3))
    reg = MetricsRegistry()
    for fn in (lambda: mesh_mod.all_gather(mesh, xs, "model", 1, reg),
               lambda: mesh_mod.reduce_scatter(mesh, xs, "model", 1, reg),
               lambda: mesh_mod.all_reduce(mesh, xs, "data", "sum", reg)):
        assert fn()[0] is xs[0]
    assert mesh_mod.collective_bytes(reg.snapshot()) == {}


# -- tp: gather_seq and out_proj_rs -------------------------------------------

def _layout(shape, **kw):
    return tp.Layout(Runtime(mesh=_mesh(shape), registry=MetricsRegistry(),
                             **kw), B, S)


def test_layout_of_the_batch_and_sequence():
    lay = _layout((2, 2, 2))
    assert lay.groups == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert lay.reps == [0, 2, 4, 6] and lay.b_loc == 2 and lay.seq
    assert not _layout((2, 4), seq_shard=False).seq
    dp = _layout((2, 4), dp_only=True)
    assert dp.n_model == 1 and len(dp.groups) == 8 and not dp.seq
    assert not tp.Layout(Runtime(mesh=_mesh((1, 4))), B, 18).seq
    with pytest.raises(ValueError, match="batch 6"):
        tp.Layout(Runtime(mesh=_mesh((4, 1))), 6, S)
    two = make_mesh((2, 1), AXES2, devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="one device"):
        tp.Layout(Runtime(mesh=two), B, S)


def test_gather_seq_is_the_whole_sequence():
    lay = _layout((2, 2))
    x = torch.randn(B, S, 5, dtype=torch.float64)
    xs = [lay.local_seq(p, x[lay.shard_of[p] * 4:(lay.shard_of[p] + 1) * 4])
          for p in range(4)]
    got = tp.gather_seq(lay, xs)
    for p in range(4):
        b = lay.shard_of[p]
        assert torch.equal(got[p], x[b * 4:(b + 1) * 4])
    assert mesh_mod.collective_bytes(lay.registry.snapshot()) == {
        "all-gather": 4 * S * 5 * 8}


def test_sum_model_is_the_group_sum():
    """Each position gets its 'model' group's sum, counted once as an
    all-reduce; its backward sums the gradients (gradcheck in f64)."""
    lay = _layout((2, 2))
    xs = _xs(lay.mesh, (4, S, 1))
    got = tp.sum_model(lay, xs)
    for group in lay.groups:
        for p in group:
            torch.testing.assert_close(got[p], sum(xs[q] for q in group),
                                       rtol=0, atol=1e-12)
    assert mesh_mod.collective_bytes(lay.registry.snapshot()) == {
        "all-reduce": 4 * S * 8}
    _gradcheck(lambda ts: tp.sum_model(lay, ts), xs)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_out_proj_rs_is_the_plain_matmul(shape):
    """Partial products over the local rows of w, the weight's 'data'
    shard all-gathered first, reduce-scattered along the sequence: each
    position's chunk of h @ w, in f64 within 1e-12; its gradient too."""
    lay = _layout(shape)
    n_data, m = shape
    N, d = 12, 6
    g = torch.Generator().manual_seed(1)
    h = torch.randn(B, S, N, generator=g, dtype=torch.float64)
    w = torch.randn(N, d, generator=g, dtype=torch.float64,
                    requires_grad=True)
    bl, n = B // n_data, N // m
    hs = [h[lay.shard_of[p] * bl:(lay.shard_of[p] + 1) * bl, :,
            lay.rank(p) * n:(lay.rank(p) + 1) * n]
          for p in range(lay.mesh.size)]
    ys = tp.out_proj_rs(lay, hs, w, split=True)
    want = h @ w
    for p, y in enumerate(ys):
        b = lay.shard_of[p]
        torch.testing.assert_close(
            y, lay.local_seq(p, want[b * bl:(b + 1) * bl]), rtol=0,
            atol=1e-12)
    ref_grad, = torch.autograd.grad(want.sum(), w)
    got_grad, = torch.autograd.grad(sum(y.sum() for y in ys), w)
    torch.testing.assert_close(got_grad, ref_grad, rtol=0, atol=1e-11)
    counted = mesh_mod.collective_bytes(lay.registry.snapshot())
    act = bl * S * d * 8
    want_bytes = {"reduce-scatter": act // m, "all-gather": act}
    if n_data > 1:            # the weight's 'data' shard, both ways
        want_bytes["all-gather"] += n * d * 8
        want_bytes["reduce-scatter"] += n * d // n_data * 8
    assert counted == want_bytes


# -- a whole step -------------------------------------------------------------

def _model(arch, compressor="randtopk"):
    cfg = configs.get(arch, smoke=True).with_(split=SplitConfig(
        cut_layer=1, compressor=compressor, k=16, alpha=0.3))
    params = transformer.init_model(cfg, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    tok = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tok),
             "labels": torch.from_numpy(np.roll(tok, -1, axis=1))}
    return cfg, params, batch


def _step(cfg, params, batch, mesh, **kw):
    """One AdamW step: (metrics, gradients, new weights, counted bytes)."""
    rt = Runtime(mesh=mesh, registry=MetricsRegistry(), moe_capacity=8.0,
                 **kw)
    p = tree_leaves(params)
    leaves = [t.detach().requires_grad_(True) for t in p]
    it = iter(leaves)
    tree = _rebuild(params, it)
    total, _ = steps.loss_fn(tree, cfg, rt, batch,
                             torch.Generator().manual_seed(5))
    grads = torch.autograd.grad(total, leaves)
    counted = mesh_mod.collective_bytes(rt.registry.snapshot())
    new, _, m = steps.make_train_step(cfg, rt, lr=1e-3)(
        copy.deepcopy(params), adamw_init(params), batch,
        torch.Generator().manual_seed(5))
    return m, grads, tree_leaves(new), counted


def _rebuild(tree, it):
    return {k: _rebuild(v, it) if isinstance(v, dict) else next(it)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_1x1_equals_no_mesh_bit_for_bit(arch):
    """Loss, every gradient and every weight after one step."""
    cfg, params, batch = _model(arch)
    m0, g0, w0, _ = _step(cfg, params, batch, None)
    m1, g1, w1, counted = _step(cfg, params, batch, _mesh((1, 1)))
    assert counted == {}
    for key in m0:
        assert torch.equal(m0[key], m1[key]), key
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(w0, w1))


# bytes a token of each codec's device payload (f32 values and headers,
# int32 codes, indices and mask words) and the gradient values that come
# back for it (d for the dense and quant kinds, else k)
POD_LEAVES = {
    "identity": lambda d, k: (4 * d, d),
    "l1": lambda d, k: (4 * d, d),
    "quant": lambda d, k: (4 * d + 8, d),
    "size_reduction": lambda d, k: (4 * k, k),
    "topk": lambda d, k: (8 * k, k),
    "randtopk": lambda d, k: (8 * k, k),
    "randtopk_mask": lambda d, k: (4 * k + 4 * ((d + 31) // 32), k),
    "randtopk_quant": lambda d, k: (8 * k + 8, k),
}


def _closed_form(cfg, shape, axes, *, dp_only=False, seq_shard=True,
                 over_pod=True):
    """Per-op bytes of one step, from the shapes: f32 activations and
    weights (4 B), remat (each layer's forward collectives again in the
    recompute, which stops before those that close the layer: the dense
    MLP's output reduce-scatter, the moe's combine and balance loss), the
    codec's payload and gradient leaves over the pod ring (`POD_LEAVES`)."""
    size = dict(zip(axes, shape))
    m = 1 if dp_only else size.get("model", 1)
    n_data, n_pod = size.get("data", 1), size.get("pod", 1)
    b = B // (math.prod(shape) // m)
    d, k, L = cfg.d_model, cfg.split.k, cfg.n_layers
    act = b * S * d * 4                      # a gathered activation
    sq = m > 1 and seq_shard and S % m == 0
    ag = rs = ar = 0
    if sq:
        # per layer: 2 norm gathers (fwd twice + bwd RS), attention's
        # output reduce-scatter (fwd twice + bwd AG) and the dense MLP's
        # (fwd once + bwd AG)
        dense = cfg.family != "moe"
        ag += L * (2 * 2 * act + (1 + dense) * act)
        rs += L * (2 * act // m + 2 * act // m + dense * act // m)
        if n_data > 1:                       # wo (and w_down) 'data' shard
            rows = [cfg.n_heads * cfg.hd] + (
                [] if cfg.family == "moe" else [cfg.d_ff])
            ag += L * sum(2 * r // m * d * 4 for r in rows)
            rs += L * sum(r // m * d // n_data * 4 for r in rows)
        ag += 2 * act                        # the cut's and the head's
        rs += 2 * act // m
    if cfg.family == "moe":
        e = cfg.n_experts // m
        if m > 1 and n_data > 1:             # 3 expert matrices
            ag += L * 2 * 3 * e * d * cfg.d_ff * 4
            rs += L * 3 * e * d // n_data * cfg.d_ff * 4
        if sq:                               # the combine, fwd once
            rs += L * act // m
            ag += L * act
        elif m > 1:
            ar += L * 2 * act
        if math.prod(shape) // m > 1:        # the balance loss, 4 B
            ar += L * 2 * 4
    out = {"all-gather": ag, "reduce-scatter": rs, "all-reduce": ar}
    if n_pod > 1 and over_pod:
        fwd, grad = POD_LEAVES[cfg.split.compressor](d, k)
        out["collective-permute"] = b * S * (fwd + 4 * grad)
    return {op: v for op, v in out.items() if v}


STEP_MESHES = [((1, 2), AXES2, {}), ((2, 4), AXES2, {}),
               ((4, 2), AXES2, {}), ((2, 4), AXES2, {"dp_only": True}),
               ((2, 2, 2), AXES3, {}), ((2, 4), AXES2, {"seq_shard": False}),
               ((1, 3), AXES2, {}), ((2, 2, 2), AXES3, {"over_pod": False})]
STEP_IDS = ["1x2", "2x4", "4x2", "dp_only", "2x2x2", "no_seq_shard",
            "1x3", "2x2x2_no_pod"]


# granite-moe SMOKE's 4 experts do not divide over a 'model' axis of 3
BYTE_CASES = [(arch, *case) for arch in ("yi-6b", "granite-moe-1b-a400m")
              for case, name in zip(STEP_MESHES, STEP_IDS)
              if not (arch.startswith("granite") and name == "1x3")]
BYTE_IDS = [f"{arch}-{name}" for arch in ("yi-6b", "granite-moe-1b-a400m")
            for name in STEP_IDS
            if not (arch.startswith("granite") and name == "1x3")]


@pytest.mark.parametrize("arch,shape,axes,kw", BYTE_CASES, ids=BYTE_IDS)
def test_counted_collective_bytes_equal_the_closed_form(arch, shape, axes,
                                                        kw):
    """A step's forward, recompute and backward collectives, per op; and
    `roofline.analysis.training_collective_costs` gives the same."""
    cfg, params, batch = _model(arch)
    kw = dict(kw)
    if not kw.pop("over_pod", True):
        cfg = cfg.with_(split=dataclasses.replace(cfg.split,
                                                  transfer_over_pod=False))
    _, _, _, counted = _step(cfg, params, batch, _mesh(shape, axes), **kw)
    want = _closed_form(cfg, shape, axes, **kw,
                        over_pod=cfg.split.transfer_over_pod)
    assert counted == want
    got, _ = analysis.training_collective_costs(
        cfg, B, S, dict(zip(axes, shape)), **kw)
    assert got == {op: float(v) for op, v in want.items()}


@pytest.mark.parametrize("codec", sorted(POD_LEAVES))
def test_every_codec_crosses_the_pod_ring_in_its_leaves(codec):
    """At (2, 2, 2) the pod ring moves each codec's payload leaves and
    its gradient leaves back, and `training_collective_costs` sizes them
    from a probe encode."""
    cfg, params, batch = _model("yi-6b", codec)
    _, _, _, counted = _step(cfg, params, batch, _mesh((2, 2, 2)))
    want = _closed_form(cfg, (2, 2, 2), AXES3)
    assert counted == want
    got, _ = analysis.training_collective_costs(
        cfg, B, S, dict(zip(AXES3, (2, 2, 2))))
    assert got == {op: float(v) for op, v in want.items()}


@pytest.mark.parametrize("e_off,e_loc", [(0, 4), (0, 2), (2, 2)],
                         ids=["all experts", "position 0", "position 1"])
def test_combine_backward_equals_the_index_backward(monkeypatch, e_off,
                                                    e_loc):
    """The moe combine's gather backward gives a plain index backward's
    gradients bit for bit, for all experts and for a position's experts
    (most of whose pairs read the pad row), with dropped pairs."""
    cfg = configs.get("granite-moe-1b-a400m", smoke=True)
    p = transformer.layer_params(transformer.init_model(
        cfg, torch.Generator().manual_seed(0)), 0)["moe"]
    x = torch.from_numpy(np.random.RandomState(1).randn(
        32, cfg.d_model).astype(np.float32))

    def grads():
        leaves = [x] + [p[n] for n in ("router", "w_gate", "w_up", "w_down")]
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        ws = [w[e_off:e_off + e_loc] for w in leaves[2:]]
        y, aux = moe._experts({"router": leaves[1]}, cfg, leaves[0], 1, 5,
                              e_off, ws)
        w = torch.from_numpy(np.random.RandomState(2).randn(
            *y.shape).astype(np.float32))
        return torch.autograd.grad((y * w).sum() + aux, leaves)

    got = grads()
    monkeypatch.setattr(moe._Combine, "apply",
                        lambda rows, slot, token, valid:
                        moe._gather_slots(rows, slot))
    want = grads()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_experts_not_dividing_the_model_axis_raise():
    cfg, params, batch = _model("granite-moe-1b-a400m")
    with pytest.raises(ValueError, match="4 experts do not divide"):
        _step(cfg, params, batch, _mesh((1, 3)))


def test_train_cli_with_a_mesh(capsys):
    argv = ["--arch", "yi-6b", "--smoke", "--device", "cpu", "--steps", "2",
            "--batch", "4", "--seq", "16", "--split", "randtopk", "--k",
            "16", "--log-every", "1"]
    train_cli.main(argv + ["--mesh", "2,2"])
    out = capsys.readouterr().out
    assert "mesh=Mesh({'data': 2, 'model': 2})" in out
    got = [float(ln.split("loss=")[1].split()[0])
           for ln in out.splitlines() if ln.startswith("step ")]
    train_cli.main(argv)
    want = [float(ln.split("loss=")[1].split()[0])
            for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("step ")]
    assert len(got) == 2
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("arch,mesh", [("zamba2-7b", "2,2"),
                                       ("whisper-tiny", "1,2")])
def test_train_cli_with_a_mesh_for_the_other_families(capsys, arch, mesh):
    """zamba2's Mamba2 heads and shared block, whisper's encoder and cross
    attention over 'model': the losses of `--mesh` within 2e-4 of the run
    without it."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
            "--batch", "4", "--seq", "16", "--split", "randtopk", "--k",
            "16", "--log-every", "1"]
    train_cli.main(argv + ["--mesh", mesh])
    out = capsys.readouterr().out
    d, m = mesh.split(",")
    assert f"mesh=Mesh({{'data': {d}, 'model': {m}}})" in out
    got = [float(ln.split("loss=")[1].split()[0])
           for ln in out.splitlines() if ln.startswith("step ")]
    train_cli.main(argv)
    want = [float(ln.split("loss=")[1].split()[0])
            for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("step ")]
    assert len(got) == 2
    np.testing.assert_allclose(got, want, atol=2e-4)
