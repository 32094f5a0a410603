"""The port's dry run (`launch/specs.py`, `launch/dryrun.py`,
`roofline/program.py`, `analysis.from_program`) against the JAX
reference's `launch/specs.py`, `launch/dryrun.py` and `roofline/*`, on
the CPU; every count runs on the `meta` device.

  * `SHAPES`, `adapt_config`, the cut of `build_config`, `batch_specs`,
    the abstract parameters' leaf shapes and `model_flops` equal the
    reference's for every arch (and shape).
  * The counter: closed forms for one `Linear` (2 * B * in * out flops,
    twice its output's bytes), a peak that holds a storage while a view
    of it lives, and no bytes for a view.
  * qwen3-8b SMOKE train and decode at (2, 2, 2) complete with every
    roofline term positive and finite, their counted collective bytes
    = `training_collective_costs` / `decode_collective_costs` (the
    counterpart of `tests/test_launch.py::
    test_dryrun_small_mesh_train_and_decode`).
  * Depth extrapolation equals a direct count, exactly for flops, bytes,
    collective bytes and the arguments' bytes, train and decode:
    qwen3-8b, zamba2 SMOKE at 7 layers (not whole groups of its
    `attn_every` 2) and the vlm SMOKE.
  * The reference's qwen3-8b SMOKE train step at (2, 2, 2), compiled in a
    subprocess with 8 forced host devices: the port's counted FLOPs less
    `_recomputed_down_proj` equal its `hlo_flops` exactly (the port's
    5469372416 against the reference's 5234491392, 4.49% above, all of
    it that term), its bytes within `HLO_BYTES_BAND` of its `hlo_bytes`.
  * A ticking clock pins the printed count time (`DRYRUN CLOCK OK` of
    `tests/test_launch.py`); `main` exits 1 and names each failure.
"""
import contextlib
import dataclasses
import io
import math
import os
import re
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

import repro.configs as jconfigs
from repro.launch import specs as jspecs
from repro.models import common as jcommon
from repro.models import transformer as jtr
from repro.models.config import Runtime as JRuntime
from repro.roofline import analysis as janalysis
from repro_torch import configs
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import count_params
from repro_torch.models.config import SplitConfig
from repro_torch.roofline import analysis
from repro_torch.roofline.program import CollectiveStats, ProgramCounts, \
    count_program
from repro_torch.testing.clock import Clock


def _ref_cut_for():
    """The reference dry run's `_cut_for`; importing it sets XLA_FLAGS
    (512 host devices) for the process, restored here before any JAX
    backend starts."""
    old = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdryrun
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return jdryrun._cut_for


ARCHS = list(configs._ALIASES)
#: the port's counted bytes over the reference's `hlo_bytes` (same step):
#: the port's program is unfused, so at least XLA's (measured 1.0548:
#: the port's 897041256 against 850445056)
HLO_BYTES_BAND = (1.0, 1.25)
MESH = ("pod", "data", "model")


def _meta_mesh(shape=(2, 2, 2)):
    return make_mesh(shape, MESH[-len(shape):], devices="meta")


def _split(cfg, cut, k=16):
    return cfg.with_(split=SplitConfig(cut_layer=cut, compressor="randtopk",
                                       k=k))


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_and_adapt_config_equal_the_reference(arch):
    assert list(specs.SHAPES) == list(jspecs.SHAPES)
    assert specs.LONG_CTX_WINDOW == jspecs.LONG_CTX_WINDOW
    for name, s in specs.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(
            jspecs.SHAPES[name])
        got = specs.adapt_config(configs.get(arch), s)
        want = jspecs.adapt_config(jconfigs.get(arch), jspecs.SHAPES[name])
        for f in dataclasses.fields(want):
            assert getattr(got, f.name) == getattr(want, f.name), \
                (arch, name, f.name)


@pytest.mark.parametrize("arch", ARCHS)
def test_cut_equals_the_reference(arch):
    ref_cut = _ref_cut_for()
    for name in specs.SHAPES:
        cfg, _ = dryrun.build_config(arch, name, split="randtopk")
        want = ref_cut(jspecs.adapt_config(jconfigs.get(arch),
                                           jspecs.SHAPES[name]))
        assert cfg.split.cut_layer == want
        assert dryrun.build_config(arch, name)[0].split is None


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_the_reference(arch):
    for name, s in specs.SHAPES.items():
        got = specs.batch_specs(configs.get(arch), s)
        want = jspecs.batch_specs(jconfigs.get(arch), jspecs.SHAPES[name],
                                  JRuntime())
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            assert got[key].device.type == "meta"
            assert tuple(got[key].shape) == tuple(w.shape), (key, name)
            assert str(got[key].dtype).split(".")[-1] == str(w.dtype), key


def _leaf_shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaf_shapes(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tuple(tree.shape)}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_equal_the_reference(arch):
    cfg = configs.get(arch)
    got = specs.abstract_params(cfg)
    want = jax.eval_shape(
        lambda: jtr.init_model(jax.random.key(0), jconfigs.get(arch)))
    assert _leaf_shapes(got) == _leaf_shapes(want)
    assert all(t.device.type == "meta"
               for t in torch.utils._pytree.tree_leaves(got))
    assert count_params(got) == jcommon.count_params(want)


def test_all_archs_equal_the_reference():
    assert [c.name for c in configs.all_archs()] == \
        [c.name for c in jconfigs.all_archs()]


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(arch):
    for name, s in specs.SHAPES.items():
        tokens = s.batch * (s.seq if s.kind != "decode" else 1)
        got = analysis.model_flops(
            specs.adapt_config(configs.get(arch), s), tokens=tokens,
            training=s.kind == "train")
        want = janalysis.model_flops(
            jspecs.adapt_config(jconfigs.get(arch), jspecs.SHAPES[name]),
            tokens=tokens, training=s.kind == "train")
        assert got == want


def test_counter_closed_forms_for_one_linear():
    B, n_in, n_out = 8, 64, 32
    lin = torch.nn.Linear(n_in, n_out, bias=False)
    x = torch.randn(B, n_in)
    with count_program() as c:
        y = lin(x)
    assert c.flops == 2 * B * n_in * n_out
    assert c.bytes == 2 * y.numel() * 4
    assert c.peak == y.numel() * 4
    assert c.collectives.per_op_bytes == {}


def test_counter_peak_holds_a_storage_while_a_view_lives():
    with count_program() as c:
        a = torch.zeros(1000)           # 4000 B
        v = a[10:20]                    # a view: no bytes, no storage
        del a                           # v keeps a's storage alive
        b = torch.zeros(500)            # 4000 + 2000 live
        del v                           # a's storage goes
        d = torch.zeros(250)            # 2000 + 1000 live
    assert c.peak == 6000
    assert c.bytes == 2 * (4000 + 2000 + 1000)
    del b, d


def test_from_program_fills_the_roofline():
    counts = ProgramCounts(flops=989 * 10**12, bytes=335 * 10**10, peak=7,
                           collectives=CollectiveStats({"all-reduce": 4.5e11}))
    roof = analysis.from_program(counts, arch="a", shape="s", mesh_desc="2",
                                 chips=2, model_flops=989e12 / 2,
                                 args_bytes=5)
    assert roof.t_compute == pytest.approx(0.5)
    assert roof.t_memory == pytest.approx(0.5)
    assert roof.t_collective == pytest.approx(2 * 4.5e11 / analysis.LINK_BW)
    assert roof.peak_memory == 12 and roof.useful_flops_ratio == 0.5
    assert roof.bottleneck == "collective"


def _finite_positive(roof):
    r = roof.row()
    for key in ("t_compute_s", "t_memory_s", "t_collective_s", "hlo_flops",
                "peak_mem_gb"):
        assert math.isfinite(r[key]) and r[key] > 0, key


def test_dryrun_small_mesh_train_and_decode():
    mesh = _meta_mesh()
    cfg = _split(configs.get("qwen3-8b", smoke=True), 1)
    for kind, want in (
            ("train", analysis.training_collective_costs(cfg, 8, 64,
                                                         mesh.shape)),
            ("decode", analysis.decode_collective_costs(cfg, 8, 64,
                                                        mesh.shape))):
        got = dryrun.count_one(cfg, specs.ShapeSpec("t", kind, 64, 8), mesh)
        roof = analysis.from_program(
            got.counts, arch="qwen3-8b", shape=kind, mesh_desc="2x2x2",
            chips=8, model_flops=1.0, args_bytes=got.args_bytes)
        _finite_positive(roof)
        assert got.counts.collectives.per_op_bytes == want[0]
        assert roof.coll_bytes == want[1]
        assert got.cache_collectives.per_op_bytes == {}


def test_whisper_decode_counts_the_cache_apart():
    mesh = _meta_mesh()
    cfg = _split(configs.get("whisper-tiny", smoke=True), 1)
    got = dryrun.count_one(cfg, specs.ShapeSpec("d", "decode", 16, 8), mesh)
    want = analysis.decode_collective_costs(cfg, 8, 16, mesh.shape)[0]
    cache = analysis.decode_cache_collective_costs(cfg, 8, mesh.shape)[0]
    assert got.counts.collectives.per_op_bytes == want
    assert got.cache_collectives.per_op_bytes == cache
    assert cache["collective-permute"] > 0


@pytest.mark.parametrize("arch,kind,target", [
    ("qwen3-8b", "train", 5), ("qwen3-8b", "decode", 5),
    ("zamba2-7b", "train", 7), ("zamba2-7b", "decode", 7),
    ("llama-3.2-vision-90b", "train", 10),
    ("llama-3.2-vision-90b", "decode", 8)])
def test_depth_extrapolation_is_exact(arch, kind, target):
    mesh = _meta_mesh()
    base = configs.get(arch, smoke=True)
    cfg = dryrun.at_depth(_split(base.with_(n_layers=target), 1), target)
    shape = specs.ShapeSpec("s", kind, 16, 8)
    train = kind == "train"
    ds = dryrun.depths(cfg, train)
    assert max(ds) < target
    got = dryrun.extrapolate(cfg, {
        d: dryrun.count_one(dryrun.at_depth(cfg, d), shape, mesh)
        for d in ds}, train)
    want = dryrun.count_one(cfg, shape, mesh)
    assert got.counts.flops == want.counts.flops
    assert got.counts.bytes == want.counts.bytes
    assert got.args_bytes == want.args_bytes
    assert got.counts.collectives == want.counts.collectives
    assert got.cache_collectives == want.cache_collectives


def test_train_step_zero_fills_an_unused_leaf():
    """zamba2 at a depth without a shared-attention site (`depths` counts
    2, 3 and 4 layers of zamba2-7b, a site every 6th): the shared block's
    gradient is zero, as `jax.grad` gives, and AdamW leaves it as it
    was."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer
    from repro_torch.models.config import Runtime
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.data.pipeline import make_lm_batch

    cfg = _split(configs.get("zamba2-7b", smoke=True).with_(
        n_layers=2, attn_every=4), 1)
    g = torch.Generator().manual_seed(0)
    params = transformer.init_model(cfg, g, device="cpu")
    before = params["shared_attn"]["wq"].clone()
    new, _, m = make_train_step(cfg, Runtime())(
        params, adamw_init(params), make_lm_batch(g, cfg, 2, 8), g)
    assert torch.equal(new["shared_attn"]["wq"], before)
    assert not torch.equal(new["layers"]["w_out"], params["layers"]["w_out"])
    assert math.isfinite(float(m["loss"]))


def test_train_step_raises_on_another_unreached_leaf():
    """Only the groups `_unreached_groups` names take a zero gradient: a
    leaf cut off from the loss anywhere else is a wiring fault."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer
    from repro_torch.models.config import Runtime
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.data.pipeline import make_lm_batch

    cfg = _split(configs.get("yi-6b", smoke=True).with_(n_layers=2), 1)
    g = torch.Generator().manual_seed(0)
    params = transformer.init_model(cfg, g, device="cpu")
    params["stray"] = {"w": torch.zeros(3)}
    with pytest.raises(RuntimeError, match="'stray'"):
        make_train_step(cfg, Runtime())(
            params, adamw_init(params), make_lm_batch(g, cfg, 2, 8), g)


def test_depths():
    yi = configs.get("yi-6b")
    assert dryrun.depths(yi, True) == [2, 3, 4]
    assert dryrun.depths(yi, False) == [2, 3]
    zamba = configs.get("zamba2-7b")
    assert dryrun.depths(zamba, True) == [2, 3, 4, 6]
    assert dryrun.depths(zamba, False) == [2, 3, 6]
    assert dryrun.kinds(zamba, 81, False) == [1, 68, 13]
    vlm = configs.get("llama-3.2-vision-90b")
    assert dryrun.depths(vlm, True) == [10, 15, 20]
    assert dryrun.kinds(vlm, 100, True) == [1, 20, 400]


def _recomputed_down_proj(cfg, tokens, chips):
    """The FLOPs the port's step counts and the reference's compiled one
    does not. Remat recomputes each layer's forward in the backward. The
    recomputed MLP down projection (the layer's last matmul) feeds
    nothing the backward reads, so XLA drops it as dead code; torch's
    checkpoint stops early, after the last saved tensor it needs, so it
    drops only the last position's call of it (the single controller
    runs the `chips` positions in turn)."""
    down = 2 * tokens * cfg.d_ff * cfg.d_model
    return cfg.n_layers * down * (chips - 1) // chips


def test_counted_flops_against_the_reference_hlo():
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent("""
            import os
            os.environ["XLA_FLAGS"] = \\
                "--xla_force_host_platform_device_count=8"
            import jax
            from repro.launch import specs as S
            from repro.launch.mesh import make_mesh
            from repro.launch.steps import make_train_step
            from repro.models.config import Runtime, SplitConfig
            from repro.roofline import analysis
            import repro.configs as configs
            mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
            cfg = configs.get("qwen3-8b", smoke=True).with_(
                split=SplitConfig(cut_layer=1, compressor="randtopk", k=16))
            rt = Runtime(mesh=mesh, training=True)
            with mesh:
                args, in_sh = S.train_specs(
                    cfg, S.ShapeSpec("t", "train", 64, 8), rt)
                step = make_train_step(cfg, rt, internal_key=True)
                compiled = jax.jit(step, in_shardings=in_sh,
                                   donate_argnums=(0, 1)).lower(
                    *args).compile()
            roof = analysis.from_compiled(
                compiled, arch="qwen3-8b", shape="t", mesh_desc="2x2x2",
                chips=8, model_flops=1.0, bf16_target=False)
            print("HLO_FLOPS", roof.hlo_flops, "HLO_BYTES", roof.hlo_bytes)
        """)], capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"},
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    ref = re.search(r"HLO_FLOPS ([0-9.e+]+) HLO_BYTES ([0-9.e+]+)",
                    out.stdout)
    cfg = _split(configs.get("qwen3-8b", smoke=True), 1)
    got = dryrun.count_one(cfg, specs.ShapeSpec("t", "train", 64, 8),
                           _meta_mesh())
    extra = _recomputed_down_proj(cfg, 8 * 64, chips=8)
    assert extra == 234881024
    # exact: a dropped or doubled matmul of any size fails
    assert got.counts.flops - extra == round(float(ref.group(1)))
    ratio = got.counts.bytes / float(ref.group(2))
    assert HLO_BYTES_BAND[0] <= ratio <= HLO_BYTES_BAND[1], ratio


class TickingClock(Clock):
    """+7.5 s a `monotonic()` read."""

    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        self.t += 7.5
        return self.t

    def sleep(self, seconds):
        pass


def _fake_counted(*a, **k):
    return dryrun.Counted(ProgramCounts(flops=10**12, bytes=10**12, peak=1),
                          1, CollectiveStats({}))


def test_dryrun_count_time_reads_the_clock(monkeypatch):
    monkeypatch.setattr(dryrun, "count_combo", _fake_counted)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun.run_combo("yi-6b", "train_4k", clock=TickingClock())
    text = buf.getvalue()
    assert "== yi-6b x train_4k mesh=16x16 (count 7.5s) ==" in text, text
    for line in ("memory:", "cost:", "roofline:", "collectives:"):
        assert f"  {line}" in text


def test_main_names_each_failure(monkeypatch):
    def run_combo(arch, shape, **kw):
        if shape == "long_500k":
            raise ValueError("no room")
        return analysis.from_program(_fake_counted().counts, arch=arch,
                                     shape=shape, mesh_desc="16x16",
                                     chips=256)

    monkeypatch.setattr(dryrun, "run_combo", run_combo)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = dryrun.main(["--all"])
    text = buf.getvalue()
    assert rc == 1
    n = len(configs.ARCHS)
    assert f"{3 * n} OK, {n} FAILED" in text
    assert "FAIL yi_6b x long_500k: ValueError: no room" in text
    monkeypatch.setattr(dryrun, "run_combo", lambda *a, **k: run_combo(
        "yi-6b", "train_4k"))
    with contextlib.redirect_stdout(io.StringIO()):
        assert dryrun.main(["--arch", "yi-6b", "--shape", "train_4k"]) == 0


@pytest.mark.parametrize("arch,kind", [
    ("zamba2-7b", "train"), ("zamba2-7b", "prefill"),
    ("rwkv6-1.6b", "train"), ("rwkv6-1.6b", "prefill")])
def test_sequence_solve_is_exact(arch, kind):
    """A recurrent family's count solved from `seq_points` (whole
    multiples of its scan's chunk, zamba2's attention whole) equals the
    direct count one chunk length further, in FLOPs, bytes, the
    arguments' bytes and collective bytes, SMOKE at (2, 2)."""
    mesh = _meta_mesh((2, 2))
    cfg = _split(configs.get(arch, smoke=True), 1)
    train = kind == "train"
    unit = dryrun.scan_chunk(cfg)
    n = 3 if train or arch == "zamba2-7b" else 2
    shape = specs.ShapeSpec("s", kind, unit * (n + 2), 4)
    points = dryrun.seq_points(cfg, mesh, shape.seq, train)
    assert [s for s, _ in points] == [unit * (i + 2) for i in range(n)]
    assert not any(dryrun.chunked(cfg, *p) for p in points)
    _assert_solved_is_direct(cfg, shape, mesh)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_sequence_solve_is_exact_across_attention_chunks(kind):
    """Where zamba2's shared attention runs in query chunks at the
    shape's length (`attention._attend`), every length the solve counts
    runs in query chunks too, and the solved count equals the direct
    one: SMOKE in bf16 (the production dtype: `sdpa`'s f32 copies of k
    and v come once a chunk) at (2, 2), 640 tokens in five chunks of
    128, from lengths of 256-512 in chunks of 64-256."""
    mesh = _meta_mesh((2, 2))
    cfg = _split(configs.get("zamba2-7b", smoke=True), 1).with_(
        param_dtype="bfloat16", dtype="bfloat16")
    train = kind == "train"
    shape = specs.ShapeSpec("s", kind, 640, 4)
    assert dryrun.chunked(cfg, 640, 128)
    points = dryrun.seq_points(cfg, mesh, 640, train, 128)
    assert points == [(256, 128), (256, 64), (384, 192), (384, 128),
                      (512, 256)]
    assert all(dryrun.chunked(cfg, *p) for p in points)
    _assert_solved_is_direct(cfg, shape, mesh, 128)


def _assert_solved_is_direct(cfg, shape, mesh, *chunk):
    got = dryrun.count_combo(cfg, shape, mesh, *chunk)
    want = dryrun.count_depths(cfg, shape, mesh, *chunk)
    assert got.counts.flops == want.counts.flops
    assert got.counts.bytes == want.counts.bytes
    assert got.args_bytes == want.args_bytes
    assert got.counts.collectives == want.counts.collectives
    assert got.counts.collectives.per_op_bytes


def test_sequence_lengths_at_the_production_mesh():
    mesh = make_mesh((16, 16), MESH[-2:], devices="meta")
    zamba, rwkv = configs.get("zamba2-7b"), configs.get("rwkv6-1.6b")
    chunked = [(256, 128), (256, 64), (384, 192), (384, 128), (512, 256)]
    assert dryrun.seq_points(zamba, mesh, 4096, True) == chunked
    assert dryrun.seq_points(zamba, mesh, 32768, False) == chunked
    assert dryrun.seq_points(zamba, mesh, 1536, False) == [
        (256, 1024), (384, 1024), (512, 1024)]
    assert dryrun.seq_points(rwkv, mesh, 4096, True) == [
        (32, 1024), (48, 1024), (64, 1024)]
    assert dryrun.seq_points(rwkv, mesh, 32768, False) == [
        (32, 1024), (48, 1024)]
    assert dryrun.scan_chunk(configs.get("yi-6b")) == 0
    assert dryrun.seq_terms(rwkv, 4096, False) == [1, 4096]
    assert dryrun.seq_terms(rwkv, 4096, True) == [1, 4096, 4096 ** 2]
    assert dryrun.seq_terms(zamba, 4096, False) == [
        1, 4096, 4096 ** 2, 4, 4 * 4096]
