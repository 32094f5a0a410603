"""Port parity of the open-loop load generator, its QoS ladder and the
batching queue's admission control, against the JAX package.

The reference's harness simulates time only: its draws are seeded
`random.Random` streams and its latencies come from a `ServiceModel` in
virtual time. So on the CPU the port's `run_loadgen` report must equal
the reference's in every field but `wall_s_real`, with tolerance 0, and
its `--trace` file must be byte-identical: three scenarios at yi-6b
SMOKE from converted weights — the static `_mini(3)` fleet (traced), a
QoS fleet at a rate where the ladder reaches its 4-bit rung (so
sparse_quant payloads of several metas share flushes), and chaos under
`FaultPlan(seed=11, ...)`. Each scenario's served tokens also equal the
reference harness's sessions'.
"""
from __future__ import annotations

import random

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.runtime.loadgen as jlg
import repro.runtime.qos as jqos
import repro.testing.faults as jfaults
from repro.models import transformer as jtr
from repro.models.config import SplitConfig as JSplit
from repro.obs.export import write_trace as jwrite_trace
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models.config import SplitConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import loadgen as lg
from repro_torch.runtime import qos
from repro_torch.runtime.batching import BatchingQueue, QueueFull
from repro_torch.testing import faults
from repro_torch.testing.clock import VirtualClock

SPLIT = dict(cut_layer=1, compressor="randtopk", k=16)
CHAOS = dict(seed=11, corrupt=0.06, drop=0.05, duplicate=0.05, reorder=0.03,
             rechunk=0.15, max_faults=30)
# the QoS fleet: sparse_quant at the top rung; at 40 sessions/s (80 in
# bursts) the ladder reaches (4, 4) at d 256
QOS = dict(k=16, d=256, bits=8, bits_floor=4, k_floor=4, high_depth=6,
           low_depth=2, deadline_s=0.04, patience=16, cooldown=1)
QOS_FLEET = dict(compressors=("randtopk_quant:k=16,bits=8",),
                 prompt_len=(2, 3), gen=(3, 5), bandwidth_Bps=400_000.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's loops run thousands of tiny CPU ops: one intra-op thread
    each, so test processes running side by side do not oversubscribe the
    cores (each op then waits on descheduled threads); restored after the
    module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mini(mod, seed, **kw):
    """The reference tests' `_mini` scenario, built from `mod` (either
    package's loadgen module)."""
    base = dict(
        seed=seed, duration_s=2.5,
        arrivals=mod.ArrivalSpec(process="mmpp", rate=12.0, burst_rate=24.0,
                                 mean_calm_s=1.0, mean_burst_s=1.0),
        fleet=mod.FleetSpec(compressors=("randtopk:k=16",),
                            prompt_len=(2, 3), gen=(3, 5),
                            bandwidth_Bps=400_000.0),
        service=mod.ServiceModel(flush_overhead_s=1e-3, per_row_s=1e-4,
                                 per_byte_s=3e-5),
        slo=mod.SLOSpec(p99_ms=60.0, max_reject_frac=0.02),
        capacity=16, max_batch=8, max_wait=0.004, admission_depth=24)
    base.update(kw)
    return mod.LoadGenConfig(**base)


def _qos_kw(mod, qos_mod):
    return dict(qos=qos_mod.QoSSpec(**QOS), fleet=mod.FleetSpec(**QOS_FLEET),
                arrivals=mod.ArrivalSpec(process="mmpp", rate=40.0,
                                         burst_rate=80.0, mean_calm_s=1.0,
                                         mean_burst_s=1.0))


@pytest.fixture(scope="module")
def weights():
    jcfg = jconfigs.get("yi-6b", smoke=True).with_(split=JSplit(**SPLIT))
    cfg = configs.get("yi-6b", smoke=True).with_(split=SplitConfig(**SPLIT))
    jp = jtr.init_model(jax.random.key(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


def _ref_run(jcfg, jp, lgc, wrap=None, trace_path=None):
    """The reference's `run_loadgen`, through its harness so the sessions'
    generated tokens can be read too. Returns (report, tokens)."""
    h = jlg._Harness(jcfg, lgc, jp, wrap, trace=trace_path is not None)
    report = h.run()
    report["failures"] = [[sid, str(h.sessions[sid].failed)]
                          for sid in h.failed]
    if trace_path is not None:
        jwrite_trace(h.tracer, trace_path)
    tokens = {str(sid): [int(t) for t in ls.generated]
              for sid, ls in sorted(h.sessions.items())}
    return report, tokens


def _both(weights, tmp_path_factory, name, ref_lg, port_lg, ref_wrap=None,
          port_wrap=None):
    jcfg, cfg, jp, tp = weights
    d = tmp_path_factory.mktemp(name)
    ref, ref_tokens = _ref_run(jcfg, jp, ref_lg, ref_wrap, d / "ref.json")
    got = lg.run_loadgen(cfg, port_lg, params=tp, device="cpu",
                         wrap_endpoint=port_wrap, trace_path=d / "port.json")
    return dict(ref=ref, ref_tokens=ref_tokens, got=got,
                ref_trace=(d / "ref.json").read_bytes(),
                got_trace=(d / "port.json").read_bytes())


@pytest.fixture(scope="module")
def static(weights, tmp_path_factory):
    return _both(weights, tmp_path_factory, "static", _mini(jlg, 3),
                 _mini(lg, 3))


@pytest.fixture(scope="module")
def adaptive(weights, tmp_path_factory):
    return _both(weights, tmp_path_factory, "qos",
                 _mini(jlg, 3, **_qos_kw(jlg, jqos)),
                 _mini(lg, 3, **_qos_kw(lg, qos)))


@pytest.fixture(scope="module")
def chaos(weights, tmp_path_factory):
    return _both(weights, tmp_path_factory, "chaos",
                 _mini(jlg, 7, retry_timeout=0.1),
                 _mini(lg, 7, retry_timeout=0.1),
                 jfaults.FaultInjector(jfaults.FaultPlan(**CHAOS)),
                 faults.FaultInjector(faults.FaultPlan(**CHAOS)))


SCENARIOS = ["static", "adaptive", "chaos"]


def _without(report, *keys):
    return {k: v for k, v in report.items() if k not in keys}


@pytest.mark.parametrize("name", SCENARIOS)
def test_report_equals_the_reference(request, name):
    run = request.getfixturevalue(name)
    ref, got = run["ref"], run["got"]
    # wall_s_real: the host's wall clock, the one nondeterministic field;
    # served: the port's addition (tokens and decode groups), compared
    # against the reference harness's sessions below
    assert set(got) - set(ref) == {"served"}
    assert _without(got, "wall_s_real", "served") == \
        _without(ref, "wall_s_real")
    assert got["cv_waits"] == 0 and got["sessions"]["failed"] == 0
    s = got["sessions"]
    assert s["arrived"] == s["admitted"] + s["rejected"] > 0


@pytest.mark.parametrize("name", SCENARIOS)
def test_served_tokens_equal_the_reference(request, name):
    run = request.getfixturevalue(name)
    got = run["got"]["served"]
    assert got["tokens"] == run["ref_tokens"]
    assert sum(map(len, got["tokens"].values())) == run["got"]["tokens_out"]
    assert sum(got["decode_groups"].values()) >= run["got"]["flushes"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_trace_file_equals_the_reference(request, name):
    run = request.getfixturevalue(name)
    assert run["got_trace"] == run["ref_trace"]
    assert run["got"]["trace_events"] > 0


def test_qos_ladder_reaches_the_4bit_rung_in_mixed_flushes(adaptive):
    got = adaptive["got"]
    assert got["qos"]["switches"] > 0
    rungs = {tuple(kb) for kbs in got["trace"]["k_bits"].values()
             for kb in kbs}
    assert (4, 4) in rungs and len(rungs) > 2
    assert got["served"]["mixed_meta_flushes"] > 0
    assert set(got["served"]["decode_groups"]) == {"sparse_quant"}


def test_chaos_recovers_through_the_arq(chaos):
    fc = chaos["got"]["fault_counters"]
    assert fc["replays"] > 0 and fc["reconnects"] > 0
    assert fc["server_faults_detected"] + fc["client_faults_detected"] > 0
    assert chaos["got"]["sessions"]["completed"] > 0


def test_host_codec_gives_the_same_report(weights, static):
    """`device_encode=False` frames the payload with the host codec: the
    frames are byte-identical, so is the report."""
    _, cfg, _, tp = weights
    got = lg.run_loadgen(cfg, _mini(lg, 3, device_encode=False), params=tp,
                         device="cpu", trace_path=None)
    want = static["got"]
    assert _without(got, "wall_s_real", "trace_events") == \
        _without(want, "wall_s_real", "trace_events")


def test_serve_cli_runs_the_loadgen(tmp_path, capsys):
    path = tmp_path / "t.json"
    rep = serve.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                      "--loadgen", "--qos", "--duration", "1", "--trace",
                      str(path)])
    out = capsys.readouterr().out
    assert "loadgen:" in out and "SLO " in out and "qos: ladder" in out
    assert rep["trace_events"] > 0 and path.stat().st_size > 0
    assert rep["sessions"]["failed"] == 0


# -- the pieces, against the reference ---------------------------------------

def test_arrivals_equal_the_reference():
    for proc in ("poisson", "mmpp"):
        kw = dict(process=proc, rate=5.0, burst_rate=50.0, mean_calm_s=0.5,
                  mean_burst_s=0.5)
        a = jlg._Arrivals(jlg.ArrivalSpec(**kw), 42)
        b = lg._Arrivals(lg.ArrivalSpec(**kw), 42)
        ta = tb = 0.0
        for _ in range(300):
            ta, tb = a.next_after(ta), b.next_after(tb)
            assert ta == tb
        assert a.state_path == b.state_path


@pytest.mark.parametrize("seed", range(4))
def test_qos_controller_trajectory_equals_the_reference(seed):
    rng = random.Random(seed)
    kw = dict(k=32, d=64, bits=8, k_floor=4, bits_floor=4, high_depth=6,
              low_depth=1, deadline_s=0.05, patience=3, cooldown=seed % 3,
              sustain=4)
    ref = jqos.QoSController(jqos.QoSSpec(**kw))
    got = qos.QoSController(qos.QoSSpec(**kw))
    assert got.levels == ref.levels == qos.QoSSpec(**kw).ladder()
    for _ in range(300):
        depth, lat = rng.randint(0, 9), rng.expovariate(1 / 0.03)
        ref.observe(depth, lat)
        got.observe(depth, lat)
        assert (got.level, got.healthy, got.cool, got.switches) == \
            (ref.level, ref.healthy, ref.cool, ref.switches)
        assert got.compressor_spec() == ref.compressor_spec()
    assert got.switches > 0
    st, rs = got.state(), ref.state()
    assert st.keys() == rs.keys()
    assert all(np.array_equal(st[k], rs[k], equal_nan=True) for k in st)


@pytest.mark.parametrize("k,d,bits,k_floor,bits_floor", [
    (32, 64, 8, 4, 4), (8, 64, 0, 8, 0), (8, 64, 4, 4, 4),
    (64, 4096, 8, 8, 4)])
def test_qos_ladder_equals_the_reference(k, d, bits, k_floor, bits_floor):
    kw = dict(k=k, d=d, bits=bits, k_floor=k_floor, bits_floor=bits_floor)
    assert qos.QoSSpec(**kw).ladder() == jqos.QoSSpec(**kw).ladder()
    for kb in qos.QoSSpec(**kw).ladder():
        assert qos.compressor_spec(*kb) == jqos.compressor_spec(*kb)


@pytest.mark.parametrize("lat,reject,depth", [
    ({"n": 100, "p50_ms": 5.0, "p99_ms": 10.0}, 0.05, 4),
    ({"n": 0, "p50_ms": float("nan"), "p99_ms": float("nan")}, 0.0, 0),
    ({"n": 3, "p50_ms": 1.0, "p99_ms": 300.0}, 0.5, 1)])

def test_evaluate_slo_equals_the_reference(lat, reject, depth):
    kw = dict(p99_ms=20.0, p50_ms=4.0, max_reject_frac=0.1, max_queue_depth=3)
    got = lg.evaluate_slo(lg.SLOSpec(**kw), lat, reject, depth)
    assert got == jlg.evaluate_slo(jlg.SLOSpec(**kw), lat, reject, depth)


def test_queue_full_raises_and_preserves_backlog():
    vc = VirtualClock()
    q = BatchingQueue(max_batch=4, max_wait=0.01, max_depth=8, clock=vc)
    for i in range(8):
        q.put(i)
    with pytest.raises(QueueFull):
        q.put(8)
    assert len(q) == 8
    assert q.get_batch(idle_timeout=0.0) == [0, 1, 2, 3]
    q.put(8)
    assert vc.waits == 0


def test_next_flush_at_drives_waitless_flushes():
    vc = VirtualClock(start=100.0)
    q = BatchingQueue(max_batch=3, max_wait=0.02, clock=vc)
    assert q.next_flush_at() is None
    q.put("a")
    assert q.next_flush_at() == pytest.approx(100.02)
    vc.advance(0.005)
    q.put("b")
    assert q.next_flush_at() == pytest.approx(100.02)
    q.put("c")
    assert q.next_flush_at() == vc.monotonic()
    assert q.get_batch(idle_timeout=0.0) == ["a", "b", "c"]
    q.put("d")
    vc.advance_to(q.next_flush_at())
    assert q.get_batch(idle_timeout=0.0) == ["d"]
    assert q.get_batch(idle_timeout=0.0) == []
    assert vc.waits == 0


def test_virtual_clock_waits_advance_instead_of_sleeping():
    vc = VirtualClock()
    q = BatchingQueue(max_batch=4, max_wait=0.01, clock=vc)
    assert q.get_batch(idle_timeout=0.5) == []      # idle tick: one wait
    assert vc.waits == 1 and vc.monotonic() == pytest.approx(0.5)
    q.put("x")
    assert q.get_batch() == ["x"]                   # waits out max_wait
    assert vc.waits == 2 and vc.monotonic() == pytest.approx(0.51)
    with pytest.raises(AssertionError):
        vc.advance(-1.0)


def test_run_loadgen_defaults_to_the_card(monkeypatch):
    """No `device`: the card; without CUDA that raises instead of falling
    back to the CPU, through the CLI too."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get("yi-6b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lg.run_loadgen(cfg, _mini(lg, 3, duration_s=0.2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--loadgen", "--duration", "0.2"])
