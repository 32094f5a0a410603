"""Port parity of the observability layer and the streaming quantiles: the
same sequence of operations gives the JAX package's registry snapshot,
Prometheus text, Chrome-trace bytes and validator verdicts exactly; the
P² estimator and `LatencyStats` equal the reference's on the same samples;
`HOST_DENSIFY_COUNT` is registry-backed with `reset()`/`watch()`; and
`run_streaming` / `launch/serve --trace` carry the reference's spans and a
per-run metrics snapshot that agrees with the session byte accounting.
"""
from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

import repro.obs.export as jexport
import repro.obs.registry as jregistry
import repro.obs.trace as jtrace
import repro.runtime.metrics as jmetrics
import repro.testing.clock as jclock
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models.config import SplitConfig
from repro_torch.obs import export, registry, trace
from repro_torch.obs.registry import DEFAULT_REGISTRY
from repro_torch.runtime import engine, metrics
from repro_torch.split import protocol
from repro_torch.testing import clock

BOTH = [(jregistry, jtrace, jexport, jclock, jmetrics),
        (registry, trace, export, clock, metrics)]


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


def _registry_ops(reg_mod, seed):
    """A seeded mix of counter, gauge and histogram operations."""
    rng = np.random.default_rng(seed)
    reg = reg_mod.MetricsRegistry()
    parties = ("client", "server")
    for i in range(200):
        r = rng.integers(0, 5)
        party = parties[int(rng.integers(0, 2))]
        if r == 0:
            reg.counter("frames_total", party=party, direction="up").inc()
        elif r == 1:
            reg.counter("payload_bytes_total", party=party).inc(
                int(rng.integers(0, 400)))
        elif r == 2:
            reg.gauge("queue_depth").set(int(rng.integers(0, 30)))
        elif r == 3:
            reg.histogram("token_latency_ms").observe(
                float(rng.exponential(12.0)))
        else:
            reg.histogram("flush_fill", qs=(0.5, 0.9)).observe(
                int(rng.integers(1, 9)))
        if i % 50 == 0:
            reg.gauge("qos_level", sid=i).inc()
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_and_text_equal_the_reference(seed):
    ref, got = (_registry_ops(m[0], seed) for m in BOTH)
    assert got.snapshot() == ref.snapshot()
    assert got.render_text() == ref.render_text()


def test_registry_rejects_kind_forks_and_negative_counts():
    reg = registry.MetricsRegistry()
    reg.counter("x").inc(2.5)
    with pytest.raises(TypeError):
        reg.gauge("x")
    with pytest.raises(ValueError):
        reg.counter("x").inc(-1)
    assert reg.counter("x") is reg.counter("x")
    assert reg.snapshot()["x"]["series"][0]["value"] == 2.5


def _trace_ops(tr_mod, clk_mod):
    vc = clk_mod.VirtualClock()
    tr = tr_mod.Tracer(clock=vc)
    tr.name_track(tr_mod.SERVE_TID, "serve loop")
    tr.name_track(tr_mod.SERVE_TID, "renamed")
    for sid in range(3):
        tr.name_track(tr_mod.session_tid(sid), f"session {sid}")
        with tr.span(tr_mod.SPAN_CLIENT_ENCODE, tid=tr_mod.session_tid(sid),
                     step=sid):
            vc.advance(0.0011 * (sid + 1))
        tr.complete(tr_mod.SPAN_WIRE_SEND, vc.monotonic(),
                    vc.monotonic() + 1e-4 / 3, tid=tr_mod.session_tid(sid),
                    nbytes=190 + sid)
        tr.instant(tr_mod.EVT_QOS_TRANSITION, tid=tr_mod.session_tid(sid),
                   frm=0, to=1, latency_ms=1 / 3)
    tr.complete("clamped", 2.0, 1.0)
    tr.complete(tr_mod.SPAN_STEP, 0.1234567891, 0.2345678912,
                tid=tr_mod.SERVE_TID, n=3)
    return tr


def test_chrome_trace_bytes_equal_the_reference():
    (jt, jc, je), (pt, pc, pe) = [(m[1], m[3], m[2]) for m in BOTH]
    ref, got = _trace_ops(jt, jc), _trace_ops(pt, pc)
    assert pe.dump_json(got) == je.dump_json(ref)
    assert pe.chrome_trace(got) == je.chrome_trace(ref)
    obj = pe.chrome_trace(got)
    assert pe.validate_chrome_trace(obj) == []
    assert pe.check_span_nesting(obj["traceEvents"]) == []
    assert len(got) == len(ref)


def test_write_trace_writes_dump_json(tmp_path):
    tr = _trace_ops(trace, clock)
    n = export.write_trace(tr, tmp_path / "t.json")
    assert n == len(tr.events())
    assert (tmp_path / "t.json").read_text() == export.dump_json(tr)


BAD_TRACES = [
    {},
    {"traceEvents": "nope"},
    {"traceEvents": [
        {"ph": "X", "ts": 0, "pid": 0, "tid": 0},
        {"name": "z", "ph": "Z", "ts": 0, "pid": 0, "tid": 0},
        {"name": "n", "ph": "X", "ts": -1, "pid": 0, "tid": 0, "dur": -2},
        {"name": "i", "ph": "i", "ts": 0, "pid": 0, "tid": 0},
        {"name": "m", "ph": "M", "ts": 0, "pid": 0, "tid": 0}]},
]

NESTING = [
    [{"ph": "X", "pid": 0, "tid": 0, "ts": 0, "dur": 10, "name": "a"},
     {"ph": "X", "pid": 0, "tid": 0, "ts": 5, "dur": 10, "name": "b"}],
    [{"ph": "X", "pid": 0, "tid": 0, "ts": 14_386_434_149.752,
      "dur": 1184.044, "name": "step"},
     {"ph": "X", "pid": 0, "tid": 0, "ts": 14_386_434_149.752 + 1184.0440006,
      "dur": 92.883, "name": "reply"}],
    [{"ph": "X", "pid": 0, "tid": 0, "ts": 0, "dur": 10, "name": "a"},
     {"ph": "X", "pid": 0, "tid": 1, "ts": 5, "dur": 10, "name": "b"}],
]


@pytest.mark.parametrize("case", range(len(BAD_TRACES)))
def test_trace_validator_verdicts_equal_the_reference(case):
    obj = BAD_TRACES[case]
    got = export.validate_chrome_trace(obj)
    assert got == jexport.validate_chrome_trace(obj) and got != []


@pytest.mark.parametrize("case", range(len(NESTING)))
def test_span_nesting_verdicts_equal_the_reference(case):
    events = NESTING[case]
    assert export.check_span_nesting(events) == \
        jexport.check_span_nesting(events)
    assert bool(export.check_span_nesting(events)) == (case == 0)


def test_null_tracer_is_inert():
    with trace.NULL_TRACER.span("x"):
        pass
    trace.NULL_TRACER.instant("y")
    trace.NULL_TRACER.complete("z", 0.0, 1.0)
    assert trace.NULL_TRACER.events() == [] and not trace.NULL_TRACER.enabled


# -- streaming quantiles ------------------------------------------------------

def _samples(name, n, seed=0):
    rng = np.random.default_rng(seed)
    if name == "bimodal":
        xs = np.concatenate([rng.normal(0.0, 1.0, n // 2),
                             rng.normal(8.0, 0.25, n - n // 2)])
        return rng.permutation(xs)
    if name == "heavy_tail":
        return rng.pareto(1.5, n) + 1.0
    if name == "constant":
        return np.full(n, 7.0)
    return rng.exponential(0.02, n)


DISTS = [("bimodal", 4000), ("heavy_tail", 2000), ("constant", 300),
         ("exponential", 3), ("exponential", 5), ("exponential", 401)]


@pytest.mark.parametrize("name,n", DISTS)
@pytest.mark.parametrize("q", [0.5, 0.95, 0.99])
def test_p2_quantile_equals_the_reference(name, n, q):
    xs = _samples(name, n)
    ref, got = jmetrics.P2Quantile(q), metrics.P2Quantile(q)
    for x in xs:
        ref.add(x)
        got.add(x)
        assert got.value() == ref.value() or (
            math.isnan(got.value()) and math.isnan(ref.value()))
    assert got.count == ref.count == n


@pytest.mark.parametrize("name,n", DISTS)
@pytest.mark.parametrize("max_exact", [None, 100])
def test_latency_stats_report_equals_the_reference(name, n, max_exact):
    xs = np.abs(_samples(name, n, seed=1)) + 1e-3
    ref = jmetrics.LatencyStats(max_exact_samples=max_exact)
    got = metrics.LatencyStats(max_exact_samples=max_exact)
    for x in xs:
        ref.add(float(x))
        got.add(float(x))
    assert got.report() == ref.report()
    assert got.streaming_only == ref.streaming_only
    assert len(got) == len(ref) == n


@pytest.mark.parametrize("groups", [[[0.01, 0.02], [0.03]], [], [[], []],
                                    [[0.5], [0.1, 0.2, 0.9, 0.4]]])
def test_merged_percentiles_equal_the_reference(groups):
    got = metrics.merged_percentiles(groups)
    want = jmetrics.merged_percentiles(groups)
    assert set(got) == set(want) == {"p50_ms", "p95_ms", "p99_ms"}
    for key in got:
        assert got[key] == want[key] or (math.isnan(got[key])
                                         and math.isnan(want[key]))


# -- HOST_DENSIFY_COUNT on the registry ---------------------------------------

def test_host_densify_counter_feeds_registry():
    cnt = protocol.HOST_DENSIFY_COUNT
    series = DEFAULT_REGISTRY.counter("host_densify_total")
    cnt.reset()
    base = series.value
    assert cnt.value == 0 and cnt == 0
    cnt.increment()
    cnt.increment()
    assert cnt.value == 2 and int(cnt) == 2
    assert series.value == base + 2
    assert cnt.reset() == 2 and cnt.value == 0
    assert series.value == base + 2            # the series stays monotonic
    with cnt.watch() as w:
        cnt.increment()
    assert w.delta == 1
    assert repr(cnt) == "HostDensifyCounter(1)"
    cnt.reset()


# -- spans and metrics of a served run ----------------------------------------

def _cfg():
    return configs.get("yi-6b", smoke=True).with_(
        split=SplitConfig(cut_layer=1, compressor="randtopk", k=16))


def test_run_streaming_spans_and_metrics_snapshot():
    tracer = trace.Tracer()
    with protocol.HOST_DENSIFY_COUNT.watch() as w:
        res = engine.run_streaming(_cfg(), n_clients=3, prompt_len=3, gen=4,
                                   max_batch=3, max_wait=0.01, seed=0,
                                   device="cpu", tracer=tracer)
    assert w.delta == 0
    names = {e["name"] for e in tracer.events()}
    assert all(s in names for s in trace.LIFECYCLE_SPANS)
    obj = export.chrome_trace(tracer)
    assert export.validate_chrome_trace(obj) == []
    assert export.check_span_nesting(obj["traceEvents"]) == []

    snap = res["metrics"]
    series = {(name, tuple(sorted(s["labels"].items()))): s
              for name in snap for s in snap[name]["series"]}

    def val(name, **labels):
        return series[(name, tuple(sorted(labels.items())))]["value"]

    up_frames = sum(s["frames_up"] for s in res["client_stats"])
    up_payload = sum(s["payload_bytes_up"] for s in res["client_stats"])
    assert val("frames_total", party="client", direction="up") == up_frames
    assert val("frames_total", party="server", direction="up") == up_frames
    assert val("payload_bytes_total", party="client",
               direction="up") == up_payload
    assert val("tokens_total", party="client") == 3 * 4
    assert val("slot_admits_total") == 3
    assert series[("queue_wait_ms", ())]["count"] == up_frames
    assert all(v == 0 for v in res["fault_counters"].values())


def test_run_streaming_registry_isolated_per_run():
    kw = dict(n_clients=2, prompt_len=2, gen=3, max_batch=2, max_wait=0.01,
              device="cpu")
    r1 = engine.run_streaming(_cfg(), **kw)
    r2 = engine.run_streaming(_cfg(), **kw)
    assert r1["metrics"]["frames_total"] == r2["metrics"]["frames_total"]


def test_serve_cli_writes_a_nested_trace(tmp_path, capsys):
    path = tmp_path / "serve.json"
    serve.main(["--smoke", "--device", "cpu", "--clients", "2",
                "--prompt-len", "2", "--gen", "3", "--split", "randtopk",
                "--k", "16", "--trace", str(path)])

    assert f"-> {path}" in capsys.readouterr().out
    obj = json.loads(path.read_text())
    assert export.validate_chrome_trace(obj) == []
    assert export.check_span_nesting(obj["traceEvents"]) == []
    names = {e["name"] for e in obj["traceEvents"]}
    assert all(s in names for s in trace.LIFECYCLE_SPANS)
