"""Port parity of federated training's instruments: the registry counters,
histograms and spans of `run_fedtrain` against the reference's, on the CPU.

Each run counts into a registry of its own (the process default stays
untouched), the training server pops every enqueue stamp it takes (one
`queue_wait_ms` sample per frame up), replies and re-acks go through the
down counters, and on a clean wire every counter series equals the
reference's `run_fedtrain(...)["metrics"]` (histograms by sample count:
their values are host times).
"""
import threading

import numpy as np
import pytest
import torch

from repro.data.synthetic import ManyClassDataset as JDataset
from repro.fedtrain import run_fedtrain as jrun_fedtrain
from repro.split import tabular as jtab
from repro_torch.core import compressors as C, wire
from repro_torch.core.payload import to_host
from repro_torch.data.synthetic import ManyClassDataset
from repro_torch.fedtrain import AsyncPolicy, TrainingServer, run_fedtrain
from repro_torch.fedtrain import engine as fed_engine
from repro_torch.obs import trace
from repro_torch.obs.registry import DEFAULT_REGISTRY, MetricsRegistry
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.transport import channel_pair
from repro_torch.split import tabular


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread each, so test processes running side by side do
    not oversubscribe the cores; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dataset(mod=None):
    return (mod or ManyClassDataset)(n_classes=10, in_dim=16, n_train=512,
                                     n_test=256, noise=0.3, seed=0)


def _spec(method="randtopk", mod=tabular, **kw):
    kw.setdefault("k", 3)
    return mod.SplitSpec(in_dim=16, hidden=32, cut_dim=32, n_classes=10,
                         method=method, **kw)


def _run(spec=None, **kw):
    kw.setdefault("n_clients", 1)
    return run_fedtrain(spec or _spec(), _dataset(), epochs=1, batch=64,
                        seed=0, device="cpu", **kw)


def _series(snap, kind):
    """{(metric, labels): value} of every `kind` series of a snapshot;
    a histogram's value is its sample count."""
    return {(name, tuple(sorted(s["labels"].items()))):
            (s["count"] if kind == "histogram" else s["value"])
            for name, m in snap.items() if m["kind"] == kind
            for s in m["series"]}


def _val(res, name, **labels):
    for s in res["metrics"][name]["series"]:
        if s["labels"] == labels:
            return s.get("value", s.get("count"))
    raise KeyError((name, labels))


@pytest.fixture
def servers(monkeypatch):
    """Every TrainingServer a run builds, kept for inspection."""
    made = []

    class Kept(TrainingServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(fed_engine, "TrainingServer", Kept)
    return made


def test_a_run_leaves_the_default_registry_untouched():
    before = DEFAULT_REGISTRY.snapshot()
    _run()
    assert DEFAULT_REGISTRY.snapshot() == before


@pytest.mark.parametrize("n_clients", [1, 2])
def test_the_server_pops_every_enqueue_stamp(servers, n_clients):
    res = _run(n_clients=n_clients)
    (server,) = servers
    assert server._enq_ts == {}
    frames_up = sum(s["frames_up"] for s in res["server_stats"])
    assert frames_up == n_clients * res["steps"]
    assert _val(res, "queue_wait_ms") == frames_up


@pytest.mark.parametrize("n_clients", [1, 2])
def test_counters_reconcile_with_the_session_stats(n_clients):
    """Per party and direction, the registry counts what the parties'
    `SessionStats` count."""
    res = _run(n_clients=n_clients)
    for party, stats in (("client", res["client_stats"]),
                         ("server", res["server_stats"])):
        def total(field, stats=stats):
            return sum(s[field] for s in stats)

        assert _val(res, "frames_total", party=party,
                    direction="up") == total("frames_up")
        assert _val(res, "payload_bytes_total", party=party,
                    direction="up") == total("payload_bytes_up")
        assert _val(res, "framing_bytes_total", party=party,
                    direction="up") == total("header_bytes_up")
        assert _val(res, "frames_total", party=party,
                    direction="down") == total("frames_down")
        assert _val(res, "wire_bytes_total", party=party,
                    direction="down") == total("bytes_down")
    assert _val(res, "frames_total", party="server", direction="down") \
        == _val(res, "frames_total", party="client", direction="down") \
        == n_clients * res["steps"]
    assert _val(res, "queue_wait_ms") == n_clients * res["steps"]
    assert _val(res, "duplicates_total", party="server") == 0


@pytest.mark.parametrize("method", ["randtopk", "quant", "none"])
def test_counter_series_equal_the_references(method):
    kw = {"quant_bits": 4} if method == "quant" else {}
    want = jrun_fedtrain(_spec(method, jtab, **kw), _dataset(JDataset),
                         n_clients=1, epochs=1, batch=64, seed=0)
    got = _run(_spec(method, **kw))
    assert set(got["metrics"]) == set(want["metrics"])
    for kind in ("counter", "histogram"):
        assert _series(got["metrics"], kind) == \
            _series(want["metrics"], kind), kind
    assert got["fault_counters"] == want["fault_counters"]


def test_tracer_records_one_encode_span_a_sync_step():
    """`client.encode` once per sync step (local steps send nothing),
    `server.queue_wait` once per fresh frame."""
    tracer = trace.Tracer()
    res = _run(n_clients=2, tracer=tracer,
               policy=AsyncPolicy(local_steps=2, warmup_sync=1))
    events = tracer.events()
    syncs = [[s for s, _ in x] for x in res["losses"]]
    assert sum(map(len, syncs)) < 2 * res["steps"]
    for cid, steps in enumerate(syncs):
        enc = sorted(e["args"]["step"] for e in events
                     if e["name"] == trace.SPAN_CLIENT_ENCODE
                     and e["tid"] == trace.session_tid(cid))
        assert enc == steps
        waits = sorted(e["args"]["seq"] for e in events
                       if e["name"] == trace.SPAN_QUEUE_WAIT
                       and e["args"]["sid"] == cid)
        assert waits == steps
    assert all(e["dur"] >= 0 for e in events if e.get("ph") == "X")


def test_two_runs_count_into_registries_of_their_own():
    r1, r2 = _run(), _run()
    assert _series(r1["metrics"], "counter") == \
        _series(r2["metrics"], "counter")
    assert _val(r2, "frames_total", party="client", direction="up") == 8


def _server_and_frame(registry):
    spec = _spec("topk")
    _, top = tabular.init_parties(torch.Generator().manual_seed(0), spec)
    srv = TrainingServer(spec, top, adamw_init(top), device="cpu",
                         max_batch=1, max_wait=0.0, registry=registry)
    srv.labels_for = lambda sid, seq: np.arange(4, dtype=np.int32)
    srv.expected_sessions = 1
    cep, sep = channel_pair()
    srv.attach(sep)
    x = torch.from_numpy(np.random.RandomState(0).rand(4, 32).astype(
        np.float32))
    frame = wire.encode_payload_frame(0, 0, to_host(C.TopK(k=3).encode(x)))
    return srv, cep, frame


def test_a_reack_counts_as_a_frame_down_and_a_duplicate():
    reg = MetricsRegistry()
    srv, cep, frame = _server_and_frame(reg)
    loop = threading.Thread(target=srv.train_loop, daemon=True)
    loop.start()
    cep.send(frame)
    first = cep.recv_frame(timeout=10)
    cep.send(frame)
    again = cep.recv_frame(timeout=10)
    cep.send(wire.encode_close_frame(0))
    loop.join(timeout=10)
    assert not loop.is_alive()
    snap = reg.snapshot()
    down = _series(snap, "counter")
    assert down[("frames_total", (("direction", "down"),
                                  ("party", "server")))] == 2
    assert down[("wire_bytes_total", (("direction", "down"),
                                      ("party", "server")))] == \
        first.nbytes + again.nbytes
    assert down[("duplicates_total", (("party", "server"),))] == 1
    assert _series(snap, "histogram")[("queue_wait_ms", ())] == 2
    assert srv._enq_ts == {}


def test_a_refused_enqueue_takes_its_stamp_back():
    srv, cep, frame = _server_and_frame(MetricsRegistry())
    srv.shutdown()
    sess = srv._session_for(0, cep)
    with pytest.raises(RuntimeError):
        srv._enqueue(sess, wire.decode_frame(frame)[0])
    assert srv._enq_ts == {}
