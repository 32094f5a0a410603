"""The server's slot lifecycle: admission, closed-slot reclaim, LRU
eviction of idle sessions to the host and re-admission, against the JAX
package's `StreamingServer`.

  * unit: a full arena evicts the least recently active idle session; the
    serve loop fetches its row to the host before the reset, and a later
    frame restores it exactly (ports of `tests/test_arena.py`'s slot
    tests, plus the fetch/restore round trip and the FIFO guard);
  * deterministic contention: one single-threaded loop feeds the same
    frame bytes to the reference's server and the port's through `pump`,
    6 sessions over 2 slots — equal tokens, and equal eviction and
    readmission counts;
  * threaded `run_streaming` at capacity 2 gives the tokens of capacity n
    and the reference's. A threaded run's eviction counts depend on how
    the threads interleave, so only that they are positive is asserted
    there; their equality with the reference is held by the loop above.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import wire as jwire
from repro.core.payload import Payload as JPayload
from repro.core.payload import PayloadMeta as JMeta
from repro.models import transformer as jtr
from repro.models.config import Runtime as JRuntime
from repro.models.config import SplitConfig as JSplit
from repro.obs.registry import MetricsRegistry as JRegistry
from repro.runtime import engine as jengine
from repro.runtime import steps as jsteps
from repro.runtime import transport as jtransport
from repro.runtime.server import StreamingServer as JServer
from repro.testing.clock import VirtualClock as JClock
from repro_torch import configs
from repro_torch.models import transformer
from repro_torch.models.config import SplitConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.runtime import engine, steps, transport
from repro_torch.runtime.arena import SlotArena
from repro_torch.runtime.server import _EVICTING, StreamingServer
from repro_torch.testing.clock import VirtualClock

SPLIT = dict(cut_layer=1, compressor="randtopk", k=16)
MAX_LEN = 8


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


@pytest.fixture(scope="module")
def weights():
    jcfg = jconfigs.get("yi-6b", smoke=True).with_(split=JSplit(**SPLIT))
    cfg = configs.get("yi-6b", smoke=True).with_(split=SplitConfig(**SPLIT))
    jp = jtr.init_model(jax.random.key(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


def _server(cfg, params, capacity, max_batch=2, clock=None, **kw):
    return StreamingServer(
        params, steps.make_arena_top_step(cfg, 1),
        lambda rows=1: transformer.init_cache(cfg, rows, MAX_LEN),
        device="cpu", max_batch=max_batch, capacity=capacity,
        x_shape=(1, 1, cfg.d_model), registry=MetricsRegistry(),
        **({} if clock is None else {"clock": clock}), **kw)


def _ref_server(jcfg, jp, capacity, max_batch=2, clock=None):
    rt = JRuntime(mesh=None, training=False)
    return JServer(
        jp, jsteps.make_arena_top_step(jcfg, rt, 1),
        lambda: jtr.init_cache(jp, jcfg, rt, 1, MAX_LEN),
        max_batch=max_batch, capacity=capacity,
        x_shape=(1, 1, jcfg.d_model), clock=clock, registry=JRegistry())


# -- unit: the slot lifecycle -------------------------------------------------

def test_slot_reuse_after_close_resets_state(weights):
    _, cfg, _, tp = weights
    server = _server(cfg, tp, capacity=1)
    s1 = server._session_for(11, endpoint=None)
    assert s1.slot == 0
    server.arena.cache["pos"][0] = 5
    s1.closed = True
    s2 = server._session_for(22, endpoint=None)
    assert s2.slot == 0 and s1.slot == -1
    assert ("reset", None, 0) in server._arena_ops
    server._process([])
    assert server._arena_ops == []
    assert int(server.arena.cache["pos"][0]) == 0


def test_arena_full_raises_at_admission(weights):
    _, cfg, _, tp = weights
    server = _server(cfg, tp, capacity=2, evict_idle=False,
                     admit_timeout=0.0)
    server._session_for(1, endpoint=None)
    server._session_for(2, endpoint=None)
    with pytest.raises(RuntimeError, match="arena full"):
        server._session_for(3, endpoint=None)


def test_full_arena_under_a_virtual_clock_raises_without_sleeping(weights):
    """Every slot holds a frame in flight: no slot is evictable, and the
    admission wait runs on the injected clock — a virtual clock advances
    by the timeout instead of blocking, then the admission raises."""
    _, cfg, _, tp = weights
    vc = VirtualClock()
    server = _server(cfg, tp, capacity=2, clock=vc, admit_timeout=3.0)
    for sid in (1, 2):
        server._before_enqueue(server._session_for(sid, endpoint=None))
    with pytest.raises(RuntimeError, match="arena full"):
        server._session_for(3, endpoint=None)
    assert vc.waits == 1 and vc.monotonic() == pytest.approx(3.0)


def test_full_arena_evicts_lru_idle_session(weights):
    """A full arena LRU-evicts the idlest session's row to the host (the
    serve loop fetches it before the row is reused) and a later frame of
    the evicted session re-admits it with its exact pre-eviction state."""
    _, cfg, _, tp = weights
    server = _server(cfg, tp, capacity=2)
    reg = server.registry
    s1 = server._session_for(1, endpoint=None)
    s2 = server._session_for(2, endpoint=None)
    s1.last_active, s2.last_active = 1.0, 2.0           # s1 is the LRU
    server.arena.cache["pos"][0] = 5
    server.arena.cache["kv"]["k"][0] += 1.5
    s3 = server._session_for(3, endpoint=None)
    assert s3.slot == 0 and s1.slot == -1               # s1 evicted
    assert s1.host_state is _EVICTING                   # until the fetch
    server._process([])                 # serve loop: fetch -> reset
    assert int(s1.host_state["pos"]) == 5
    assert bool((s1.host_state["kv"]["k"] == 1.5).all())
    assert int(server.arena.cache["pos"][0]) == 0       # row reset
    assert bool((server.arena.cache["kv"]["k"][0] == 0).all())
    assert reg.counter("slot_evictions_total").value == 1
    s2.closed = True
    with server._lock:
        server._ensure_resident(s1)
    assert s1.slot >= 0
    server._process([])                 # serve loop: reclaim, restore
    assert s1.host_state is None
    assert int(server.arena.cache["pos"][s1.slot]) == 5
    assert bool((server.arena.cache["kv"]["k"][s1.slot] == 1.5).all())
    assert reg.counter("slot_readmissions_total").value == 1
    assert reg.counter("slot_admits_total").value == 3


def test_restore_before_its_fetch_raises(weights):
    _, cfg, _, tp = weights
    server = _server(cfg, tp, capacity=2)
    s1 = server._session_for(1, endpoint=None)
    s1.host_state = _EVICTING
    with pytest.raises(RuntimeError, match="before its eviction's fetch"):
        server._apply_arena_ops([("restore", s1, 1)])


def test_slot_churn_cycles_and_resets_every_row(weights):
    """Admit/close/admit N >> capacity: freed slots cycle through every
    row, each reused row is reset when reused, and a live session's row
    is never reset."""
    _, cfg, _, tp = weights
    cap = 3
    server = _server(cfg, tp, capacity=cap, evict_idle=False)
    pinned = server._session_for(1000, endpoint=None)
    server._process([])
    server.arena.cache["pos"][pinned.slot] = 99
    issued = []
    for i in range(10):
        sess = server._session_for(i, endpoint=None)
        server._process([])
        assert int(server.arena.cache["pos"][sess.slot]) == 0
        issued.append(sess.slot)
        server.arena.cache["pos"][sess.slot] = i + 10
        sess.closed = True
    free_rows = sorted(set(range(cap)) - {pinned.slot})
    for w in range(len(issued) - len(free_rows) + 1):
        assert sorted(set(issued[w:w + len(free_rows)])) == free_rows
    assert int(server.arena.cache["pos"][pinned.slot]) == 99


def test_arena_fetch_restore_round_trip(weights):
    """`fetch_slot` copies a row to new host tensors (a later reset of the
    row leaves them intact); `restore_slot` writes them into any row."""
    _, cfg, _, _ = weights
    arena = SlotArena(lambda rows=1: transformer.init_cache(cfg, rows, 4),
                      3, (1, 1, cfg.d_model), torch.float32, "cpu")
    g = torch.Generator().manual_seed(0)
    arena.cache["pos"][1] = 3
    arena.cache["kv"]["k"][1].normal_(generator=g)
    want = arena.cache["kv"]["k"][1].clone()
    state = arena.fetch_slot(1)
    assert state["kv"]["k"].data_ptr() != arena.cache["kv"]["k"].data_ptr()
    arena.reset_slot(1)
    assert int(arena.cache["pos"][1]) == 0
    assert torch.equal(state["kv"]["k"], want)
    arena.restore_slot(2, state)
    assert int(arena.cache["pos"][2]) == 3
    assert torch.equal(arena.cache["kv"]["k"][2], want)
    assert torch.equal(arena.slot_cache(2)["kv"]["v"],
                       arena.cache["kv"]["v"][2])
    assert arena.wire_row(2) == 2


# -- deterministic contention against the reference --------------------------

N_SESSIONS, ROUNDS, K = 6, 5, 16


def _frame_bytes(d):
    """One sparse payload frame per (round, session), made with numpy."""
    rng = np.random.default_rng(7)
    out = []
    for r in range(ROUNDS):
        row = []
        for sid in range(N_SESSIONS):
            idx = np.sort(rng.choice(d, K, replace=False)).astype(np.uint16)
            vals = rng.normal(size=K).astype(np.float32) * 4
            p = JPayload(meta=JMeta("sparse", d=d, k=K),
                         values=vals.reshape(1, 1, K),
                         indices=idx.reshape(1, 1, K))
            row.append(jwire.encode_payload_frame(sid, r, p))
        out.append(row)
    return out


def _drive(server, channel_pair, frames):
    """Every round, the sessions in pairs: each pair's frames pumped, then
    one flush. Returns (tokens per session, evictions, readmissions)."""
    conns = [channel_pair() for _ in range(N_SESSIONS)]
    seen = [None] * N_SESSIONS
    tokens = [[] for _ in range(N_SESSIONS)]
    for row in frames:
        for pair in ((0, 1), (2, 3), (4, 5)):
            for sid in pair:
                cep, sep = conns[sid]
                cep.send(row[sid])
                status, seen[sid] = server.pump(sep, seen[sid])
                assert status == "open"
            server._process(server.queue.get_batch(idle_timeout=0.0))
            for sid in pair:
                reply = conns[sid][0].recv_frame(timeout=0.0)
                tokens[sid].append(int(reply.tokens[0]))
    for sid, (cep, sep) in enumerate(conns):
        cep.send(jwire.encode_close_frame(sid))
        assert server.pump(sep, seen[sid])[0] == "closed"
    server._process([])
    reg = server.registry
    return (tokens, reg.counter("slot_evictions_total").value,
            reg.counter("slot_readmissions_total").value)


def test_contended_pump_equals_the_reference(weights):
    jcfg, cfg, jp, tp = weights
    frames = _frame_bytes(cfg.d_model)
    ref = _drive(_ref_server(jcfg, jp, 2, clock=JClock()),
                 jtransport.channel_pair, frames)
    got = _drive(_server(cfg, tp, 2, clock=VirtualClock()),
                 transport.channel_pair, frames)
    free = _drive(_server(cfg, tp, N_SESSIONS, clock=VirtualClock()),
                  transport.channel_pair, frames)
    assert got == ref
    assert got[1] > 0 and got[2] > 0
    assert free[0] == got[0] and free[1:] == (0, 0)


# -- threaded run_streaming ---------------------------------------------------

def test_contended_run_streaming_equals_uncontended_and_reference(weights):
    jcfg, cfg, jp, tp = weights
    kw = dict(n_clients=6, prompt_len=3, gen=5, max_batch=4, seed=0)
    prompts = np.asarray(jax.random.randint(
        jax.random.key(1), (6, 3), 0, jcfg.vocab))
    ref = jengine.run_streaming(jcfg, params=jp, capacity=2, **kw)
    free = engine.run_streaming(cfg, params=tp, prompts=prompts,
                                device="cpu", **kw)
    got = engine.run_streaming(cfg, params=tp, prompts=prompts,
                               device="cpu", capacity=2, **kw)

    np.testing.assert_array_equal(got["tokens"], free["tokens"])
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])
    m = got["metrics"]
    evictions = m["slot_evictions_total"]["series"][0]["value"]
    readmissions = m["slot_readmissions_total"]["series"][0]["value"]
    assert evictions > 0 and readmissions > 0
    assert readmissions <= evictions
    assert m["slot_admits_total"]["series"][0]["value"] == 6
    assert "slot_evictions_total" not in free["metrics"]
