"""Port parity of the fault-injection harness and the ARQ recovery it
drives: the port's `FaultyEndpoint` / `FaultInjector` mangle a byte stream
chunk for chunk as the JAX package's do under the same plan (both
directions, every connection of an injector), corruption is always caught
by the CRC, and a chaos `run_streaming` — timeouts, retransmits,
reconnects, dedup — gives the clean run's tokens.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro.testing.faults as jfaults
from repro.core import wire as jwire
from repro.runtime import transport as jtransport
from repro_torch import configs
from repro_torch.core import wire
from repro_torch.models.config import SplitConfig
from repro_torch.runtime import engine, transport
from repro_torch.testing import (DESTRUCTIVE_FAULTS, FaultInjector,
                                 FaultPlan, FaultyEndpoint)
from repro_torch.testing import faults

CHAOS_PLAN = dict(corrupt=0.06, truncate=0.03, drop=0.05, duplicate=0.05,
                  reorder=0.03, rechunk=0.15, max_faults=30)
ARQ = dict(retry_timeout=0.3, max_retries=40)


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


def _frames(w, n=60):
    return [w.encode_token_frame(i % 3, i, [i, 2 * i]) for i in range(n)]


def _drain(ep):
    chunks = []
    while (c := ep.recv_chunk(timeout=0.001)) is not None:
        chunks.append(c)
    return chunks


def _mangled(faults_mod, transport_mod, w, plan_kw, n=60):
    """Frames through one FaultyEndpoint, up (send) and down (recv_chunk);
    returns (chunks the server got, chunks the client read, injected)."""
    plan = faults_mod.FaultPlan(**plan_kw)
    cep, sep = transport_mod.channel_pair()
    fep = faults_mod.FaultyEndpoint(cep, plan)
    for fb in _frames(w, n):
        fep.send(fb)
        sep.send(fb)                        # the down direction, same bytes
    up = _drain(sep)
    down = _drain(fep)
    return up, down, dict(fep.injected)


PLANS = [dict(seed=11, **CHAOS_PLAN), dict(seed=3, **CHAOS_PLAN),
         dict(seed=5, corrupt=0.3, max_faults=1000),
         dict(seed=3, rechunk=0.9), dict(seed=1, drop=0.9, max_faults=7),
         dict(seed=7, reorder=0.4, duplicate=0.2, max_faults=100),
         dict(seed=0)]


def test_wire_frames_are_the_references_bytes():
    assert _frames(wire) == _frames(jwire)


@pytest.mark.parametrize("plan", PLANS, ids=[str(i) for i in range(7)])
def test_faulty_endpoint_equals_the_reference_chunk_for_chunk(plan):
    want = _mangled(jfaults, jtransport, jwire, plan)
    got = _mangled(faults, transport, wire, plan)
    assert got == want
    if plan.get("drop") or plan.get("corrupt"):
        assert sum(got[2].get(f, 0) for f in DESTRUCTIVE_FAULTS) > 0


def test_injector_reseeds_per_connection_as_the_reference():
    """Each connection of an injector draws from its own seeded stream
    (a reconnect never replays the fault stream that killed the last
    connection), with one destructive budget across all of them."""
    outs = []
    for mod, tmod, w in ((jfaults, jtransport, jwire),
                         (faults, transport, wire)):
        inj = mod.FaultInjector(mod.FaultPlan(seed=9, corrupt=0.5, drop=0.1,
                                              max_faults=25))
        per_conn = []
        for cid in (0, 0, 1, 2, 1):
            cep, sep = tmod.channel_pair()
            fep = inj(cid, cep)
            for fb in _frames(w, 30):
                fep.send(fb)
            per_conn.append(_drain(sep))
        outs.append((per_conn, dict(inj.injected()), inj.connections))
    assert outs[0] == outs[1]
    per_conn, injected, conns = outs[1]
    assert conns == 5 and per_conn[0] != per_conn[1]
    assert sum(injected.get(f, 0) for f in DESTRUCTIVE_FAULTS) == 25


def test_corruption_is_always_caught_by_crc():
    """Corrupt-only chaos: every surviving frame is bit-exact, every
    corrupted one raises or stalls — never a wrong token."""
    frames = _frames(wire)
    cep, sep = transport.channel_pair()
    fep = FaultyEndpoint(cep, FaultPlan(seed=5, corrupt=0.3,
                                        max_faults=1000))
    for fb in frames:
        fep.send(fb)
    good, detected, stalled = [], 0, 0
    for c in _drain(sep):
        reader = wire.FrameReader()
        reader.feed(c)
        try:
            decoded = [int(f.seq) for f in reader.frames()]
        except wire.WireError:
            detected += 1
            continue
        if decoded:
            good.extend(decoded)
        else:
            stalled += 1
    assert detected + stalled == fep.injected["corrupt"] >= 5
    assert detected > 0
    assert good == sorted(good)
    assert len(good) == len(frames) - fep.injected["corrupt"]


def test_clean_plan_is_transparent():
    assert not FaultPlan(seed=0).any_destructive()
    assert FaultPlan(drop=0.1).any_destructive()
    up, down, injected = _mangled(faults, transport, wire, dict(seed=0))
    assert up == down == _frames(wire) and not injected


# -- end to end: chaos run_streaming equals the clean run ---------------------

@pytest.fixture(scope="module")
def clean():
    cfg = configs.get("yi-6b", smoke=True).with_(
        split=SplitConfig(cut_layer=1, compressor="randtopk", k=16))
    kw = dict(n_clients=4, prompt_len=3, gen=6, max_batch=4, max_wait=0.02,
              compressor_mix=["identity", "randtopk:k=16"], seed=0,
              device="cpu")
    res = engine.run_streaming(cfg, **kw)
    assert all(v == 0 for v in res["fault_counters"].values())
    return cfg, kw, res


@pytest.mark.parametrize("seed", [3, 21])
def test_streaming_survives_chaos_with_identical_tokens(clean, seed):
    cfg, kw, ref = clean
    inj = FaultInjector(FaultPlan(seed=seed, **CHAOS_PLAN))
    chaos = engine.run_streaming(cfg, wrap_endpoint=inj, **ARQ, **kw)
    fc = chaos["fault_counters"]
    assert sum(inj.injected()[f] for f in DESTRUCTIVE_FAULTS) > 0
    assert fc["replays"] > 0 and fc["reconnects"] > 0
    assert fc["server_faults_detected"] + fc["client_faults_detected"] > 0
    np.testing.assert_array_equal(chaos["tokens"], ref["tokens"])
    for cs in chaos["client_stats"]:
        assert cs["tokens_out"] == kw["gen"]
    snap = chaos["metrics"]
    replays = snap["arq_replays_total"]["series"][0]["value"]
    assert replays >= fc["replays"]         # + error-frame-driven resends
    assert (snap["arq_reconnects_total"]["series"][0]["value"]
            == fc["reconnects"])


def test_streaming_chaos_with_host_codec_and_eviction(clean):
    """The host codec (`device_encode=False`) and a contended arena under
    chaos: replays of frames whose session was evicted re-admit it and
    are re-acked, never re-stepped."""
    cfg, kw, ref = clean
    inj = FaultInjector(FaultPlan(seed=5, **CHAOS_PLAN))
    chaos = engine.run_streaming(cfg, wrap_endpoint=inj, capacity=2,
                                 device_encode=False, **ARQ, **kw)

    np.testing.assert_array_equal(chaos["tokens"], ref["tokens"])
    assert chaos["fault_counters"]["replays"] > 0
    assert chaos["metrics"]["slot_evictions_total"]["series"][0]["value"] > 0
