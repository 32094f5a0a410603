"""Orchestration: N training clients and one label-owner server, over frames.

`run_fedtrain` is the training twin of `runtime.engine.run_streaming`: it
shards the dataset's features over N `TrainingClient`s (the label shard
stays with the `TrainingServer`), wires every party over in-process byte
channels, and runs split training with every cut activation and cut
gradient crossing as real `core.wire` frames, so the byte accounting is
measured in both directions and checkable against the compressors'
Table-2 analytics. It runs on the card unless `device="cpu"`.

Batch alignment: each client's batch-index stream is a deterministic
function of (seed + client id), generated up front; the server's
`labels_for(session, seq)` indexes the label shard through the same stream
(the stand-in for the out-of-band sample-ID alignment of real vertical
deployments). With `n_clients=1` the stream, the parameter inits and the
per-step draws reproduce `split.tabular.train` exactly.

Checkpointing: with `ckpt_dir` and `ckpt_every`, all clients meet at a
barrier every `ckpt_every` local steps; the barrier action (every client
paused, no frame in flight, since sync steps block) saves every party's
trainer state into one `checkpoint.store` file. A later call with the same
configuration resumes from the latest step: parameters, optimizer moments,
generator states, EF residuals, stale gradients, schedule state and byte
counters. `stop_after_steps` stands in for a kill mid-run.

Faults and instruments, as the reference's: `wrap_endpoint` intercepts
every client connection (the first and each reconnect, made by one
`_connect`), which is how `testing.faults.FaultInjector` runs training
under seeded chaos; `retry_timeout` turns the clients' retransmission on.
Nothing about ARQ goes into a checkpoint: the save runs at the barrier,
with no frame in flight. Each run counts into a registry of its own,
never the process default; the result carries its snapshot (`metrics`)
and both parties' recovery counters (`fault_counters`). `tracer` records
the `client.encode` and `server.queue_wait` spans (host time).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.fedtrain.async_policy import AsyncPolicy
from repro_torch.fedtrain.client import TrainingClient
from repro_torch.fedtrain.schedule import KScheduler, ScheduleSpec
from repro_torch.fedtrain.server import TrainingServer
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.engine import fault_summary, resolve_device
from repro_torch.runtime.session import SessionStats
from repro_torch.runtime.transport import channel_pair
from repro_torch.split import tabular


def _batch_stream(n: int, batch: int, epochs: int, seed: int) -> List:
    """Deterministic per-client batch-index stream: the order of
    `data.synthetic.ManyClassDataset.batches`, so n_clients=1 sees exactly
    the batches `split.tabular.train` would."""
    rng = np.random.RandomState(seed)
    ids = []
    for _ in range(epochs):
        idx = rng.permutation(n)
        for i in range(0, n - batch + 1, batch):
            ids.append(idx[i: i + batch])
    return ids


def run_fedtrain(spec: tabular.SplitSpec, dataset, *, n_clients: int = 1,
                 epochs: int = 2, batch: int = 64, seed: int = 0,
                 schedule: Optional[ScheduleSpec] = None,
                 policy: Optional[AsyncPolicy] = None, ef: bool = False,
                 max_batch: Optional[int] = None, max_wait: float = 0.005,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 stop_after_steps: Optional[int] = None,
                 reply_timeout: float = 120.0, wrap_endpoint=None,
                 retry_timeout: Optional[float] = None,
                 max_retries: int = 16, tracer=None, device=None,
                 params=None) -> dict:
    """Train `spec` over the wire on `device` (default the card); returns
    losses, accuracy, measured and analytic byte accounting for both
    directions, `fault_counters`, the run's `metrics` snapshot and the
    final params.

    `wrap_endpoint(cid, endpoint) -> endpoint` wraps every client-side
    connection, the first and each reconnect; `retry_timeout` (seconds)
    turns retransmission on, `max_retries` bounds it a step; `tracer` (an
    `obs.trace.Tracer`, default off) records the spans. `params` =
    (bottoms, top) starts from given weights, one bottom dict per client
    (the tests hand in the reference's, converted); otherwise client c
    draws its bottom from `seed + c` and the server its top from
    `seed`."""
    dev = resolve_device(device)
    tracer = tracer if tracer is not None else NULL_TRACER
    registry = MetricsRegistry()        # per run, isolated
    # -- parties --------------------------------------------------------------
    if params is None:
        bottoms = [None] * n_clients
        _, top = tabular.init_parties(
            torch.Generator(device=dev).manual_seed(seed), spec, dev)
    else:
        bottoms, top = params
        if len(bottoms) != n_clients:
            raise ValueError(f"params hold {len(bottoms)} bottom models for "
                             f"{n_clients} clients")
        top = {k: v.to(dev) for k, v in top.items()}
    server = TrainingServer(spec, top, adamw_init(top), device=dev,
                            max_batch=max_batch or max(1, n_clients),
                            max_wait=max_wait, tracer=tracer,
                            registry=registry)
    # the loop must not stop before every client's session exists and
    # closed: a corrupt first frame retires a connection before its
    # session is made
    server.expected_sessions = n_clients

    shards_x = [dataset.x_train[c::n_clients] for c in range(n_clients)]
    shards_y = [dataset.y_train[c::n_clients] for c in range(n_clients)]
    streams = [_batch_stream(len(shards_x[c]), batch, epochs, seed + c)
               for c in range(n_clients)]
    n_steps = min(len(s) for s in streams)
    if n_steps == 0:
        raise ValueError("a client's shard is smaller than one batch")
    streams = [s[:n_steps] for s in streams]    # barrier-aligned step counts
    server.labels_for = lambda sid, seq: shards_y[sid][streams[sid][seq]]

    barrier = None
    ckpt_steps: List[int] = []
    clients: List[TrainingClient] = []
    if ckpt_dir and ckpt_every:
        def _save_action():
            step = ckpt_steps.pop(0)
            tree = {"clients": {str(c.id): c.state() for c in clients},
                    "server": server.state()}
            store.save(ckpt_dir, step, tree)

        barrier = threading.Barrier(n_clients, action=_save_action)

    def _connect(cid: int):
        """One client connection (also the reconnect path): a fresh channel
        pair, its server reader attached, the client half wrapped."""
        cep, sep = channel_pair()
        server.attach(sep)
        return wrap_endpoint(cid, cep) if wrap_endpoint else cep

    for cid in range(n_clients):
        clients.append(TrainingClient(
            cid, spec, shards_x[cid], streams[cid], _connect(cid),
            seed=seed + cid, device=dev, bottom=bottoms[cid],
            scheduler=KScheduler(schedule) if schedule else None,
            policy=policy, ef=ef, barrier=barrier, ckpt_every=ckpt_every,
            reply_timeout=reply_timeout, retry_timeout=retry_timeout,
            max_retries=max_retries,
            reconnect=lambda cid=cid: _connect(cid),
            tracer=tracer, registry=registry))

    # -- resume ---------------------------------------------------------------
    start_step = 0
    if ckpt_dir:
        last = store.latest_step(ckpt_dir)
        if last >= 0:
            like = {"clients": {str(c.id): c.state() for c in clients},
                    "server": server.state()}
            restored = store.restore(ckpt_dir, last, like)
            for c in clients:
                c.load_state(restored["clients"][str(c.id)])
            server.load_state(restored["server"])
            start_step = last

    end_step = min(n_steps, stop_after_steps or n_steps)
    for c in clients:
        c.start_step, c.end_step = start_step, end_step
    if barrier is not None:
        ckpt_steps.extend(m for m in range(start_step + 1, end_step + 1)
                          if m % ckpt_every == 0)

    # -- run ------------------------------------------------------------------
    t0 = time.perf_counter()
    train_thread = threading.Thread(target=server.train_loop, daemon=True)
    train_thread.start()
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=reply_timeout + 300)
    server.shutdown()
    train_thread.join(timeout=120)
    # no reader may outlive the run: a daemon thread still inside torch
    # when the interpreter exits aborts it
    readers = server.join_readers(timeout=30)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    if server.errors:
        raise RuntimeError(f"server reader threads failed: {server.errors}") \
            from server.errors[0]
    errs = [(c.id, c.error) for c in clients if c.error is not None]
    if errs:
        raise RuntimeError(f"training clients failed: {errs}") from errs[0][1]
    stuck = [t for t in threads + [train_thread] + readers if t.is_alive()]
    if stuck:
        raise RuntimeError(f"{len(stuck)} fedtrain threads did not finish")

    # -- evaluate + account ---------------------------------------------------
    x_test = torch.from_numpy(dataset.x_test).to(dev)
    y_test = torch.from_numpy(dataset.y_test).to(dev)
    accs = []
    for c in clients:
        spec_eval = spec
        if c.scheduler is not None:
            spec_eval = dataclasses.replace(spec, k=c.scheduler.cur_k)
        accs.append(tabular.evaluate(c.bottom, server.top, spec_eval,
                                     x_test, y_test))

    cstats = [c.stats.as_dict() for c in clients]
    # a fully resumed run (start == end) sends only CLOSE frames, so the
    # server may hold no session for a client
    sstats = [(server.sessions[c.id].stats.as_dict()
               if c.id in server.sessions else SessionStats().as_dict())
              for c in clients]
    return {
        "losses": [c.losses for c in clients],
        "k_trace": [c.k_trace for c in clients],
        "client_stats": cstats,
        "server_stats": sstats,
        "test_acc": accs,
        "mean_test_acc": float(np.mean(accs)),
        "payload_bytes_up": sum(s["payload_bytes_up"] for s in cstats),
        "payload_bytes_down": sum(s["payload_bytes_down"] for s in cstats),
        "header_bytes": sum(s["header_bytes_up"] + s["header_bytes_down"]
                            for s in cstats),
        "analytic_bytes_up": sum(c.analytic_up for c in clients),
        "analytic_bytes_down": sum(c.analytic_down for c in clients),
        "fault_counters": fault_summary(server, clients),
        "metrics": registry.snapshot(),
        "final_k": [c.scheduler.cur_k if c.scheduler else spec.k
                    for c in clients],
        "steps": end_step,
        "n_clients": n_clients,
        "bottoms": [c.bottom for c in clients],
        "top": server.top,
        "wall_s": wall,
    }
