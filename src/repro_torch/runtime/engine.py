"""Orchestration: build a server + N streaming clients and run the sessions.

Everything crosses real framed byte channels, compression is applied per
client (a mixed compressor population is supported), and the result
carries both parties' byte accounting so callers can cross-check measured
wire sizes against the Table-2 analytics.

`run_streaming` runs on the card: `device=None` means "cuda", and without
CUDA it raises unless the caller asks for `device="cpu"` (as the tests
do). Nothing falls back to the CPU silently.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import compressors
from repro_torch.core.payload import to_host
from repro_torch.launch import specs
from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig, Runtime
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import steps
from repro_torch.runtime.client import StreamingClient
from repro_torch.runtime.server import StreamingServer, serve_follower
from repro_torch.runtime.transport import channel_pair
from repro_torch.split import protocol


def resolve_device(device=None) -> torch.device:
    """`None` -> the card; raises when CUDA is absent (pass device="cpu"
    to run on the CPU on purpose)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def _client_compressors(cfg: ArchConfig, n_clients: int,
                        mix: Optional[Sequence] = None) -> List:
    """Per-client compressor objects: an explicit mix (spec strings or
    Compressor objects, assigned round-robin) or the config's compressor."""
    if mix is None:
        base = (protocol.make_cut_compressor(cfg.split) if cfg.split
                else compressors.Compressor())
        return [base] * n_clients
    objs = [compressors.make_compressor(m) if isinstance(m, str) else m
            for m in mix]
    return [objs[i % len(objs)] for i in range(n_clients)]


def run_streaming(cfg: ArchConfig, *, n_clients: int = 8,
                  prompt_len: int = 4, gen: int = 8,
                  max_batch: Optional[int] = None, max_wait: float = 0.01,
                  compressor_mix=None, seed: int = 0, params=None,
                  prompts=None, device=None,
                  capacity: Optional[int] = None, wrap_endpoint=None,
                  retry_timeout: Optional[float] = None,
                  max_retries: int = 16, tracer=None,
                  device_encode: bool = True, mesh=None) -> dict:
    """Serve `n_clients` concurrent sessions of `prompt_len + gen` tokens.

    `params` are the port's weights (e.g. `models.convert.params_from_jax`)
    or None for random weights from `torch.Generator(seed)`. `prompts` is
    an (n_clients, prompt_len) integer array, or None to draw from
    `numpy.random.default_rng(seed + 1)`. The server's decode and the
    clients' compressors follow `cfg.split.backend` (None = the CUDA
    kernels on the card, "torch" = their plain versions).

    `capacity` caps concurrently-resident sessions (default `n_clients`,
    so eviction never triggers); below `n_clients` it exercises the LRU
    evict-to-host / re-admission path. `wrap_endpoint(cid, endpoint) ->
    endpoint` intercepts every client-side connection, initial and
    reconnect (`testing.faults.FaultInjector` runs the stack under seeded
    chaos through it); `retry_timeout` turns on stop-and-wait
    retransmission (None: one blocking wait per reply). `tracer` (an
    `obs.trace.Tracer`, default off) records the frame lifecycle.
    `device_encode=False` frames each payload with the host codec
    (`steps.make_bottom_step`) instead of the device sections. `mesh` (a
    `repro_torch.mesh.Mesh` whose positions lie on the run's device
    type, e.g. `launch.mesh.make_serving_mesh`) shards the server's arena
    and runs the sharded top step (docs/sharding.md), whose collective
    bytes land in `metrics` (`repro_torch.mesh.collective_bytes`); the
    clients are unchanged. A `repro_torch.mesh.ProcessMesh` (one process
    a position, `launch.mesh.spawn`; every process calls `run_streaming`
    alike) serves from position 0's process: the server, the sessions,
    the clients, their prompts and compressors live there, and every
    other process holds its own arena block and follows the server's
    flushes (`server.serve_follower`), returning `{"rank", "steps",
    "metrics", "param_bytes"}` (its steps, its registry's snapshot and
    the bytes of the params it holds). Every process holds the params
    under `launch.specs.use_layouts(..., "arena")`: `unembed` as its
    'model' columns, the block its head reads, every other leaf whole
    (what the clients and the mesh-less top layers read).

    Returns the generated tokens `(n_clients, gen)`, per-session client
    and server stats, the compressors, the flush fill history, wall-clock
    throughput, `fault_counters` (all zero on a clean wire) and a
    `metrics` snapshot of the run's own `MetricsRegistry`.
    """
    dev = resolve_device(device)
    if mesh is not None and mesh.devices[mesh.local[0]].type != dev.type:
        raise ValueError(f"the mesh lies on {mesh.devices[mesh.local[0]]}, "
                         f"the run on {dev}")
    cut = (cfg.split.cut_layer if cfg.split and cfg.split.cut_layer > 0
           else max(1, cfg.n_layers // 2))
    assert 0 < cut < cfg.n_layers
    backend = cfg.split.backend if cfg.split else None
    if params is None:
        gen_ = torch.Generator(device=dev).manual_seed(seed)
        params = transformer.init_model(cfg, gen_, device=dev)
    max_len = prompt_len + gen
    if mesh is not None and mesh.procs:
        params = specs.shard_tree(mesh, params, specs.use_layouts(
            cfg, Runtime(mesh=mesh), "arena", params))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    if mesh is not None and mesh.procs and mesh.rank != 0:
        _, make_top_cache = cache_makers(cfg, max_len, dev, params)
        return dict(serve_follower(params, cfg, cut, mesh, make_top_cache,
                                   capacity=capacity or n_clients,
                                   x_shape=(1, 1, cfg.d_model),
                                   dtype=cfg.adtype(), device=dev),
                    param_bytes=param_bytes)
    max_batch = max_batch or min(8, n_clients)
    comps = _client_compressors(cfg, n_clients, compressor_mix)
    if prompts is None:
        prompts = np.random.default_rng(seed + 1).integers(
            0, cfg.vocab, (n_clients, prompt_len))
    prompts = np.asarray(prompts, np.int32).reshape(n_clients, prompt_len)

    make_bottom = (steps.make_bottom_step_device if device_encode
                   else steps.make_bottom_step)
    bottom_steps = {c: make_bottom(cfg, cut, c) for c in dict.fromkeys(comps)}

    make_cache, make_top_cache = cache_makers(cfg, max_len, dev, params)
    tracer = tracer if tracer is not None else NULL_TRACER
    registry = MetricsRegistry()        # per run, isolated
    top_step = steps.make_arena_top_step(cfg, cut, mesh=mesh,
                                         registry=registry)
    server = StreamingServer(params, top_step,
                             make_top_cache, device=dev, max_batch=max_batch,
                             max_wait=max_wait, dtype=cfg.adtype(),
                             capacity=capacity or n_clients,
                             x_shape=(1, 1, cfg.d_model), backend=backend,
                             tracer=tracer, registry=registry, mesh=mesh)
    server.expected_sessions = n_clients

    def _connect(cid: int):
        """A fresh channel onto session `cid` with its server reader
        attached, the client half optionally wrapped — the initial
        connection and the reconnect path."""
        cep, sep = channel_pair()
        server.attach(sep)
        return wrap_endpoint(cid, cep) if wrap_endpoint else cep

    clients: List[StreamingClient] = []
    for cid in range(n_clients):
        clients.append(StreamingClient(
            cid, params, make_cache(), bottom_steps[comps[cid]],
            _connect(cid), prompts[cid], gen, retry_timeout=retry_timeout,
            max_retries=max_retries, reconnect=lambda cid=cid: _connect(cid),
            tracer=tracer, registry=registry, device_encode=device_encode))

    serve_thread = threading.Thread(target=server.serve_loop, daemon=True)
    try:
        # warm every hot-loop path before the serving clock starts: one
        # bottom step per compressor (on a throwaway cache), then the
        # server's decode and step per (meta, bucket)
        tok0 = np.zeros((1, 1), np.int32)
        examples = []
        for step in bottom_steps.values():
            out = step(params, make_cache(), tok0)
            examples.append(to_host(out[0] if device_encode else out))
        server.warm(examples)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

        t0 = time.perf_counter()
        serve_thread.start()
        threads = [threading.Thread(target=c.run, daemon=True)
                   for c in clients]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        # guaranteed stop even if a CLOSE frame was lost to injected faults
        server.shutdown()
        serve_thread.join(timeout=60)
        wall = time.perf_counter() - t0
    finally:
        # a process mesh's followers stop with the serve loop; where the
        # loop never ran (a failed warm-up), here
        if not serve_thread.is_alive():
            server.stop_followers()
    # no reader may outlive the run: a daemon thread still inside torch
    # when the interpreter exits aborts it
    readers = server.join_readers(timeout=30)

    if server.errors:
        raise RuntimeError(f"server reader threads failed: "
                           f"{server.errors}") from server.errors[0]
    errs = [(c.id, c.error) for c in clients if c.error is not None]
    if errs:
        raise RuntimeError(f"client sessions failed: {errs}") from errs[0][1]
    if serve_thread.is_alive():
        raise RuntimeError("serve loop did not drain")
    if readers:
        raise RuntimeError(f"{len(readers)} server reader threads did not "
                           f"finish")

    tokens = np.asarray([c.generated for c in clients], np.int32)
    return {
        "tokens": tokens,
        "client_stats": [c.stats.as_dict() for c in clients],
        "server_stats": [server.sessions[c.id].stats.as_dict()
                         for c in clients],
        "compressors": [c.name for c in comps],
        "compressor_objs": comps,
        "batch_sizes": server.batch_sizes,
        "fault_counters": fault_summary(server, clients),
        "metrics": registry.snapshot(),
        "stage_s": dict(server.stage_s),
        "host_bytes": dict(server.host_bytes),
        "flushes": len(server.batch_sizes),
        "client_latencies": [list(c.latencies) for c in clients],
        "wall_s": wall,
        "tokens_per_s": tokens.size / max(wall, 1e-9),
        "n_clients": n_clients,
        "max_batch": max_batch,
        "cut_layer": cut,
        "device": str(dev),
        "param_bytes": param_bytes,
    }


def cache_makers(cfg: ArchConfig, max_len: int, device, params=None):
    """(make_cache, make_top_cache), each `rows -> transformer.init_cache`:
    the clients' bottom-model caches are always 16-bit; the label owner's
    arena takes `cfg.kv_cache_bits` (int8 codes + f32 scales at 8), or the
    Runtime default when it is 0. The vlm and audio caches compute their
    cross-attention KV from `params` (of zero patches or encoder output,
    as the reference serves)."""
    top_bits = cfg.kv_cache_bits or Runtime().kv_cache_bits

    def make_cache(rows=1):
        return transformer.init_cache(cfg, rows, max_len, device=device,
                                      params=params)

    def make_top_cache(rows=1):
        return transformer.init_cache(cfg, rows, max_len, device=device,
                                      bits=top_bits, params=params)

    return make_cache, make_top_cache


def fault_summary(server, clients) -> dict:
    """Recovery counters of both parties: all zero on a clean wire; under
    injected chaos, the measured recovery record."""
    out = {"server_faults_detected": server.faults_detected,
           "client_faults_detected": 0, "duplicates": 0, "replays": 0,
           "reconnects": 0}
    for c in clients:
        out["client_faults_detected"] += c.stats.faults_detected
        out["replays"] += c.stats.replays
        out["reconnects"] += c.stats.reconnects
        out["duplicates"] += c.stats.duplicates
    for sess in server.sessions.values():
        out["duplicates"] += sess.stats.duplicates
    return out
