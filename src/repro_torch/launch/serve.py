"""Serving CLI — a thin entry point over the port's streaming runtime.

Spins up N simulated clients (feature owners), each holding the bottom
model and compressing its cut activations, against one batching server
holding the top model (`repro_torch.runtime`). Every cut payload crosses an
in-process byte channel as `core.wire` frames, so the reported
bytes/client/token are measured frame sizes, cross-checked here against the
Table-2 analytic prediction. Runs on the card unless `--device cpu`:

    python -m repro_torch.launch.serve --arch yi-6b --layers 8 \
        --clients 4 --prompt-len 16 --gen 32 --split randtopk --k 64

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --smoke --device cpu --clients 2 --gen 4 --split quant

    python -m repro_torch.launch.serve --arch qwen3-8b --clients 2 \
        --prompt-len 4 --gen 8 --split randtopk --k 64

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-1b-a400m --smoke --device cpu --clients 2 \
        --gen 6 --split topk --k 8

    python -m repro_torch.launch.serve --arch zamba2-7b --clients 2 \
        --prompt-len 4 --gen 8 --split randtopk --k 64

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --smoke --device cpu --clients 2 --gen 6 --split randtopk --k 16

    python -m repro_torch.launch.serve --arch llama-3.2-vision-90b \
        --layers 10 --clients 2 --prompt-len 4 --gen 8 --split randtopk --k 64

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
        --smoke --device cpu --clients 2 --gen 6 --split randtopk --k 16

`--arch` takes the dense (yi-6b, qwen3-8b, granite-3-8b, phi3-mini-3.8b),
mixture-of-experts (granite-moe-1b-a400m, qwen3-moe-235b-a22b), hybrid
Mamba2 (zamba2-7b), RWKV6 (rwkv6-1.6b), vision (llama-3.2-vision-90b,
gated cross attention over image patches) and audio (whisper-tiny, an
encoder-decoder) configurations; the cut sits at n_layers // 2 (for the
vlm rounded down to whole groups of `cross_attn_every` layers), and a
vlm's `--layers` must be whole groups. The served sessions carry no
patches or audio: the cross-attention KV is that of zeros, as the
reference serves. A config with `kv_cache_bits=8` serves from an int8 KV
arena on the label owner's side.

Weights are random, drawn from `--seed`. `--trace OUT.json` records the
frame lifecycle (Chrome-trace JSON, loadable in https://ui.perfetto.dev).

`--loadgen` switches the CLI to the open-loop production-traffic
harness (`runtime.loadgen`): seeded Poisson or MMPP-burst session arrivals
over the same stack under a virtual clock, graded against a declared SLO,
optionally with the congestion-adaptive (k, bits) QoS controller. Its
latencies are virtual time from the harness's service model, not card
times; the kernels still run for every served token and flush:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --smoke --device cpu --loadgen --qos --duration 2 --trace t.json
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import configs
from repro_torch.models.config import SplitConfig
from repro_torch.obs.export import write_trace
from repro_torch.obs.trace import Tracer
from repro_torch.runtime import engine
from repro_torch.runtime.loadgen import (ArrivalSpec, FleetSpec,
                                         LoadGenConfig, SLOSpec, run_loadgen)
from repro_torch.runtime.qos import QoSSpec


def _run_loadgen(cfg, args) -> dict:
    qos = None
    if args.qos:
        qos = QoSSpec(k=args.k, d=cfg.d_model, k_floor=args.k_floor,
                      high_depth=6, low_depth=2,
                      deadline_s=args.slo_p99_ms / 1e3 / 2,
                      patience=16, cooldown=1)
    lg = LoadGenConfig(
        seed=args.seed, duration_s=args.duration,
        arrivals=ArrivalSpec(process=args.arrival, rate=args.rate,
                             burst_rate=args.burst_rate),
        fleet=FleetSpec(compressors=(f"{args.split or 'randtopk'}:"
                                     f"k={args.k}",)
                        if args.split != "identity" else ("identity",),
                        prompt_len=(2, max(2, args.prompt_len)),
                        gen=(2, max(2, args.gen)),
                        bandwidth_Bps=args.bandwidth),
        slo=SLOSpec(p99_ms=args.slo_p99_ms,
                    max_reject_frac=args.max_reject_frac),
        qos=qos, capacity=args.capacity,
        max_batch=args.max_batch or 8, max_wait=args.max_wait,
        admission_depth=args.admission_depth)
    rep = run_loadgen(cfg, lg, trace_path=args.trace, device=args.device)
    if args.trace:
        print(f"trace: {rep['trace_events']} events -> {args.trace} "
              f"(load in https://ui.perfetto.dev)")
    lat, s = rep["latency_ms"], rep["sessions"]
    print(f"loadgen: {s['arrived']} arrivals over "
          f"{rep['virtual_duration_s']:.1f}s virtual "
          f"({rep['wall_s_real']:.1f}s real), {s['completed']} completed, "
          f"{s['rejected']} rejected, {s['failed']} failed")
    print(f"goodput {rep['goodput_tok_per_s']:.1f} tok/s; latency p50 "
          f"{lat['p50_ms']:.1f} / p95 {lat['p95_ms']:.1f} / p99 "
          f"{lat['p99_ms']:.1f} ms (streaming P2 p99 "
          f"{lat['p2_p99_ms']:.1f}); queue depth max "
          f"{rep['queue_depth']['max']} (virtual time)")
    if rep["qos"]["enabled"]:
        print(f"qos: ladder {rep['qos']['ladder']}, "
              f"{rep['qos']['switches']} rung switches, "
              f"level hist {rep['qos']['level_hist']}")
    print(f"SLO {'MET' if rep['slo']['ok'] else 'VIOLATED'}: "
          f"{rep['slo']['checks']}")
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (the width is never cut)")
    ap.add_argument("--clients", "--batch", dest="clients", type=int,
                    default=4, help="concurrent client sessions")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--split", default=None)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=None,
                    help="server flush size (default min(8, clients))")
    ap.add_argument("--max-wait", type=float, default=0.01,
                    help="server batching window in seconds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' on purpose)")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="record the frame lifecycle and write Chrome-trace"
                         " JSON here (Perfetto-loadable)")
    lgrp = ap.add_argument_group("loadgen", "open-loop traffic + SLO mode")
    lgrp.add_argument("--loadgen", action="store_true",
                      help="run the open-loop load generator instead of "
                           "the closed-loop client fleet")
    lgrp.add_argument("--arrival", choices=("poisson", "mmpp"),
                      default="poisson")
    lgrp.add_argument("--rate", type=float, default=20.0,
                      help="session arrivals per second (calm state)")
    lgrp.add_argument("--burst-rate", type=float, default=0.0,
                      help="mmpp burst arrival rate (0 = 2x --rate)")
    lgrp.add_argument("--duration", type=float, default=10.0,
                      help="virtual seconds of arrivals")
    lgrp.add_argument("--slo-p99-ms", type=float, default=100.0)
    lgrp.add_argument("--max-reject-frac", type=float, default=0.02)
    lgrp.add_argument("--qos", action="store_true",
                      help="congestion-adaptive (k, bits) ladder")
    lgrp.add_argument("--k-floor", type=int, default=4)
    lgrp.add_argument("--capacity", type=int, default=32,
                      help="arena slots / max concurrent sessions")
    lgrp.add_argument("--admission-depth", type=int, default=48,
                      help="reject arrivals above this queue backlog")
    lgrp.add_argument("--bandwidth", type=float, default=400_000.0,
                      help="per-client link bytes/s (0 = infinite)")
    args = ap.parse_args(argv)

    cfg = configs.with_layers(configs.get(args.arch, smoke=args.smoke),
                              args.layers)
    if args.split:
        cfg = cfg.with_(split=SplitConfig(
            cut_layer=configs.cut_for(cfg), compressor=args.split, k=args.k))

    if args.loadgen:
        return _run_loadgen(cfg, args)

    tracer = Tracer() if args.trace else None
    res = engine.run_streaming(
        cfg, n_clients=args.clients, prompt_len=args.prompt_len,
        gen=args.gen, max_batch=args.max_batch, max_wait=args.max_wait,
        seed=args.seed, device=args.device, tracer=tracer)
    if tracer is not None:
        n = write_trace(tracer, args.trace)
        print(f"trace: {n} events -> {args.trace} "
              f"(load in https://ui.perfetto.dev)")

    out = res["tokens"]
    fills = res["batch_sizes"]
    print(f"served {args.clients} sessions x {args.gen} tokens on "
          f"{res['device']} in {res['wall_s']:.2f}s "
          f"({res['tokens_per_s']:.1f} tok/s, mean batch fill "
          f"{np.mean(fills):.1f}/{res['max_batch']})")

    # measured vs analytic wire bytes, per client per token
    per_client = [s["payload_bytes_up"] / s["frames_up"]
                  for s in res["client_stats"]]
    header = [s["header_bytes_up"] / s["frames_up"]
              for s in res["client_stats"]]
    comp = res["compressor_objs"][0]
    analytic = comp.fwd_bits(cfg.d_model) / 8  # models quant headers too
    print(f"cut-layer wire: {np.mean(per_client):.1f} B/client/token "
          f"measured payload (+{np.mean(header):.1f} B framing) vs "
          f"{analytic:.1f} B analytic ({comp.name}) vs "
          f"{cfg.d_model * 4} B uncompressed")
    print("sample:", out[0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
