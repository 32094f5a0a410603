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

Weights are random, drawn from `--seed`. Only the closed-loop client fleet
is ported; the open-loop load generator is not.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import configs
from repro_torch.models.config import SplitConfig
from repro_torch.runtime import engine


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
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = cfg.with_(n_layers=args.layers)
    if args.split:
        cfg = cfg.with_(split=SplitConfig(
            cut_layer=max(1, cfg.n_layers // 2), compressor=args.split,
            k=args.k))

    res = engine.run_streaming(
        cfg, n_clients=args.clients, prompt_len=args.prompt_len,
        gen=args.gen, max_batch=args.max_batch, max_wait=args.max_wait,
        seed=args.seed, device=args.device)

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
