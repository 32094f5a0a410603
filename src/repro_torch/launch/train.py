"""End-to-end split-training driver, on the card unless `--device cpu`.

    python -m repro_torch.launch.train --arch yi-6b --layers 8 --cut 4 \
        --steps 10 --batch 4 --seq 256 --split randtopk --k 64

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \
        --device cpu --steps 5 --split randtopk --k 16

    python -m repro_torch.launch.train --arch qwen3-8b --layers 4 \
        --steps 10 --batch 4 --seq 256 --split randtopk --k 64

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch granite-moe-1b-a400m --smoke --device cpu --steps 5 \
        --split randtopk --k 16 --ckpt-dir /tmp/ck --ckpt-every 5

Runs a real training loop: synthetic token batches drawn on the device,
the split model with the cut-layer codec at `--cut` (default n_layers // 2),
AdamW; a mixture-of-experts model adds its balance loss (weight
`launch.steps.AUX_WEIGHT`). Weights are random, drawn from `--seed`.

Checkpoints, in the reference's layout: every `--ckpt-every` steps the
params go to `step_%08d.npz` in `--ckpt-dir` and the optimizer to its
`opt` subdirectory (`checkpoint.store`); the generator that draws each
step's RandTopK noise goes to its `rng` subdirectory (the reference
draws from `fold_in(key, step)` and has no such state). A run given a directory that
holds a checkpoint resumes from its latest step and trains to `--steps`,
as the uninterrupted run would, bit for bit. The reference's `--mesh` is
not ported.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import store
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer
from repro_torch.models.config import Runtime, SplitConfig
from repro_torch.optim.adamw import adamw_init, tree_leaves
from repro_torch.runtime.engine import resolve_device
from repro_torch.split import protocol


def build(arch: str, *, smoke=False, layers=None, split=None, k=16,
          alpha=0.1, cut=0, backend=None):
    """The config `main` trains: `arch` (depth cut to `layers`) with the
    cut-layer codec `split` at `cut` (default n_layers // 2)."""
    cfg = configs.get(arch, smoke=smoke)
    if layers:
        cfg = cfg.with_(n_layers=layers)
    if split:
        cfg = cfg.with_(split=SplitConfig(
            cut_layer=cut or max(1, cfg.n_layers // 2), compressor=split,
            k=k, alpha=alpha, backend=backend))
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (the width is never cut)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--split", default=None)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--cut", type=int, default=0)
    ap.add_argument("--backend", default=None,
                    choices=["auto", "torch", "cuda"],
                    help="kernel backend (default: the CUDA kernels for "
                         "tensors on the card)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' on purpose)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = build(args.arch, smoke=args.smoke, layers=args.layers,
                split=args.split, k=args.k, alpha=args.alpha, cut=args.cut,
                backend=args.backend)
    rt = Runtime(training=True)
    params = transformer.init_model(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    opt = adamw_init(params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.name} layers={cfg.n_layers} params={n_params:,} "
          f"device={dev} split={cfg.split}")
    if cfg.split:
        analytic = protocol.wire_bytes_per_step(cfg, args.batch, args.seq,
                                                training=True)
        measured = protocol.measured_payload_bytes(cfg, args.batch, args.seq)
        print(f"cut-layer wire/step: {analytic:.0f} B analytic (fwd+bwd), "
              f"{measured} B measured fwd payload (dense fwd would be "
              f"{args.batch * args.seq * cfg.d_model * 4} B)")

    pipe = TokenPipeline(cfg, args.batch, args.seq, seed=args.seed,
                         device=str(dev))
    step_fn = make_train_step(cfg, rt, lr=args.lr)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    start = 0
    if args.ckpt_dir:
        opt_dir = os.path.join(args.ckpt_dir, "opt")
        rng_dir = os.path.join(args.ckpt_dir, "rng")
        last = store.latest_step(args.ckpt_dir)
        if last >= 0:
            params = store.restore(args.ckpt_dir, last, params)
            opt = store.restore(opt_dir, last, opt)
            gen.set_state(store.restore(rng_dir, last,
                                        {"gen": gen.get_state()})["gen"])
            start = last
            print(f"restored step {last}")
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        params, opt, metrics = step_fn(params, opt, pipe.next_batch(step),
                                       gen)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {step:5d} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                  f"aux={m['aux']:.4f} gnorm={m['grad_norm']:.2f} "
                  f"({time.perf_counter() - t0:.1f}s)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            store.save(args.ckpt_dir, step + 1, params)
            store.save(opt_dir, step + 1, opt)
            store.save(rng_dir, step + 1, {"gen": gen.get_state()})
    if dev.type == "cuda":
        print(f"peak device memory: "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return params


if __name__ == "__main__":
    main()
