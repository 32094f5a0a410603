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

    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \
        --smoke --device cpu --steps 5 --split randtopk --k 16

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch llama-3.2-vision-90b --smoke --device cpu --steps 5 \
        --split randtopk --k 16

    python -m repro_torch.launch.train --arch zamba2-7b --layers 12 \
        --steps 3 --batch 4 --seq 256 --split randtopk --k 64

    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
        --smoke --device cpu --steps 5 --split randtopk --k 16

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        --smoke --device cpu --steps 5 --split randtopk --k 16 --mesh 2,2

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \
        --smoke --device cpu --steps 5 --batch 4 --seq 16 \
        --split randtopk --k 16 --mesh 2,2

    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \
        --smoke --device cpu --steps 5 --batch 4 --seq 16 \
        --split randtopk --k 16 --mesh 1,2

    python -m repro_torch.launch.train --arch rwkv6-1.6b --layers 6 \
        --steps 5 --batch 4 --seq 256 --split randtopk --k 64 --mesh 2,2

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        --smoke --device cpu --steps 5 --split randtopk --k 16 \
        --mesh 2,2 --procs

    python -m repro_torch.launch.train --arch yi-6b --layers 8 \
        --steps 10 --batch 4 --seq 256 --split randtopk --k 64 \
        --mesh 2,2 --procs --devices cuda:0,cuda:1,cuda:2,cuda:3

Runs a real training loop: synthetic token batches drawn on the device,
the split model with the cut-layer codec at `--cut` (default n_layers // 2;
for the vlm rounded down to whole groups of `cross_attn_every` layers, at
least one, as the reference does), AdamW; a mixture-of-experts model adds its balance loss (weight
`launch.steps.AUX_WEIGHT`). Weights are random, drawn from `--seed`.

Checkpoints, in the reference's layout: every `--ckpt-every` steps the
params go to `step_%08d.npz` in `--ckpt-dir` and the optimizer to its
`opt` subdirectory (`checkpoint.store`); the generator that draws each
step's RandTopK noise goes to its `rng` subdirectory (the reference
draws from `fold_in(key, step)` and has no such state). A run given a directory that
holds a checkpoint resumes from its latest step and trains to `--steps`,
as the uninterrupted run would, bit for bit.

`--mesh d,m` trains any config on a ('data', 'model')[:len] mesh, as
the reference takes it (`launch.mesh.make_mesh`): the batch splits over
'data', and over 'model' run Megatron tensor and sequence parallelism
(attention's and cross attention's heads, the MLP's and the channel
mix's ff columns, Mamba2's and RWKV6's heads, whisper's encoder over its
frames) and the moe's expert parallelism (`models.tp`). Every position
lies on the one device of `--device`; the parameters stay whole there.
With `--procs` (every family) one process drives each
position (`launch.mesh.spawn`, over gloo: several processes share the
card, or the CPU with `--device cpu`). Each draws the whole model from
`--seed` and keeps only its block of every parameter and AdamW moment,
laid out by the reference's sharding trees (`launch.specs.
param_shardings`); the step gathers each leaf to the block its
position reads (`launch.specs.use_layouts`: a 'model' block over the
data axes only, or the whole leaf) and reduces the gradients to the
blocks, and its loss is the single controller's (`launch.steps`). Every rank gathers the blocks to checkpoint and rank 0
writes the single controller's files; at resume each rank reads the
whole files and keeps its blocks. Rank 0 prints. `--devices` gives one
card a process over NCCL instead (not yet run: it needs as many cards
as positions).
"""
from __future__ import annotations

import argparse
import math
import os
import time

import torch

from repro_torch import configs
from repro_torch import mesh as mesh_mod
from repro_torch.checkpoint import store
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_mesh, make_process_mesh, spawn
from repro_torch.launch.steps import make_train_step
from repro_torch.models import common, transformer
from repro_torch.models.config import Runtime, SplitConfig
from repro_torch.optim.adamw import adamw_init, tree_map
from repro_torch.runtime.engine import resolve_device
from repro_torch.split import protocol


def build(arch: str, *, smoke=False, layers=None, split=None, k=16,
          alpha=0.1, cut=0, backend=None):
    """The config `main` trains: `arch` (depth cut to `layers`) with the
    cut-layer codec `split` at `cut` (`cut_for`)."""
    cfg = configs.with_layers(configs.get(arch, smoke=smoke), layers)
    if split:
        cfg = cfg.with_(split=SplitConfig(
            cut_layer=configs.cut_for(cfg, cut), compressor=split, k=k,
            alpha=alpha, backend=backend))
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
    ap.add_argument("--mesh", default=None, help="e.g. 2,4 for (data,model)")
    ap.add_argument("--procs", action="store_true",
                    help="one process a mesh position")
    ap.add_argument("--devices", default=None,
                    help="with --procs: one card a position over NCCL, "
                         "e.g. cuda:0,cuda:1")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)
    shape = tuple(int(x) for x in args.mesh.split(",")) if args.mesh else ()
    axes = ("data", "model")[:len(shape)]
    if args.procs:
        if not shape:
            raise SystemExit("--procs needs --mesh")
        devices = args.devices.split(",") if args.devices else None
        # no join limit: the process group's catches a hung collective
        spawn(_rank_main, math.prod(shape), (args, shape, axes, devices),
              device=None if devices else resolve_device(args.device),
              devices=devices, timeout=None)
        return None
    if args.devices:
        raise SystemExit("--devices needs --procs")
    dev = resolve_device(args.device)
    return _train(args, dev, make_mesh(shape, axes, devices=dev)
                  if shape else None)


def _rank_main(rank, dev, args, shape, axes, devices):
    """One process of `--procs`: the run on its position of the process
    mesh (every position on `dev`, or one of `devices` each); rank 0
    prints and checkpoints."""
    _train(args, dev, make_process_mesh(shape, axes, devices or dev),
           lead=rank == 0)


def _train(args, dev, mesh, lead=True):
    write = print if lead else (lambda *a, **kw: None)
    cfg = build(args.arch, smoke=args.smoke, layers=args.layers,
                split=args.split, k=args.k, alpha=args.alpha, cut=args.cut,
                backend=args.backend)
    rt = Runtime(mesh=mesh, training=True)
    params = transformer.init_model(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    write(f"arch={cfg.name} layers={cfg.n_layers} "
          f"params={common.count_params(params):,} "
          f"device={dev} mesh={mesh} split={cfg.split}")
    sharded = None
    if mesh is not None and mesh.procs:
        # (layouts, whole shapes on `meta`) of the params and of the
        # AdamW state: each process keeps its blocks
        whole = specs.abstract_params(cfg)
        sharded = ((specs.param_shardings(cfg, rt, whole), whole),
                   (specs.opt_shardings(cfg, rt, whole), adamw_init(whole)))
        params = specs.shard_tree(mesh, params, sharded[0][0])
    opt = adamw_init(params)
    if cfg.split:
        analytic = protocol.wire_bytes_per_step(cfg, args.batch, args.seq,
                                                training=True)
        measured = protocol.measured_payload_bytes(cfg, args.batch, args.seq)
        write(f"cut-layer wire/step: {analytic:.0f} B analytic (fwd+bwd), "
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
            if sharded is None:
                params = store.restore(args.ckpt_dir, last, params)
                opt = store.restore(opt_dir, last, opt)
            else:
                params = _restore_blocks(mesh, args.ckpt_dir, last,
                                         *sharded[0], dev)
                opt = _restore_blocks(mesh, opt_dir, last, *sharded[1], dev)
            gen.set_state(store.restore(rng_dir, last,
                                        {"gen": gen.get_state()})["gen"])
            start = last
            write(f"restored step {last}")
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        params, opt, metrics = step_fn(params, opt, pipe.next_batch(step),
                                       gen)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            write(f"step {step:5d} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                  f"aux={m['aux']:.4f} gnorm={m['grad_norm']:.2f} "
                  f"({time.perf_counter() - t0:.1f}s)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            saved_p, saved_o = params, opt
            if sharded is not None:    # every rank gathers, rank 0 writes
                saved_p = specs.gather_tree(mesh, params, *sharded[0])
                saved_o = specs.gather_tree(mesh, opt, *sharded[1])
            if lead:
                store.save(args.ckpt_dir, step + 1, saved_p)
                store.save(opt_dir, step + 1, saved_o)
                store.save(rng_dir, step + 1, {"gen": gen.get_state()})
            del saved_p, saved_o
    if dev.type == "cuda":
        write(f"peak device memory: "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return params


def _restore_blocks(mesh, ckpt_dir, step, layouts, whole, dev):
    """A checkpoint of whole tensors (shaped as `whole`, on `meta`) read
    on the host, this process's block of each leaf kept on `dev`."""
    host = store.restore(ckpt_dir, step, tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype), whole))
    return tree_map(lambda t, lay: mesh_mod.shard(mesh, t, lay).to(dev),
                    host, layouts)


if __name__ == "__main__":
    main()
