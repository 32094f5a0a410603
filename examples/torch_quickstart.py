"""Quickstart through the PyTorch port: train a reduced Qwen3-family model
with RandTopk cut-layer compression, then serve it, the paper's full
pipeline in one file. Runs on the card (its codec through the CUDA
kernels) unless `--device cpu` is given.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

import repro_torch.configs as configs
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.steps import make_serve_step, make_train_step
from repro_torch.models import transformer
from repro_torch.models.config import Runtime, SplitConfig
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.engine import resolve_device
from repro_torch.split import protocol


def main(device=None, steps=60, batch=8, seq=64, gen=8):
    dev = resolve_device(device)
    cfg = configs.get("qwen3-8b", smoke=True).with_(
        split=SplitConfig(cut_layer=1, compressor="randtopk", k=16,
                          alpha=0.1))
    rt = Runtime(training=True)
    params = transformer.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = adamw_init(params)
    pipe = TokenPipeline(cfg, batch=batch, seq=seq, device=str(dev))
    step = make_train_step(cfg, rt, lr=1e-3)
    draws = torch.Generator(device=dev).manual_seed(1)

    print("training with RandTopk(k=16, alpha=0.1) at the cut layer...")
    for i in range(steps):
        params, opt, m = step(params, opt, pipe.next_batch(i), draws)
        if i % 20 == 0 or i == steps - 1:
            print(f"  step {i:3d} loss={float(m['loss']):.4f}")
    fwd = protocol.wire_bytes_per_step(cfg, batch, seq, training=False)
    full = batch * seq * cfg.d_model * 4
    print(f"cut-layer wire per forward: {fwd:.0f} B vs {full} B dense "
          f"({100*fwd/full:.1f}% compressed size)")

    rt_inf = Runtime(training=False)
    cache = transformer.init_cache(cfg, 2, 32, device=dev)
    serve = make_serve_step(cfg, rt_inf)
    tok = torch.zeros((2, 1), dtype=torch.int64, device=dev)
    toks = []
    for _ in range(gen):
        tok, cache = serve(params, cache, tok)
        toks.append(int(tok[0, 0]))
    print("greedy decode:", toks)
    return toks


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    main(device=ap.parse_args().device)
