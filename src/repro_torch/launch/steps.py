"""Train, serve and eval step builders shared by the trainer and
`chip_smoke.py`.

A train step takes the parameters as a nested dict of tensors (the
reference's tree), computes the loss and its gradients with autograd, and
applies AdamW; it returns new parameter tensors and the moments updated
in place (`optim.adamw`), so callers treat the old parameters and state
as consumed.
On a training mesh (`Runtime.mesh`) the parameters stay whole, one tensor
a leaf, and each position takes its shard as a slice: autograd's
accumulation into the leaf is the data-parallel gradient sum, so AdamW
and the global grad norm are the mesh-less ones. The serve step
(`make_serve_step`) is one greedy token of the whole batch with a KV
cache, the reference's `make_serve_step`.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig, Runtime
from repro_torch.optim.adamw import adamw_update, tree_leaves, tree_map
from repro_torch.split import model as split_model

AUX_WEIGHT = 0.01  # MoE balance-loss weight (the dense family has none)


def loss_fn(params, cfg: ArchConfig, rt: Runtime, batch, generator):
    """Cross entropy + AUX_WEIGHT * aux. On a mesh the loss runs once a
    batch shard, on the logits of its rows against its own labels
    (wherever the pod ring took the rows), and the shards' means are
    averaged."""
    logits, aux = split_model.forward(params, cfg, rt, batch,
                                      generator=generator)
    if rt.mesh is None:
        ce = transformer.cross_entropy(logits, batch["labels"])
    else:
        labels = batch["labels"].split(logits[0].shape[0])
        ce = torch.stack([transformer.cross_entropy(lg, lb)
                          for lg, lb in zip(logits, labels)]).mean()
    return ce + AUX_WEIGHT * aux, (ce, aux)


def make_train_step(cfg: ArchConfig, rt: Runtime, *, lr=3e-4,
                    weight_decay=0.0) -> Callable:
    """(params, opt_state, batch, generator) -> (params, opt_state,
    metrics): one AdamW step on the split model; `generator` feeds the
    cut's RandTopK draws. A parameter group the loss cannot reach
    (`_unreached_groups`) takes a zero gradient, as `jax.grad` gives; any
    other leaf the loss does not reach raises (a wiring fault)."""
    unreached = _unreached_groups(cfg)

    def step(params, opt_state, batch, generator):
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        total, (ce, aux) = loss_fn(params, cfg, rt, batch, generator)
        leaves = tree_leaves(params)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        it = iter(grads)
        grads = {name: tree_map(lambda p, name=name: _grad_of(
            next(it), p, name, unreached), sub)
            for name, sub in params.items()}
        new_params, new_opt, gnorm = adamw_update(
            params, grads, opt_state, lr=lr, weight_decay=weight_decay)
        metrics = {"loss": total.detach(), "ce": ce.detach(),
                   "aux": aux.detach(), "grad_norm": gnorm}
        return new_params, new_opt, metrics

    return step


def _unreached_groups(cfg: ArchConfig) -> frozenset:
    """The top-level parameter groups the loss does not reach: zamba2's
    shared block at a depth without a shared-attention site (the dry
    run's small depths, `launch.dryrun.depths`)."""
    if cfg.family == "hybrid" and not any(
            s >= 0 for s in transformer.attn_sites(cfg)):
        return frozenset({"shared_attn", "shared_mlp"})
    return frozenset()


def _grad_of(g, p, group, unreached):
    if g is not None:
        return g
    if group not in unreached:
        raise RuntimeError(f"the loss does not reach a leaf of {group!r} "
                           f"{tuple(p.shape)}")
    return torch.zeros_like(p)


def make_serve_step(cfg: ArchConfig, rt: Runtime) -> Callable:
    """(params, cache, token (B, 1)) -> (next token (B, 1) int64, cache):
    one greedy token of every row with a cache (`split.model.decode_step`,
    the cache written in place), the argmax of the last logits over the
    padded vocab. On a mesh (`rt.mesh`, every family, a cache of
    `split.model.init_decode_cache`) the argmax is the vocab-parallel one
    and the tokens come back in the batch's row order
    (`split.model.next_tokens`)."""

    def serve_step(params, cache, token):
        if rt.mesh is None:
            logits, cache = split_model.decode_step(params, cfg, rt, token,
                                                    cache)
            return torch.argmax(logits[:, -1], dim=-1, keepdim=True), cache
        lay, logits, origin = split_model.decode_mesh(params, cfg, rt,
                                                      token, cache)
        toks = split_model.next_tokens(cfg, lay, [lg[:, -1] for lg in logits],
                                       origin)
        return toks[:, None], cache

    return serve_step


def make_eval_step(cfg: ArchConfig, rt: Runtime) -> Callable:
    """(params, batch) -> {"ce", "acc"} under no autograd; RandTopK runs as
    the deterministic top-k when `rt.training` is False."""

    @torch.no_grad()
    def eval_step(params, batch):
        logits, _ = split_model.forward(params, cfg, rt, batch)
        ce = transformer.cross_entropy(logits, batch["labels"])
        acc = torch.mean((torch.argmax(logits, -1) == batch["labels"]).to(
            torch.float32))
        return {"ce": ce, "acc": acc}

    return eval_step
