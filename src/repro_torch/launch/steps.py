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
and the global grad norm are the mesh-less ones. On a process mesh
(`mesh.ProcessMesh`, every family) every process holds only its block of
each parameter and AdamW moment at rest, laid out by the reference's
sharding trees (`launch.specs.param_shardings`): the step gathers each
leaf to the block its position reads (`launch.specs.use_layouts(...,
"train")`: the 'model' block, gathered over the data axes only, or the
whole leaf), differentiates its own position's share of the loss
(`_loss_procs`), reduces each gradient to its block at rest, adding the
gradients of the processes that hold the same use block in position
order, and updates its blocks; the loss is the single controller's, bit
for bit. The serve step (`make_serve_step`) is one greedy token of the
whole batch with a KV cache, the reference's `make_serve_step`; on a
process mesh it takes each process's blocks under
`use_layouts(..., "decode")` (`specs.shard_tree`, made once; whole
parameters are sliced alike), and gathers no weight.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import mesh as mesh_mod
from repro_torch.launch import specs
from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig, Runtime
from repro_torch.optim.adamw import adamw_update, tree_leaves, tree_map
from repro_torch.split import model as split_model

AUX_WEIGHT = 0.01  # MoE balance-loss weight (the dense family has none)


def loss_fn(params, cfg: ArchConfig, rt: Runtime, batch, generator):
    """Cross entropy + AUX_WEIGHT * aux. On a mesh the loss runs once a
    batch shard, on the logits of its rows against its own labels
    (wherever the pod ring took the rows), and the shards' means are
    averaged. A process mesh takes `_loss_procs`."""
    logits, aux = split_model.forward(params, cfg, rt, batch,
                                      generator=generator)
    if rt.mesh is None:
        ce = transformer.cross_entropy(logits, batch["labels"])
    else:
        labels = batch["labels"].split(logits[0].shape[0])
        ce = torch.stack([transformer.cross_entropy(lg, lb)
                          for lg, lb in zip(logits, labels)]).mean()
    return ce + AUX_WEIGHT * aux, (ce, aux)


def _loss_procs(params, cfg: ArchConfig, rt: Runtime, batch, generator):
    """The loss on a process mesh: (objective, total, ce, aux).

    total, ce and aux are the single controller's values, bit for bit,
    on every process: each shard's cross entropy and L1 penalty are read
    at its representative (an all-gather of the scalars, not counted) and
    averaged in shard order. `objective` is this process's share of the
    loss for autograd: its shard's cross entropy and penalty over the
    shard count where the process is the shard's representative, and the
    layers' balance loss at position 0, where the single controller reads
    each; elsewhere the same terms times 0, so that every process runs
    every backward collective. The side inputs enter every process's
    objective the same way: the vlm's patches (batch data, no gradient)
    and whisper's encoder output, which reaches the loss through every
    cross attention of the process's position, so each process runs the
    backward of the encoder's collectives and of the pod ring's permute
    of its output. The processes' gradients of their objectives sum to
    the single controller's gradient."""
    mesh = rt.mesh
    lay, logits, aux, pen = split_model.forward_mesh(params, cfg, rt, batch,
                                                     generator)
    labels = batch["labels"].split(lay.b_loc)
    (c, lg), = [(c, lg) for c, lg in enumerate(logits) if lg is not None]
    ce = transformer.cross_entropy(lg, labels[c])
    if pen is None:
        pen = torch.zeros((), dtype=torch.float32, device=ce.device)
    (p,) = mesh.local
    # (ce, pen, the row shard c) in f64, which holds each exactly
    vals = mesh_mod.gather_values(mesh, torch.stack(
        [ce.detach().double(), pen.detach().double(),
         torch.tensor(float(c), dtype=torch.float64, device=ce.device)]))
    n = len(lay.groups)
    ces = [None] * n
    for r in lay.reps:
        ces[int(vals[r][2])] = vals[r][0].to(ce.dtype)
    ce_all = torch.stack(ces).mean()
    aux_all = aux.detach()
    if cfg.split is not None and cfg.split.cut_layer > 0:
        aux_all = aux_all + torch.stack(
            [vals[r][1].to(pen.dtype) for r in lay.reps]).mean()
    total = ce_all + AUX_WEIGHT * aux_all
    rep = 1.0 if p in lay.reps else 0.0
    objective = (rep * (ce + AUX_WEIGHT * pen) / n
                 + (1.0 if p == 0 else 0.0) * AUX_WEIGHT * aux)
    return objective, total, ce_all, aux_all


def make_train_step(cfg: ArchConfig, rt: Runtime, *, lr=3e-4,
                    weight_decay=0.0) -> Callable:
    """(params, opt_state, batch, generator) -> (params, opt_state,
    metrics): one AdamW step on the split model; `generator` feeds the
    cut's RandTopK draws. A parameter group the loss cannot reach
    (`_unreached_groups`) takes a zero gradient, as `jax.grad` gives; any
    other leaf the loss does not reach raises (a wiring fault).

    On a process mesh the params and moments are this process's blocks
    (`launch.specs.param_shardings`, `opt_shardings`; `specs.shard_tree`
    makes them) and so are the returned ones. The step gathers every
    leaf to its use block (`specs.use_layouts(..., "train")` at the
    batch's sequence length, `mesh.gather`), differentiates this
    process's share of the loss (`_loss_procs`), reduces each gradient to
    this process's block in position order among the processes that hold
    its use block (`mesh.reduce_to_block`), each use-block gradient freed
    as its block is made, forms the global grad norm from the blocks
    (`_block_norm`) and applies AdamW to the blocks. Its metrics then
    hold `param_bytes`, the bytes of the parameters the step held, and
    `gather_sent` and `reduce_sent`, the bytes this process sent to the
    others in the two moves (`ProcessMesh.sent`)."""
    unreached = _unreached_groups(cfg)
    if rt.mesh is not None and rt.mesh.procs:
        return _procs_train_step(cfg, rt, unreached, lr, weight_decay)

    def step(params, opt_state, batch, generator):
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        total, (ce, aux) = loss_fn(params, cfg, rt, batch, generator)
        grads = _grads(total, params, unreached)
        new_params, new_opt, gnorm = adamw_update(
            params, grads, opt_state, lr=lr, weight_decay=weight_decay)
        metrics = {"loss": total.detach(), "ce": ce.detach(),
                   "aux": aux.detach(), "grad_norm": gnorm}
        return new_params, new_opt, metrics

    return step


def _grads(objective, params, unreached):
    """d objective / d params as a tree like `params`."""
    grads = torch.autograd.grad(objective, tree_leaves(params),
                                allow_unused=True)
    it = iter(grads)
    return {name: tree_map(lambda p, name=name: _grad_of(
        next(it), p, name, unreached), sub)
        for name, sub in params.items()}


def _procs_train_step(cfg, rt, unreached, lr, weight_decay):
    """`make_train_step` on a process mesh: block trees in and out."""
    mesh = rt.mesh
    whole = specs.abstract_params(cfg)
    layouts = specs.param_shardings(cfg, rt, whole)

    def owners(lay):
        """The positions whose block of a leaf under `lay` is counted
        into the norm: the first holder of each distinct block."""
        first = {}
        for p in range(mesh.size):
            first.setdefault(mesh_mod.block_of(mesh, p, lay), p)
        return sorted(first.values())

    owned = tree_map(owners, layouts)

    uses = {}                     # sequence length -> use layouts

    def step(blocks, opt_state, batch, generator):
        seq = batch["tokens"].shape[1]
        if seq not in uses:
            uses[seq] = specs.use_layouts(cfg, rt, "train", whole, seq=seq)
        use = uses[seq]
        sent = dict(mesh.sent)
        params = tree_map(lambda b, lay, u, w: mesh_mod.gather(
            mesh, b, lay, w.shape, u).detach().requires_grad_(True),
            blocks, layouts, use, whole)
        held = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        objective, total, ce, aux = _loss_procs(params, cfg, rt, batch,
                                                generator)
        flat = tree_leaves(_grads(objective, params, unreached))
        del objective, params     # the graph and the use blocks
        # the leaves in the order of `blocks`, as `flat` holds them
        lays = tree_leaves(tree_map(lambda _, lay, u: (lay, u), blocks,
                                    layouts, use))
        for i, (lay, u) in enumerate(lays):
            flat[i] = mesh_mod.reduce_to_block(mesh, flat[i], lay, u)
        gnorm = _block_norm(mesh, flat, tree_leaves(
            tree_map(lambda _, own: own, blocks, owned)))
        it = iter(flat)
        grads = tree_map(lambda _: next(it), blocks)
        del flat, it
        new_blocks, new_opt, gnorm = adamw_update(
            blocks, grads, opt_state, lr=lr, weight_decay=weight_decay,
            gnorm=gnorm)
        metrics = {"loss": total.detach(), "ce": ce.detach(),
                   "aux": aux.detach(), "grad_norm": gnorm,
                   "param_bytes": held,
                   **{f"{k}_sent": mesh.sent[k] - sent.get(k, 0)
                      for k in ("gather", "reduce")}}
        return new_blocks, new_opt, metrics

    return step


def _block_norm(mesh, blocks, owners):
    """The global grad norm from the gradient blocks: each block's f32 sum
    of squares, fetched from every process (`mesh.gather_values`, not
    counted) and added leaf by leaf in position order, a block that
    several positions hold counted once (`owners`)."""
    sq = torch.stack([torch.sum(torch.square(g.float())) for g in blocks])
    vals = mesh_mod.gather_values(mesh, sq)
    acc = None
    for i, own in enumerate(owners):
        for p in own:
            acc = vals[p][i] if acc is None else acc + vals[p][i]
    return torch.sqrt(acc)


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
    (`split.model.next_tokens`). On a process mesh every process returns
    every row's token: the shards' tokens are fetched by an all-gather
    that is not counted into `rt.registry` (the output's fetch, not a
    collective of the step), so the step's counted bytes are
    `roofline.analysis.decode_collective_costs(argmax=True)` exactly, as
    on the single controller."""

    def serve_step(params, cache, token):
        if rt.mesh is None:
            logits, cache = split_model.decode_step(params, cfg, rt, token,
                                                    cache)
            return torch.argmax(logits[:, -1], dim=-1, keepdim=True), cache
        lay, logits, origin = split_model.decode_mesh(params, cfg, rt,
                                                      token, cache)
        toks = split_model.next_tokens(
            cfg, lay, mesh_mod.pmap(lambda _, lg: lg[:, -1], logits), origin)
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
