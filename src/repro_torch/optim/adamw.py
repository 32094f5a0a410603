"""AdamW and SGD over a (nested) dict of tensors: f32 moments over any-dtype
params, the reference's `optim/adamw.py` in plain tensor ops.

The update returns new parameter tensors and new moment tensors, as the
reference does; the moments are updated IN PLACE (`mu`, `nu` of the state
passed in are the ones returned), which saves a second f32 copy of them
at yi-6b's size. Callers treat the old state as consumed.
"""
from __future__ import annotations

import torch


def tree_leaves(tree):
    """Leaves of a nested dict in a fixed (insertion) order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of `tree` (and of the same-shaped `rest`)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    return fn(tree, *rest)


def adamw_init(params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))


def adamw_update(params, grads, opt_state, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.0, grad_clip=1.0, gnorm=None):
    """One AdamW step. Returns (new params, new state, grad norm): the norm
    before clipping when `grad_clip`, else 0. `gnorm`: the global grad
    norm to clip by, where `grads` are blocks of the gradients (a process
    mesh's, `launch.steps`); None: `global_norm(grads)`."""
    step = opt_state["step"] + 1
    if grad_clip:
        if gnorm is None:
            gnorm = global_norm(grads)
        scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
    else:
        gnorm = torch.zeros((), dtype=torch.float32, device=step.device)
        scale = None
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float()
        if scale is not None:
            g = g * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p.float()
        return (p.detach().float() - lr * u).to(p.dtype)

    new_params = tree_map(upd, params, grads, opt_state["mu"],
                          opt_state["nu"])
    return new_params, {"mu": opt_state["mu"], "nu": opt_state["nu"],
                        "step": step}, gnorm


def sgd_init(params):
    return {"mom": tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device)}


def sgd_update(params, grads, opt_state, *, lr, momentum=0.9):
    mom = tree_map(lambda m, g: momentum * m + g.float(), opt_state["mom"],
                   grads)
    new_params = tree_map(lambda p, m: (p.detach().float() - lr * m).to(
        p.dtype), params, mom)
    return new_params, {"mom": mom, "step": opt_state["step"] + 1}
