"""Device meshes for the sharded serving arena and the training mesh,
and their collectives.

A `Mesh` names its axes and their sizes and holds one `torch.device` per
mesh position, positions flattened in axis order (the reference's
`jax.sharding.Mesh`). One process drives every position, as the
reference's single controller drives every device of its mesh: the
per-position program runs on its position's device, and the collectives
below are explicit tensor moves between positions. Every position may be
the same card, so one card hosts a (2, 2, 2) mesh; positions on several
cards run the same code, which then copies between them with
`.to(device)`. The builders (`make_serving_mesh` ...) are in
`launch.mesh`.

Each collective takes and returns one tensor per position. Under
autograd it is a `torch.autograd.Function` whose backward is the
reference's transpose: all-gather and reduce-scatter are each other's,
an all-reduce sum is its own, and a permute's is the inverse permute.
An axis argument names one axis or a tuple of axes (the group: the
positions that differ only along them).

Given a `registry` (an `obs.registry.MetricsRegistry`, the run's own),
each collective adds its bytes to the counter `collective_bytes_total`,
labelled by `op`, under the convention of the reference's
`roofline.hlo.collective_bytes`: raw bytes are the collective's
per-device output size, ops "all-gather", "reduce-scatter", "all-reduce"
and "collective-permute", counted once per collective (one instruction
of the reference's SPMD program), however many groups run it; a
backward's collectives count the same way. A group of one position moves
nothing and is not counted. `collective_bytes(snap)` reads the counter
back from a registry snapshot; `roofline.analysis.
serving_collective_costs`, `training_collective_costs` and
`decode_collective_costs` predict it.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

COUNTER = "collective_bytes_total"


def collective_bytes(snapshot: dict) -> Dict[str, int]:
    """Per-op raw collective bytes of a registry snapshot
    (`MetricsRegistry.snapshot()`, or `run_streaming`'s `metrics`)."""
    series = snapshot.get(COUNTER, {}).get("series", [])
    return {row["labels"]["op"]: row["value"] for row in series}


def _count(registry, op: str, t: torch.Tensor) -> None:
    if registry is not None:
        registry.counter(COUNTER, op=op).inc(t.numel() * t.element_size())


def _device(d) -> torch.device:
    """`d` as a torch.device, a card's with its index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """Named axes over positions; `shape` maps each axis to its size in
    axis order, `devices` holds one device per flattened position."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], devices):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axes)} differ in length")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        self.devices = tuple(_device(d) for d in devices)
        if len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size} positions")

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def coord(self, pos: int, axis: str) -> int:
        """Position `pos`'s index along `axis`."""
        return pos // self._stride(axis) % self.shape[axis]

    def _stride(self, axis: str) -> int:
        names = self.axis_names
        return math.prod(self.shape[a] for a in names[names.index(axis) + 1:])

    def group_size(self, axis) -> int:
        """Positions in a group along `axis` (a name or a tuple of names)."""
        return math.prod(self.shape[a] for a in _axes(axis))

    def groups(self, axis) -> List[List[int]]:
        """The positions that differ only along `axis` (a name or a tuple
        of names), each group in axis order; every position is in exactly
        one group."""
        axes = _axes(axis)
        rest = [a for a in self.axis_names if a not in axes]
        out: Dict[tuple, List[int]] = {}
        for p in range(self.size):
            out.setdefault(tuple(self.coord(p, a) for a in rest),
                           []).append(p)
        return list(out.values())

    def shift(self, pos: int, axis: str, to: int) -> int:
        """The position with `pos`'s coordinates but index `to` along
        `axis`."""
        return pos + (to - self.coord(pos, axis)) * self._stride(axis)


def _axes(axis):
    return (axis,) if isinstance(axis, str) else tuple(axis)


class _Collective(torch.autograd.Function):
    """`run(xs)` over the positions' tensors, with `transpose(grads)` (the
    reference's transpose of the collective) as its backward."""

    @staticmethod
    def forward(ctx, run, transpose, *xs):
        ctx.transpose = transpose
        return tuple(run(list(xs)))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *ctx.transpose(list(gs)))


def _apply(run, transpose, xs):
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return list(_Collective.apply(run, transpose, *xs))
    return run(list(xs))


def _per_group(mesh: Mesh, axis, xs, combine):
    """`combine(list of the group's tensors on one device)` for each group
    along `axis`, computed once per device of the group and handed to
    every member on it."""
    out: List = [None] * mesh.size
    for group in mesh.groups(axis):
        done: Dict[torch.device, torch.Tensor] = {}
        for p in group:
            dev = mesh.devices[p]
            if dev not in done:
                done[dev] = combine([xs[q].to(dev) for q in group])
            out[p] = done[dev]
    return out


def _sum(ts):
    acc = ts[0]
    for t in ts[1:]:
        acc = acc + t
    return acc


def _gather(mesh, xs, axis, dim, registry):
    out = _per_group(mesh, axis, xs, lambda ts: torch.cat(ts, dim))
    _count(registry, "all-gather", out[0])
    return out


def _scatter(mesh, xs, axis, dim, registry):
    out: List = [None] * mesh.size
    for group in mesh.groups(axis):
        n = len(group)
        size = xs[group[0]].shape[dim]
        if size % n:
            raise ValueError(f"reduce-scatter of {size} along dim {dim} "
                             f"over a group of {n}")
        c = size // n
        for i, p in enumerate(group):
            dev = mesh.devices[p]
            out[p] = _sum([xs[q].narrow(dim, i * c, c).to(dev)
                           for q in group])
    _count(registry, "reduce-scatter", out[0])
    return out


def _reduce(mesh, xs, axis, registry):
    out = _per_group(mesh, axis, xs, _sum)
    _count(registry, "all-reduce", out[0])
    return out


def _permute(mesh, xs, axis, perm, registry):
    dst_of = dict(perm)
    out: List = [None] * mesh.size
    for p in range(mesh.size):
        q = mesh.shift(p, axis, dst_of[mesh.coord(p, axis)])
        out[q] = xs[p].to(mesh.devices[q])
    _count(registry, "collective-permute", out[0])
    return out


def all_gather(mesh: Mesh, xs, axis: str, dim: int = 0, registry=None):
    """Each position's tensor concatenated with its group's along `dim`,
    in axis order (`lax.all_gather(..., tiled=True)`); the backward is the
    reduce-scatter of the gradients."""
    if mesh.group_size(axis) == 1:
        return list(xs)
    return _apply(lambda ts: _gather(mesh, ts, axis, dim, registry),
                  lambda gs: _scatter(mesh, gs, axis, dim, registry), xs)


def reduce_scatter(mesh: Mesh, xs, axis: str, dim: int = 0, registry=None):
    """The sum over each group along `axis`, of which the position of
    index i in the group keeps chunk i along `dim` (`lax.psum_scatter(...,
    scatter_dimension=dim, tiled=True)`); the backward is the all-gather
    of the gradients."""
    if mesh.group_size(axis) == 1:
        return list(xs)
    return _apply(lambda ts: _scatter(mesh, ts, axis, dim, registry),
                  lambda gs: _gather(mesh, gs, axis, dim, registry), xs)


def all_reduce(mesh: Mesh, xs, axis, op: str, registry=None):
    """Elementwise "sum", "max" or "min" over each group along `axis`
    (`lax.psum`, `lax.pmax`, `lax.pmin`); the sum adds in axis order and
    its backward is the sum of the gradients. "max" and "min" (the
    serving argmax) take no gradient."""
    if mesh.group_size(axis) == 1:
        return list(xs)
    if op == "sum":
        return _apply(lambda ts: _reduce(mesh, ts, axis, registry),
                      lambda gs: _reduce(mesh, gs, axis, registry), xs)
    fn = {"max": torch.maximum, "min": torch.minimum}[op]

    def combine(ts):
        acc = ts[0]
        for t in ts[1:]:
            acc = fn(acc, t)
        return acc

    out = _per_group(mesh, axis, xs, combine)
    _count(registry, "all-reduce", out[0])
    return out


def permute(mesh: Mesh, xs, axis: str, perm, registry=None):
    """`lax.ppermute` along `axis`: for each (src, dst) of `perm`, the
    tensors of index src go to the positions of index dst (the other
    coordinates kept). Every index must be a destination once. The
    backward sends the gradients back by the inverse permutation."""
    if mesh.shape[axis] == 1:
        return list(xs)
    back = [(dst, src) for src, dst in perm]
    return _apply(lambda ts: _permute(mesh, ts, axis, perm, registry),
                  lambda gs: _permute(mesh, gs, axis, back, registry), xs)
