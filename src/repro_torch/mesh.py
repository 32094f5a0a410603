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

A `ProcessMesh` is the same mesh with one process a position, as
PyTorch reaches several cards: `torch.distributed`'s rank r drives
position r (`launch.mesh.spawn` starts the processes). A per-position
list then holds a tensor only at the process's own position (`local`)
and None at every other, the one rule every mesh loop follows (`pmap`,
`Mesh.each`, `first`). Its collectives run over one `torch.distributed`
group a group of positions, made once a mesh on every rank in the same
order, with the transposes above as their backward. A reduction
all-gathers the group's pieces and adds them in group order, as `_sum`
does, so a process mesh computes what the single controller computes,
bit for bit, and counts each collective once into its registry, as
the single controller does. Under gloo (the CPU, or several processes
sharing one card) the tensors cross as bytes through host memory; under
NCCL (one card a process) they cross on the cards. Neither the staging
nor a gather that stands in for a reduction is counted.

The serving arena's control plane on a process mesh (position 0 runs
the server, every other process follows it): `broadcast_record` hands
each flush's control record from position 0 to every process,
`scatter_rows` each position its block of the flush's activation rows,
`gather_rows` every position's block of tokens back to position 0, and
`send_to` / `recv_from` move one arena row's state between position 0
and the row's owner, for an eviction or a re-admission. None of these is
counted: the reference's `xbuf` is replicated (`P()`), its tokens leave
by the host's read and its row ops are host copies, so its program has
no collective there (the rule under which `split.model.next_tokens`
fetches the tokens uncounted).

Blocks. A layout (`launch.specs.param_shardings`, the reference's
`PartitionSpec` as a tuple) splits a tensor's leading dimensions over
mesh axes; `block_of` and `block_slices` give a position's block.
`shard` keeps a process's block of a whole tensor. `gather` makes a
process's block under a use layout (`launch.specs.use_layouts`: the
'model' block its position reads, or the whole) from the blocks at rest,
an all-gather over the axes the rest layout splits over and the use
layout does not (the data axes for a 'model' block, all of them for the
whole). `reduce_to_block` sums the tensors that the processes holding
one use block hold (their gradients of it) into each one's block at
rest, added in position order: an all-to-all of blocks among those
processes, or, where their blocks at rest are that use block, a sum
(`sum_processes`' reduce-scatter and all-gather) among them. A position
with another 'model' block adds exact zeros to the whole sum, so each
block is the slice of the whole sum in position order (a -0.0 may come
out +0.0). These are the process mesh's resident parameters and moments,
moved around the step; none of them is counted, so a train step's
counted bytes stay `roofline.analysis.training_collective_costs`
exactly, as on the single controller. Each adds the bytes the process
sends to the other processes to `ProcessMesh.sent` ("gather" and
"reduce").
"""
from __future__ import annotations

import collections
import itertools
import math
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

COUNTER = "collective_bytes_total"


def collective_bytes(snapshot: dict) -> Dict[str, int]:
    """Per-op raw collective bytes of a registry snapshot
    (`MetricsRegistry.snapshot()`, or `run_streaming`'s `metrics`)."""
    series = snapshot.get(COUNTER, {}).get("series", [])
    return {row["labels"]["op"]: row["value"] for row in series}


def _count(registry, op: str, ts) -> None:
    if registry is not None:
        t = first(ts)
        registry.counter(COUNTER, op=op).inc(t.numel() * t.element_size())


def first(xs):
    """The first tensor of a per-position list: position 0's on the single
    controller, the process's own on a process mesh."""
    return next(x for x in xs if x is not None)


def pmap(fn, *lists):
    """[fn(p, *entries) for each position p], over the positions whose
    entry of the first list is a tensor (every position on the single
    controller, the process's own on a process mesh); None at the
    others."""
    return [None if items[0] is None else fn(p, *items)
            for p, items in enumerate(zip(*lists))]


def unzip(outs, n: int):
    """`pmap`'s per-position tuples of n entries as n per-position lists
    (None where the position has none)."""
    return tuple(pmap(lambda _, o, j=j: o[j], outs) for j in range(n))


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
        # the positions this process drives: every one
        self.local = tuple(range(self.size))

    procs = False

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def each(self, fn) -> list:
        """[fn(p)] at the positions this process drives, None at the
        others."""
        return [fn(p) if p in self.local else None
                for p in range(self.size)]

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


class ProcessMesh(Mesh):
    """A mesh of one process a position: `torch.distributed` is
    initialised with one rank a position, and rank r drives position r
    (`local`) on `devices[r]`. Every rank makes the mesh alike, in the
    same order as its other process meshes: the mesh makes a process
    group for every group of positions along every set of axes.
    `staged`: under gloo a card's tensors cross through host memory.
    `sent`: the bytes the block moves (`gather`, `reduce_to_block`) sent
    to other processes, by move."""

    procs = True

    def __init__(self, shape: Sequence[int], axes: Sequence[str], devices):
        super().__init__(shape, axes, devices)
        if not dist.is_initialized():
            raise ValueError("a process mesh needs torch.distributed "
                             "initialised (launch.mesh.spawn)")
        if dist.get_world_size() != self.size:
            raise ValueError(f"{dist.get_world_size()} processes for a mesh "
                             f"of {self.size} positions")
        self.rank = dist.get_rank()
        self.local = (self.rank,)
        self.device = self.devices[self.rank]
        self.backend = dist.get_backend()
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.sent = collections.Counter()
        self.process_groups: Dict[tuple, object] = {}
        names = self.axis_names
        for n in range(1, len(names) + 1):
            for axes_ in itertools.combinations(names, n):
                for g in self.groups(axes_):
                    if len(g) > 1 and tuple(g) not in self.process_groups:
                        self.process_groups[tuple(g)] = dist.new_group(g)

    def __repr__(self) -> str:
        return f"ProcessMesh({self.shape}, rank={self.rank})"


def _wire(mesh: ProcessMesh, x):
    """Contiguous `x` as the backend moves it: on the host as bytes under
    gloo (a card's tensor staged), as it is under NCCL."""
    wire = x.cpu() if mesh.staged else x
    return wire.reshape(-1).view(torch.uint8) if mesh.backend == "gloo" \
        else wire


def _empty_wire(mesh: ProcessMesh, shape, dtype):
    """A receive buffer for a tensor of `shape` and `dtype` as the backend
    moves it (`_wire`)."""
    if mesh.backend == "gloo":
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        return torch.empty(n, dtype=torch.uint8)
    return torch.empty(shape, dtype=dtype, device=mesh.device)


def _unwire(w, dtype, shape, device):
    """A received wire buffer as a tensor of `dtype` and `shape` on
    `device`."""
    return w.view(dtype).reshape(shape).to(device)


def _fetch(mesh: ProcessMesh, group, t):
    """The tensors like `t` that the positions of `group` (ascending, this
    process's among them) hold, in group order: all-gathered over the
    group's processes."""
    src = t.detach().contiguous()
    if len(group) == 1:
        return [src]
    wire = _wire(mesh, src)
    bufs = [torch.empty_like(wire) for _ in group]
    dist.all_gather(bufs, wire, group=mesh.process_groups[tuple(group)])
    return [_unwire(b, src.dtype, src.shape, src.device) for b in bufs]


def _exchange(mesh: ProcessMesh, t, dst: int, src: int):
    """Send `t` to position `dst` and receive a tensor like it from
    position `src`."""
    if dst == mesh.rank:
        return t
    x = t.detach().contiguous()
    wire = _wire(mesh, x)
    buf = torch.empty_like(wire)
    for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, wire, dst),
                                     dist.P2POp(dist.irecv, buf, src)]):
        w.wait()
    return _unwire(buf, x.dtype, x.shape, x.device)


def gather_values(mesh: ProcessMesh, t) -> list:
    """Every position's tensor like `t` (a loss value, a metric), in
    position order, with no gradient and not counted: the bookkeeping a
    single controller does on one device."""
    return _fetch(mesh, list(range(mesh.size)), t)


def sum_processes(mesh: ProcessMesh, ts: list) -> None:
    """Each tensor of the list `ts` replaced by its sum over the processes
    in position order, the same sum on every rank (the data-parallel
    gradient sum that a single controller's autograd makes in the leaf;
    not counted). A reduce-scatter and an all-gather (`_sum_group`). One
    tensor at a time, the tensor it replaces dropped from the list."""
    for i, t in enumerate(ts):
        ts[i] = _sum_group(mesh, list(range(mesh.size)), t)[0]


def _sum_group(mesh: ProcessMesh, group, t):
    """The sum of the tensors like `t` that the processes of `group`
    (ascending, this process's among them) hold, in position order, on
    each of them: rank r of the group receives every member's r-th of the
    flattened tensor (an all-to-all), adds them in order, and the sums
    are all-gathered, so each process sends and receives twice (k - 1) /
    k of the tensor (k members) where an all-gather of the whole would
    move k - 1 times it. Returns the bytes sent too."""
    k = len(group)
    if k == 1:
        return t.detach(), 0
    pg = mesh.process_groups[tuple(group)]
    flat = t.detach().reshape(-1)
    n = flat.numel()
    c = -(-n // k)
    wire = _wire(mesh, torch.nn.functional.pad(flat, (0, c * k - n)))
    got = torch.empty_like(wire)
    dist.all_to_all_single(got, wire, group=pg)
    mine = None
    for piece in got.chunk(k):             # member q's r-th, in order
        piece = _unwire(piece, t.dtype, (c,), t.device)
        mine = piece if mine is None else mine + piece
    sums = torch.empty_like(wire)
    dist.all_gather(list(sums.chunk(k)), _wire(mesh, mine), group=pg)
    sent = 2 * (k - 1) * c * t.element_size()
    return _unwire(sums, t.dtype, (c * k,), t.device)[:n].reshape(
        t.shape), sent


def broadcast_record(mesh: ProcessMesh, record=None):
    """Position 0's `record` (a small picklable object) on every process;
    the others pass None. Not counted."""
    box = [record]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def scatter_rows(mesh: ProcessMesh, pieces, out):
    """Position 0's `pieces` (one tensor a position, all alike) scattered
    over the processes: position 0 passes them and gets its own back;
    every other process passes None and receives its piece into `out` (a
    tensor like it), which it returns. Not counted."""
    if mesh.rank == 0:
        wires = [_wire(mesh, p.detach().contiguous()) for p in pieces]
        dist.scatter(torch.empty_like(wires[0]), wires, src=0)
        return pieces[0]
    buf = _empty_wire(mesh, out.shape, out.dtype)
    dist.scatter(buf, None, src=0)
    out.copy_(_unwire(buf, out.dtype, out.shape, out.device))
    return out


def gather_rows(mesh: ProcessMesh, t):
    """Every position's tensor like `t` at position 0, in position order
    (None on the other processes). Not counted."""
    x = t.detach().contiguous()
    wire = _wire(mesh, x)
    bufs = ([torch.empty_like(wire) for _ in range(mesh.size)]
            if mesh.rank == 0 else None)
    dist.gather(wire, bufs, dst=0)
    if bufs is None:
        return None
    return [_unwire(b, x.dtype, x.shape, x.device) for b in bufs]


def send_to(mesh: ProcessMesh, t, dst: int) -> None:
    """Send `t` (on the host or the process's device) to position `dst`,
    point to point. Not counted."""
    x = t.detach().contiguous()
    if mesh.backend != "gloo":
        x = x.to(mesh.device)
    dist.send(_wire(mesh, x), dst)


def recv_from(mesh: ProcessMesh, shape, dtype, src: int, device):
    """A tensor of `shape` and `dtype` on `device` from position `src`
    (`send_to`'s other end). Not counted."""
    buf = _empty_wire(mesh, shape, dtype)
    dist.recv(buf, src)
    return _unwire(buf, dtype, shape, device)


def _axes(axis):
    return (axis,) if isinstance(axis, str) else tuple(axis)


# ---------------------------------------------------------------------------
# Blocks: each process's share of a tensor under a layout
# ---------------------------------------------------------------------------

def _split_axes(mesh: Mesh, layout) -> tuple:
    """The axes of more than one position that `layout` splits over, in
    the mesh's order."""
    named = {a for e in layout if e is not None for a in _axes(e)}
    return tuple(a for a in mesh.axis_names
                 if a in named and mesh.shape[a] > 1)


def block_of(mesh: Mesh, pos: int, layout) -> tuple:
    """Position `pos`'s block under `layout` (a tuple with an entry per
    leading dimension: None, an axis name or a tuple of names, the
    reference's `PartitionSpec`): for each dimension (index, pieces), the
    first named axis the most significant."""
    out = []
    for e in layout:
        i, n = 0, 1
        for a in (() if e is None else _axes(e)):
            i, n = i * mesh.shape[a] + mesh.coord(pos, a), n * mesh.shape[a]
        out.append((i, n))
    return tuple(out)


def block_slices(mesh: Mesh, pos: int, layout, shape) -> tuple:
    """Position `pos`'s block of a whole tensor of `shape` under `layout`:
    a slice for each dimension the layout names (raises where its axes do
    not divide the dimension)."""
    out = []
    for d, (i, n) in enumerate(block_of(mesh, pos, layout)):
        if shape[d] % n:
            raise ValueError(f"layout {layout} splits dimension {d} of "
                             f"{tuple(shape)} into {n}")
        c = shape[d] // n
        out.append(slice(i * c, (i + 1) * c))
    return tuple(out)


def shard(mesh: ProcessMesh, t, layout):
    """This process's block of the whole tensor `t` under `layout`, a copy
    (the whole tensor can be freed); `t` itself, not a copy, where the
    layout splits nothing on `mesh` (a leaf held whole costs no second
    copy). The result may so alias `t`: a caller that updates it in place
    (AdamW's parameters and moments) and goes on using `t` shards a copy
    of `t`."""
    if not _split_axes(mesh, layout):
        return t
    (pos,) = mesh.local
    return t[block_slices(mesh, pos, layout, t.shape)].clone()


def _within(inner, outer, shape) -> tuple:
    """The slices `inner` of a tensor of `shape` relative to the block
    `outer` (slices of the same tensor) that holds them; raises where it
    does not."""
    out = []
    for d, s in enumerate(inner):
        o = outer[d] if d < len(outer) else slice(0, shape[d])
        if s.start < o.start or s.stop > o.stop:
            raise ValueError(f"block {inner} of {tuple(shape)} is not inside "
                             f"{outer}")
        out.append(slice(s.start - o.start, s.stop - o.start))
    return tuple(out)


def _block_shape(slices, shape) -> list:
    return [s.stop - s.start for s in slices] + list(shape[len(slices):])


def gather(mesh: ProcessMesh, block, layout, shape, use=()):
    """This process's block under the layout `use` (default: the whole
    tensor) of the tensor of `shape`, from every position's block under
    `layout` (this process's is `block`): an all-gather over the
    positions that differ along the axes `layout` splits over and `use`
    does not (not counted). `use` splits over none that `layout` does
    not: each block at rest lies inside a use block."""
    keep = _split_axes(mesh, use)
    axes = tuple(a for a in _split_axes(mesh, layout) if a not in keep)
    if not axes:
        return block
    (pos,) = mesh.local
    group = _group_of(mesh, axes, pos)
    mine = block_slices(mesh, pos, use, shape)
    out = block.new_empty(_block_shape(mine, shape))
    for q, b in zip(group, _fetch(mesh, group, block)):
        out[_within(block_slices(mesh, q, layout, shape), mine, shape)] = b
    mesh.sent["gather"] += (len(group) - 1) * block.numel() \
        * block.element_size()
    return out


def reduce_to_block(mesh: ProcessMesh, g, layout, use=()):
    """This process's block under `layout` of the sum of the tensors like
    `g` that the positions holding this process's block under `use`
    (default: the whole tensor, every position) hold, `g` this
    process's: each its gradient of that block. Added in position order
    as `sum_processes` adds, so each block is that sum's slice bit for bit
    (not counted). Among those positions, an all-to-all of blocks: each
    receives every holder's piece at its block and adds them in order.
    Where every holder's block under `layout` is the use block (a layout
    that splits nothing more), the holders sum the tensor through
    `_sum_group` instead. Where k > 1 holders hold each block at rest,
    every process sends k times the block's bytes: the all-to-all stays,
    since the configs have few such leaves."""
    (pos,) = mesh.local
    keep = _split_axes(mesh, use)
    holders = _group_of(mesh, tuple(a for a in mesh.axis_names
                                    if a not in keep), pos)
    shape = [s * n for s, (_, n) in zip(g.shape, block_of(mesh, pos, use))]
    shape += list(g.shape[len(shape):])
    if not [a for a in _split_axes(mesh, layout) if a not in keep]:
        out, sent = _sum_group(mesh, holders, g)
        mesh.sent["reduce"] += sent
        return out
    mine = block_slices(mesh, pos, use, shape)
    pieces = [_within(block_slices(mesh, q, layout, shape), mine, shape)
              for q in holders]
    src = torch.cat([g.detach()[c].reshape(-1) for c in pieces])
    wire = _wire(mesh, src)
    got = torch.empty_like(wire)
    dist.all_to_all_single(got, wire,
                           group=mesh.process_groups[tuple(holders)])
    k = len(holders)                        # each sends k - 1 of its k pieces
    mesh.sent["reduce"] += src.numel() // k * (k - 1) * g.element_size()
    del src, wire
    out_shape = _block_shape(block_slices(mesh, pos, layout, shape), shape)
    acc = None
    for piece in got.chunk(k):              # holder q's piece, in order
        piece = _unwire(piece, g.dtype, out_shape, g.device)
        acc = piece if acc is None else acc + piece
    return acc


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


def _apply(mesh: Mesh, run, transpose, xs):
    """`run` over the per-position list xs, under autograd with
    `transpose` as its backward; the autograd node holds the process's
    own positions' tensors."""
    loc = mesh.local

    def local(fn):
        def go(ts):
            full: List = [None] * mesh.size
            for p, t in zip(loc, ts):
                full[p] = t
            out = fn(full)
            return [out[p] for p in loc]
        return go

    ins = [xs[p] for p in loc]
    if torch.is_grad_enabled() and any(x.requires_grad for x in ins):
        outs = _Collective.apply(local(run), local(transpose), *ins)
    else:
        outs = local(run)(ins)
    full: List = [None] * mesh.size
    for p, t in zip(loc, outs):
        full[p] = t
    return full


def _group_of(mesh: Mesh, axis, pos: int) -> List[int]:
    return next(g for g in mesh.groups(axis) if pos in g)


def _per_group(mesh: Mesh, axis, xs, combine):
    """`combine(list of the group's tensors on one device)` for each group
    along `axis`, computed once per device of the group and handed to
    every member on it; on a process mesh each process fetches its
    group's tensors and combines them itself."""
    out: List = [None] * mesh.size
    if mesh.procs:
        for p in mesh.local:
            out[p] = combine(_fetch(mesh, _group_of(mesh, axis, p), xs[p]))
        return out
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
    _count(registry, "all-gather", out)
    return out


def _scatter(mesh, xs, axis, dim, registry):
    out: List = [None] * mesh.size
    for group in mesh.groups(axis):
        mine = [p for p in group if p in mesh.local]
        if not mine:
            continue
        n = len(group)
        size = xs[mine[0]].shape[dim]
        if size % n:
            raise ValueError(f"reduce-scatter of {size} along dim {dim} "
                             f"over a group of {n}")
        c = size // n
        whole = (_fetch(mesh, group, xs[mine[0]]) if mesh.procs
                 else [xs[q] for q in group])
        for i, p in enumerate(group):
            if p in mine:
                dev = mesh.devices[p]
                out[p] = _sum([x.narrow(dim, i * c, c).to(dev)
                               for x in whole])
    _count(registry, "reduce-scatter", out)
    return out


def _reduce(mesh, xs, axis, registry):
    out = _per_group(mesh, axis, xs, _sum)
    _count(registry, "all-reduce", out)
    return out


def _permute(mesh, xs, axis, perm, registry):
    dst_of = dict(perm)
    out: List = [None] * mesh.size
    if mesh.procs:
        src_of = {dst: src for src, dst in perm}
        for p in mesh.local:
            c = mesh.coord(p, axis)
            out[p] = _exchange(mesh, xs[p], mesh.shift(p, axis, dst_of[c]),
                               mesh.shift(p, axis, src_of[c]))
    else:
        for p in range(mesh.size):
            q = mesh.shift(p, axis, dst_of[mesh.coord(p, axis)])
            out[q] = xs[p].to(mesh.devices[q])
    _count(registry, "collective-permute", out)
    return out


def all_gather(mesh: Mesh, xs, axis: str, dim: int = 0, registry=None):
    """Each position's tensor concatenated with its group's along `dim`,
    in axis order (`lax.all_gather(..., tiled=True)`); the backward is the
    reduce-scatter of the gradients."""
    if mesh.group_size(axis) == 1:
        return list(xs)
    return _apply(mesh, lambda ts: _gather(mesh, ts, axis, dim, registry),
                  lambda gs: _scatter(mesh, gs, axis, dim, registry), xs)


def reduce_scatter(mesh: Mesh, xs, axis: str, dim: int = 0, registry=None):
    """The sum over each group along `axis`, of which the position of
    index i in the group keeps chunk i along `dim` (`lax.psum_scatter(...,
    scatter_dimension=dim, tiled=True)`); the backward is the all-gather
    of the gradients."""
    if mesh.group_size(axis) == 1:
        return list(xs)
    return _apply(mesh, lambda ts: _scatter(mesh, ts, axis, dim, registry),
                  lambda gs: _gather(mesh, gs, axis, dim, registry), xs)


def all_reduce(mesh: Mesh, xs, axis, op: str, registry=None):
    """Elementwise "sum", "max" or "min" over each group along `axis`
    (`lax.psum`, `lax.pmax`, `lax.pmin`); the sum adds in axis order and
    its backward is the sum of the gradients. "max" and "min" (the
    serving argmax) take no gradient."""
    if mesh.group_size(axis) == 1:
        return list(xs)
    if op == "sum":
        return _apply(mesh, lambda ts: _reduce(mesh, ts, axis, registry),
                      lambda gs: _reduce(mesh, gs, axis, registry), xs)
    fn = {"max": torch.maximum, "min": torch.minimum}[op]

    def combine(ts):
        acc = ts[0]
        for t in ts[1:]:
            acc = fn(acc, t)
        return acc

    out = _per_group(mesh, axis, xs, combine)
    _count(registry, "all-reduce", out)
    return out


def permute(mesh: Mesh, xs, axis: str, perm, registry=None):
    """`lax.ppermute` along `axis`: for each (src, dst) of `perm`, the
    tensors of index src go to the positions of index dst (the other
    coordinates kept). Every index must be a destination once. The
    backward sends the gradients back by the inverse permutation."""
    if mesh.shape[axis] == 1:
        return list(xs)
    back = [(dst, src) for src, dst in perm]
    return _apply(mesh, lambda ts: _permute(mesh, ts, axis, perm, registry),
                  lambda gs: _permute(mesh, gs, axis, back, registry), xs)
