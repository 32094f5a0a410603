"""Tensor parallelism over a mesh's 'model' axis: the reference's
`src/repro/models/tp.py`. Every function takes and returns one tensor per
mesh position (`repro_torch.mesh.Mesh`) and moves data only through the
mesh's collectives, which count their bytes into the registry when given.

Serving (docs/sharding.md, "The tensor-parallel head"): `gather_seq_local`
and `vocab_parallel_argmax`.

Training (Megatron tensor and sequence parallelism): `Layout` lays one
step's (B, S) batch over the positions: the batch splits over the
runtime's `batch_axes` (one batch shard per group of 'model' positions),
and the residual stream at each layer boundary is sharded over 'model'
along the sequence, (B/shards, S/model, d) a position, when `Layout.seq`
holds (a 'model' axis of more than one position, `seq_shard`, not
`dp_only`, S divisible). `gather_seq` all-gathers a normed activation to
full S; a projection whose heads or ff columns split over 'model'
(`Layout.split`) multiplies its local shard and `out_proj_rs`
reduce-scatters the partial products back along the sequence. Where a
rule does not hold (the reference's `usable` fall-backs) every position
computes the projection whole and keeps its own chunk of the sequence.
A per-row statistic over a width split over 'model' (Mamba2's gated RMS
norm over its heads' channels) is summed over the group by `sum_model`.

Decode (`Layout(..., decode=True)`, the whole-batch serve step of
every family): one token a row has no sequence to shard, so the
residual is whole on every 'model' position of a batch shard, a
projection over heads, ff columns or Mamba2 and RWKV6 state heads that
'model' divides splits as in training, and its partial products close
with `sum_model` instead of a reduce-scatter; no weight is gathered over
'data'. A batch that the batch axes do not divide stays whole on them
(the reference's `_sanitize_spec`): every shard then holds every row.
With `Runtime.flash_decode` each 'model' position of a shard holds a
contiguous 1/model of every KV ring's slots and of every cross KV's N
tokens, where 'model' divides them (`flash_split`, `Layout.ring_split`).
On the single controller the parameters stay whole, one tensor a leaf:
a position's shard is a slice of it (`take`), so autograd's
accumulation into the leaf is the data-parallel gradient sum, which
moves no bytes between positions of one device and is not counted.

On a process mesh (`mesh.ProcessMesh`, one process a position, the
training step and the decode step of every family) every process runs
its own position; the lists hold a tensor at that position only. It
holds each parameter leaf under its path's use layout
(`launch.specs.use_layouts`): its 'model' block where the position reads
exactly that block, else the whole leaf. Every read of a leaf that may
be a block goes through `take`, which slices a whole leaf (the single
controller, a leaf held whole) and passes a held block as it is. What
runs once a batch shard on the single controller (the cut codec, the lm
head and the loss, at `reps[b]`) runs at every position of the shard,
on inputs equal to the representative's, so no row moves for it
(`Layout.held`); `launch.steps` weighs the copies so that only the
representative's reaches the gradient, and sums the gradients of the
processes that hold each block (the data-parallel sum, not counted
either). A decode layout holds the same rows and state on a process
mesh as on the single controller: a process builds its own position's
cache only.
"""
from __future__ import annotations

import torch

from repro_torch import mesh as mesh_mod
from repro_torch.mesh import Mesh

INT32_MAX = torch.iinfo(torch.int32).max


class Layout:
    """How one training step of (B, S) tokens, or one decode step of B
    rows, lies on `rt.mesh`.

    `groups[b]` are the positions of batch shard b (its 'model' group, or
    the one position under `dp_only` or without a 'model' axis), shards in
    the batch's row order; `reps[b]` is the shard's first position, where
    a computation that runs once a shard (the cut codec, the lm head and
    the loss) runs. On the single controller every position must lie on
    one device: the parameters stay whole there. `decode`: one token a
    row (see the module docstring); `whole` then says whether every shard
    holds the whole batch."""

    def __init__(self, rt, batch: int, seq: int, *, decode: bool = False):
        mesh = rt.mesh
        if not mesh.procs and len(set(mesh.devices)) != 1:
            raise ValueError("the training mesh keeps whole parameters on "
                             "one device: every position must lie on it "
                             "(several cards take a process mesh, "
                             "launch.mesh.spawn)")
        self.rt, self.mesh, self.registry = rt, mesh, rt.registry
        tp = rt.has_model_axis and not rt.dp_only
        self.n_model = mesh.shape["model"] if tp else 1
        self.groups = (mesh.groups("model") if tp
                       else [[p] for p in range(mesh.size)])
        self.reps = [g[0] for g in self.groups]
        self.shard_of = {p: b for b, g in enumerate(self.groups) for p in g}
        self.decode = decode
        self.whole = decode and batch % len(self.groups) != 0
        if batch % len(self.groups) and not decode:
            raise ValueError(f"batch {batch} does not split over "
                             f"{len(self.groups)} batch shards of {mesh}")
        self.b_loc = batch if self.whole else batch // len(self.groups)
        self.seq = (not decode and self.n_model > 1 and rt.seq_shard
                    and seq % self.n_model == 0)
        self.flash = decode and rt.flash_decode and self.n_model > 1
        axes = rt.batch_axes or ()
        # the batch shards as a mesh over `batch_axes` (position b = shard
        # b, on its representative's device), for the pod ring; a process
        # mesh runs the ring over its own positions (`protocol`)
        self.shards = None if mesh.procs else Mesh(
            [mesh.shape[a] for a in axes], axes,
            [mesh.devices[r] for r in self.reps])

    def held(self):
        """(shard b, the position that runs its once-a-shard work: the cut
        codec, the lm head and the loss) for each batch shard this process
        runs: every shard at its representative on the single controller,
        the process's own shard at its own position on a process mesh
        (every position of a shard runs the work on equal inputs, so no
        row moves)."""
        if self.mesh.procs:
            return [(self.shard_of[p], p) for p in self.mesh.local]
        return list(enumerate(self.reps))

    def shard_batch(self, batch):
        """The batch dict split along its rows into one dict a batch
        shard, shards in row order, each a view of its rows (the whole
        batch for every shard when `whole`)."""
        if self.whole:
            return [batch] * len(self.groups)
        b = self.b_loc
        return [{k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                for i in range(len(self.groups))]

    def rank(self, p: int) -> int:
        """Position `p`'s index along 'model' (0 without tensor
        parallelism)."""
        return self.mesh.coord(p, "model") if self.n_model > 1 else 0

    def split(self, n: int) -> bool:
        """Whether a projection over `n` heads or ff columns (or the
        decode head's vocab) splits over 'model' (the reference's
        `out_proj_rs` rule, with the sequence sharded at the layer
        boundary; in decode wherever 'model' divides `n`)."""
        return ((self.seq or self.decode and self.n_model > 1)
                and n % self.n_model == 0)

    def ring_split(self, size: int) -> bool:
        """Whether a decode KV of `size` slots or tokens (a ring, or a
        cross KV's N tokens) splits over 'model' (`flash_split`); else
        every position keeps all of it, the reference's replication."""
        return flash_split(self.flash, self.n_model, size)

    def local_seq(self, p: int, y):
        """Position `p`'s chunk of the sequence (dim 1) of a whole
        (B_loc, S, ...) tensor, or all of it without sequence
        parallelism."""
        if not self.seq:
            return y
        c = y.shape[1] // self.n_model
        return y[:, self.rank(p) * c:(self.rank(p) + 1) * c]


def take(lay, p: int, w, dim: int, n: int):
    """Position `p`'s `n` entries of the parameter `w` along `dim`, where
    the position reads its 'model' block of them (n = the whole size / the
    'model' positions), or all of them (n = the whole size): `w` narrowed
    to the block at the position's 'model' rank where `w` holds the 'model'
    positions' n each (the whole leaf: the single controller, or a leaf a
    process holds whole), `w` itself where it holds n (the block a process
    holds, or a whole leaf read whole). `lay`: a `Layout`, or a serving
    `Mesh` (its 'model' axis). Any other size raises: a leaf held as a
    block where the path reads more than the block
    (`launch.specs.use_layouts` wrong) fails instead of computing
    something else."""
    if isinstance(lay, Mesh):
        m = lay.shape.get("model", 1)
        rank = lay.coord(p, "model") if m > 1 else 0
    else:
        m, rank = lay.n_model, lay.rank(p)
    size = w.shape[dim]
    if size == n * m:
        return w.narrow(dim, rank * n, n)
    if size == n:
        return w
    raise ValueError(f"a parameter of {tuple(w.shape)} read as {n} of "
                     f"dimension {dim} at position {p} ('model' "
                     f"{m}): neither the whole leaf nor its block")


def flash_split(flash: bool, n_model: int, size: int) -> bool:
    """The flash-decode rule, one for the cache, the step and
    `roofline.analysis.decode_collective_costs`: a decode KV of `size`
    slots or tokens splits over a 'model' axis of `n_model` positions,
    a contiguous 1/n_model a position, with flash decode on, more than
    one position and `size` divisible (the reference's `_sanitize_spec`
    keeps a dimension the axis does not divide whole)."""
    return flash and n_model > 1 and size % n_model == 0


def gather_seq_local(mesh, blocks, axis_name: str = "model",
                     registry=None):
    """The Megatron-SP gather of the serving arena: each position's row
    block concatenated with its `axis_name` group's, in the activation
    dtype it came in (the caller applies the final norm first). Rows stand
    in for the sequence axis of the reference's (B, S/model, d)
    activation."""
    return mesh_mod.all_gather(mesh, blocks, axis_name, dim=0,
                               registry=registry)


def gather_seq(lay: Layout, ys):
    """Each position's normed (B_loc, S/model, d) activation all-gathered
    over 'model' to full S, in the dtype it came in (after the norm, as
    the reference pins it); the backward reduce-scatters. Without
    sequence parallelism the activations are whole already."""
    if not lay.seq:
        return list(ys)
    return mesh_mod.all_gather(lay.mesh, ys, "model", dim=1,
                               registry=lay.registry)


def out_proj_rs(lay: Layout, hs, w, *, split: bool,
                w_spec=("model", "data")):
    """hs: per position (B_loc, S, n) with n the local shard of w's rows
    when `split`, else all of them; w: the (N, d) weight, whole or the
    position's 'model' block of its rows (`take`). Returns per position
    (B_loc, S/model, d): the partial products over the local shard
    reduce-scattered along the sequence (`out_proj_rs_local`), or,
    without `split`, the whole product's chunk of the sequence. In
    decode the partial products are summed over 'model' (`sum_model`)."""
    def rows(p, h):
        return take(lay, p, w, 0, h.shape[-1])

    if not split:
        return mesh_mod.pmap(lambda p, h: lay.local_seq(
            p, h @ rows(p, h).to(h.dtype)), hs)
    if lay.decode:
        return sum_model(lay, mesh_mod.pmap(
            lambda p, h: h @ rows(p, h).to(h.dtype), hs))
    return out_proj_rs_local(lay, hs, mesh_mod.pmap(rows, hs),
                             w_spec=w_spec)


def out_proj_rs_local(lay: Layout, hs, ws, *, w_spec=("model", "data")):
    """Per position: the local ff or head shard's partial product h @ w,
    reduce-scattered over 'model' along the sequence. With 'data' in
    `w_spec` the weight's 'data' shard (each position's slice of its
    local rows) is all-gathered over 'data' first, in the parameter
    dtype, as the reference gathers an FSDP-sharded weight
    (`src/repro/models/tp.py:82-93`)."""
    mesh = lay.mesh
    if "data" in w_spec and mesh.shape.get("data", 1) > 1:
        axis, n_data = w_spec.index("data"), mesh.shape["data"]
        if mesh_mod.first(ws).shape[axis] % n_data == 0:
            c = mesh_mod.first(ws).shape[axis] // n_data
            ws = mesh_mod.all_gather(
                mesh, mesh_mod.pmap(lambda p, w: w.narrow(
                    axis, mesh.coord(p, "data") * c, c), ws), "data",
                dim=axis, registry=lay.registry)
    ys = mesh_mod.pmap(lambda p, h, w: h @ w.to(h.dtype), hs, ws)
    return mesh_mod.reduce_scatter(mesh, ys, "model", dim=1,
                                   registry=lay.registry)


def sum_model(lay: Layout, xs):
    """Each position's tensor summed over its 'model' group (an all-reduce
    sum, in the dtype it came in); the backward sums the gradients the
    same way. Without tensor parallelism each position's tensor is its
    own sum."""
    if lay.n_model == 1:
        return list(xs)
    return mesh_mod.all_reduce(lay.mesh, xs, "model", "sum",
                               registry=lay.registry)


def vocab_parallel_argmax(mesh, logits, axis_name: str = "model",
                          registry=None):
    """Exact greedy argmax over a vocab sharded along `axis_name`: each
    position holds a contiguous (rows, V/model) column shard, shard i
    starting at column i * V/model.

      1. per-shard max and argmax (first occurrence), plus the shard's
         base column;
      2. the global max over the group (an all-reduce max; the maxima
         travel as f32, exact for any narrower float);
      3. shards whose max equals it propose their index, the others
         INT32_MAX; the group's minimum proposal is the lowest global
         column attaining the max — `torch.argmax`'s first occurrence over
         the whole padded vocab.

    Returns int32 (rows,) per position, equal across each group."""
    v_local = mesh_mod.first(logits).shape[-1]
    local_max = mesh_mod.pmap(lambda _, x: x.amax(dim=-1).float(), logits)
    global_max = mesh_mod.all_reduce(mesh, local_max, axis_name, "max",
                                     registry=registry)

    def propose(p, x):
        base = mesh.coord(p, axis_name) * v_local
        idx = torch.argmax(x, dim=-1).to(torch.int32) + base
        return torch.where(local_max[p] == global_max[p], idx,
                           torch.full_like(idx, INT32_MAX))

    proposals = mesh_mod.pmap(propose, logits)
    return mesh_mod.all_reduce(mesh, proposals, axis_name, "min",
                               registry=registry)
