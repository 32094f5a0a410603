"""Production-mesh dry run: count every (architecture x input shape) on the
production meshes, print memory and cost, and emit roofline rows. The
port's `src/repro/launch/dryrun.py`.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --json out.json

The reference lowers and compiles each step through XLA on 512 fake
devices and reads the compiled program. The port has no compiler: it runs
the step itself on the `meta` device (nothing is allocated, no card is
touched) over `make_production_mesh(devices="meta")`, (16, 16) or (2, 16,
16), and counts what runs (`roofline.program.count_program`).

The single controller walks every position, so a full-depth walk at
(16, 16) costs minutes. `count_combo` counts a few small depths instead
(`depths`) and solves exactly for a constant part, one part per kind of
layer and, in training, a part in the square of the stacked depth
(`kinds`), evaluated at the configuration's depth: the port's
counterpart of the reference's loop trip counts (`hlo.py:86-100`).
The recurrent families' training and prefill steps also walk their scans
chunk by chunk (Mamba2's SSD, RWKV6's WKV), so there `count_combo` counts
a few sequence lengths as well (`seq_points`, whole multiples of the
chunk) and solves over the length the same way (`seq_terms`); where
zamba2's shared attention runs in query chunks at the shape's length, the
lengths are counted in query chunks too, of a few sizes. FLOPs,
bytes, collective bytes and the arguments' bytes come out exact; the peak
may not (remat holds one layer's recompute at a time).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import traceback
from fractions import Fraction
from typing import Dict, List, Tuple

import torch
from torch.utils._pytree import tree_leaves

import repro_torch.configs as configs
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import make_serve_step, make_train_step
from repro_torch.models.config import Runtime, SplitConfig
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.optim.adamw import adamw_init
from repro_torch.optim.adamw import tree_leaves as param_leaves
from repro_torch.roofline import analysis
from repro_torch.roofline.program import (CollectiveStats, ProgramCounts,
                                          collective_stats, count_program)
from repro_torch.split import model as split_model
from repro_torch.testing.clock import SYSTEM_CLOCK, Clock

_cut_for = configs.cut_for


def build_config(arch: str, shape_name: str, *, split: str = None, k: int = 64,
                 alpha: float = 0.1, cut: int = -1):
    cfg = configs.get(arch)
    shape = specs_mod.SHAPES[shape_name]
    cfg = specs_mod.adapt_config(cfg, shape)
    if split:
        cut_layer = cut if cut > 0 else _cut_for(cfg)
        cfg = cfg.with_(split=SplitConfig(
            cut_layer=cut_layer, compressor=split, k=k, alpha=alpha))
    return cfg, shape


@dataclasses.dataclass
class Counted:
    """One step's counts (`ProgramCounts`), its arguments' bytes (every
    position's, on the one device) and, for decode, the collective bytes
    of building its cache (whisper's encoder output over the pod ring),
    apart from the step's."""

    counts: ProgramCounts
    args_bytes: int
    cache_collectives: CollectiveStats


def _storage_bytes(tree) -> int:
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def count_one(cfg, shape, mesh,
              attn_chunk: int = Runtime.attn_chunk) -> Counted:
    """Run one (cfg, shape, mesh) step on `meta` under `count_program`, in
    place of the reference's `lower_one`, with its `Runtime` defaults:
    training through `make_train_step` (sequence parallelism on), prefill
    through `split.model.forward` without autograd, decode through
    `make_serve_step` (flash decode on, sequence parallelism off). A batch
    the batch axes do not divide (long_500k's B 1) stays whole on them,
    and a KV that 'model' does not divide (the vlm's 1601 patches) whole
    on every position (`tp.Layout`, `tp.flash_split`). `attn_chunk`:
    the query chunk of attention (`Runtime.attn_chunk`)."""
    rt = Runtime(mesh=mesh, training=(shape.kind == "train"),
                 seq_shard=(shape.kind != "decode"),
                 attn_chunk=attn_chunk, registry=MetricsRegistry())
    cache_reg = MetricsRegistry()
    if shape.kind == "train":
        args = specs_mod.train_specs(cfg, shape)
        step = make_train_step(cfg, rt)
        draws = torch.Generator().manual_seed(0)   # RandTopK's, on the CPU
        run = lambda: step(*args, draws)  # noqa: E731
    elif shape.kind == "prefill":
        args = (specs_mod.abstract_params(cfg),
                specs_mod.batch_specs(cfg, shape))

        @torch.no_grad()
        def run():
            return split_model.forward(args[0], cfg, rt, args[1])[0]
    else:
        args = specs_mod.decode_specs(
            cfg, shape, dataclasses.replace(rt, registry=cache_reg))
        step = make_serve_step(cfg, rt)
        run = lambda: step(*args)  # noqa: E731
    with count_program(rt.registry) as counts:
        run()
    return Counted(counts, _storage_bytes(args), collective_stats(cache_reg))


def device_args_bytes(cfg, mesh, kind: str) -> int:
    """One device's argument bytes on `mesh`: the bytes of its blocks of
    the parameters (`specs.param_shardings`) and, for a train step, of
    both AdamW moments (`specs.opt_shardings`), the layouts a process
    mesh holds. The counterpart of the reference's
    `memory_analysis().argument_size_in_bytes`, less the batch's and the
    decode cache's shards and the step counter."""
    rt = Runtime(mesh=mesh)
    params = specs_mod.abstract_params(cfg)
    lay = specs_mod.param_shardings(cfg, rt, params)
    total = specs_mod.block_bytes(params, lay, mesh.shape)
    if kind == "train":
        opt = adamw_init(params)
        olay = specs_mod.opt_shardings(cfg, rt, params)
        total += sum(specs_mod.block_bytes(opt[k], olay[k], mesh.shape)
                     for k in ("mu", "nu"))
    return total


def device_use_bytes(cfg, mesh, kind: str) -> int:
    """One device's bytes of the parameters while a step of `kind` runs
    on `mesh`: its blocks under `specs.use_layouts` ("train" for a train
    or prefill step, "decode" for a decode step), what a process mesh's
    step holds: the 'model' block of each leaf its position reads as one,
    the whole of every other."""
    rt = Runtime(mesh=mesh, seq_shard=(kind != "decode"))
    params = specs_mod.abstract_params(cfg)
    uses = specs_mod.use_layouts(
        cfg, rt, "decode" if kind == "decode" else "train", params)
    return specs_mod.block_bytes(params, uses, mesh.shape)


def procs_step_bytes(cfg, mesh, seq: int = None) -> Dict[str, int]:
    """What one process of a process mesh of `mesh`'s shape holds and
    sends in a train step at sequence length `seq` (`launch.steps`, the
    moves of `mesh.gather` and `mesh.reduce_to_block`), worked out from
    the layouts, nothing run: "rest" (its parameter blocks at rest),
    "held" (its use blocks, `specs.use_layouts(..., "train")`),
    "gather_sent" and "reduce_sent" (the bytes it sends to the other
    processes in the two moves), and "whole_held", "whole_gather_sent",
    "whole_reduce_sent": the same for a step that gathers every leaf
    whole and reduces each whole gradient over every process; and
    "decode_held" (`device_use_bytes`) and "arena_held": its use blocks
    while decoding and in the serving arena."""
    rt = Runtime(mesh=mesh)
    params = specs_mod.abstract_params(cfg)
    rests = specs_mod.param_shardings(cfg, rt, params)
    uses = specs_mod.use_layouts(cfg, rt, "train", params, seq=seq)
    out = dict.fromkeys(("rest", "held", "gather_sent", "reduce_sent",
                         "whole_held", "whole_gather_sent",
                         "whole_reduce_sent"), 0)
    for t, rest, use in zip(*map(param_leaves, (params, rests, uses))):
        out["rest"] += specs_mod.block_bytes(t, rest, mesh.shape)
        for pre, u in (("", use), ("whole_", ())):
            held, gather, reduce = _moves(mesh, t, rest, u)
            out[pre + "held"] += held
            out[pre + "gather_sent"] += gather
            out[pre + "reduce_sent"] += reduce
    out["decode_held"] = device_use_bytes(cfg, mesh, "decode")
    out["arena_held"] = specs_mod.block_bytes(
        params, specs_mod.use_layouts(cfg, rt, "arena", params), mesh.shape)
    return out


def _moves(mesh, t, rest, use) -> Tuple[int, int, int]:
    """(use block bytes, gather's bytes sent, reduce's bytes sent) of one
    leaf `t` at rest under `rest`, used under `use`: the gather sends the
    rest block to each other holder of the use block whose rest block
    differs; the reduce's k holders of one use block exchange their
    pieces of each rest block (an all-to-all), or, where the rest block
    is the use block, sum it (twice (k - 1) / k of it, padded to k
    chunks)."""
    whole = t.numel() * t.element_size()
    rest_b, held = (specs_mod.block_bytes(t, lay, mesh.shape)
                    for lay in (rest, use))
    k = mesh.size * held // whole
    if rest_b == held:
        return held, 0, 2 * (k - 1) * -(-held // t.element_size() // k) \
            * t.element_size()
    return held, held - rest_b, (k - 1) * rest_b


# --------------------------------------------------------------------------
# Depth: a few small depths, solved for the configuration's
# --------------------------------------------------------------------------

def kinds(cfg, n_layers: int, train: bool) -> List[int]:
    """The terms a count at `n_layers` layers is a sum of, each a
    multiple of: 1 (the constant part: embedding, head, cut, optimizer
    of the unstacked leaves, whisper's encoder), then one entry per kind
    of layer, the vlm's groups of `cross_attn_every` (self layers and a
    cross layer), zamba2's Mamba2 layers without a shared-attention site
    and with one (the shared block), the layers elsewhere; and for a
    training step the square of the stacked depth (the groups for the
    vlm): autograd hands each layer's view of a stacked parameter a
    zero-filled gradient of the whole stack and adds it, so those bytes
    grow as the depth's square."""
    if cfg.family == "vlm":
        n = n_layers // cfg.cross_attn_every
        row = [1, n]
    elif cfg.family == "hybrid":
        n, sites = n_layers, n_layers // cfg.attn_every
        row = [1, n_layers - sites, sites]
    else:
        n = n_layers
        row = [1, n_layers]
    return row + [n * n] if train else row


def depths(cfg, train: bool) -> List[int]:
    """The smallest depths whose `kinds` rows are independent, as many as
    the terms: from 2 layers a step (the cut needs a layer on each side),
    for the vlm from two whole groups a group at a time (its cut is whole
    groups). The dense family trains at 2, 3, 4 and serves at 2, 3;
    zamba2 (a site every 6th layer) trains at 2, 3, 4, 6."""
    step = cfg.cross_attn_every if cfg.family == "vlm" else 1
    n_terms = len(kinds(cfg, 2 * step, train))
    out, n = [], 2 * step
    while len(out) < n_terms:
        if _rank([kinds(cfg, d, train) for d in out + [n]]) > len(out):
            out.append(n)
        n += step
    return out


def at_depth(cfg, n_layers: int):
    """`cfg` cut to `n_layers`, its cut (if any) at `configs.cut_for`."""
    out = cfg.with_(n_layers=n_layers)
    if cfg.split is not None and cfg.split.cut_layer > 0:
        out = out.with_(split=dataclasses.replace(
            cfg.split, cut_layer=_cut_for(out)))
    return out


def _values(c: Counted) -> Dict[str, int]:
    out = {"flops": c.counts.flops, "bytes": c.counts.bytes,
           "peak": c.counts.peak, "args": c.args_bytes}
    for pre, stats in (("coll:", c.counts.collectives),
                       ("cache:", c.cache_collectives)):
        out.update({pre + op: int(b) for op, b in stats.per_op_bytes.items()})
    return out


def _eliminate(rows):
    """Rows reduced over Fractions (Gauss-Jordan); returns them with the
    pivot columns."""
    a = [[Fraction(v) for v in r] for r in rows]
    pivots, i = [], 0
    for col in range(len(a[0]) if a else 0):
        piv = next((j for j in range(i, len(a)) if a[j][col] != 0), None)
        if piv is None:
            continue
        a[i], a[piv] = a[piv], a[i]
        for j in range(len(a)):
            if j != i and a[j][col] != 0:
                f = a[j][col] / a[i][col]
                a[j] = [x - f * y for x, y in zip(a[j], a[i])]
        pivots.append(col)
        i += 1
    return a, pivots


def _rank(rows) -> int:
    return len(_eliminate([r + [0] for r in rows])[1]) if rows else 0


def _solve(rows, rhs):
    """x with rows x = rhs, exactly (square, independent rows)."""
    a, _ = _eliminate([r + [b] for r, b in zip(rows, rhs)])
    return [a[i][-1] / a[i][i] for i in range(len(rows))]


def _combine(rows, counted: List[Counted], target, what: str) -> Counted:
    """The counts at the term values `target` from `counted`, counted at
    the term values `rows`: exact for every count but the peak, which is
    rounded. Raises if a count that must be exact does not come out whole
    (a term the rows lack: a counting fault); `what` names the solve."""
    vals = [_values(c) for c in counted]
    out = {}
    for key in set().union(*vals):
        coef = _solve(rows, [v.get(key, 0) for v in vals])
        x = sum(c * t for c, t in zip(coef, target))
        if key != "peak" and x.denominator != 1:
            raise ValueError(f"{key} is not a sum of {len(rows)} terms of "
                             f"the {what}: {x}")
        out[key] = round(x)

    def ops(pre):
        return CollectiveStats({k[len(pre):]: float(v)
                                for k, v in out.items()
                                if k.startswith(pre) and v})
    return Counted(ProgramCounts(flops=out["flops"], bytes=out["bytes"],
                                 peak=out["peak"],
                                 collectives=ops("coll:")),
                   out["args"], ops("cache:"))


def extrapolate(cfg, counted: Dict[int, Counted], train: bool) -> Counted:
    """The counts at `cfg.n_layers` from counts at the depths of
    `counted` (`depths(cfg, train)`), by `_combine`."""
    ds = sorted(counted)
    return _combine([kinds(cfg, d, train) for d in ds],
                    [counted[d] for d in ds],
                    kinds(cfg, cfg.n_layers, train),
                    f"depth: at {cfg.n_layers} from depths {ds}")


# --------------------------------------------------------------------------
# Sequence length: the recurrent scans' chunks, solved the same way
# --------------------------------------------------------------------------

def scan_chunk(cfg) -> int:
    """The chunk length of the family's recurrent scan (`Runtime`
    defaults, as `count_one` runs them), 0 where it has none."""
    rt = Runtime()
    return {"hybrid": rt.ssm_chunk, "ssm": rt.rwkv_chunk}.get(cfg.family, 0)


def chunked(cfg, seq: int, attn_chunk: int) -> bool:
    """Whether zamba2's shared attention attends `seq` tokens one query
    chunk of `attn_chunk` at a time (`attention._attend`) rather than
    whole."""
    return (cfg.family == "hybrid" and seq > attn_chunk
            and seq % attn_chunk == 0)


def seq_terms(cfg, seq: int, train: bool,
              attn_chunk: int = Runtime.attn_chunk) -> List[int]:
    """The terms a training or prefill count at `seq` tokens is a sum of,
    each a multiple of: 1 (the parameters, the optimizer and every
    per-row op), the length (every per-token op; a scan's chunks, the
    same work each at a whole multiple of the chunk) and the length's
    square where attention runs (zamba2's shared block: the scores and
    the causal mask) or in training: the backward of each chunk's slice
    of the sequence is a zero-filled gradient of the whole sequence
    (autograd), added to the others, as the depth's square in `kinds`.
    Where the attention runs in n = seq / `attn_chunk` query chunks
    (`chunked`), a chunk's work is a part in chunk x seq (its scores and
    mask, so seq^2 over the chunks), one in the chunk (its output, which
    `torch.cat` copies: seq), one in seq (`sdpa` reads the whole k and v
    in every chunk, through their f32 copies and the products' layout
    copies; in training each chunk's backward also hands q its slice's
    gradient as a zero-filled whole and adds its k and v gradients,
    whole, to the others') and a constant: so n and seq x n are terms of
    their own."""
    row = [1, seq]
    if train or cfg.family == "hybrid":
        row.append(seq * seq)
    if chunked(cfg, seq, attn_chunk):
        n = seq // attn_chunk
        row += [n, seq * n]
    return row


def seq_points(cfg, mesh, seq: int, train: bool,
               attn_chunk: int = Runtime.attn_chunk) -> List[Tuple[int, int]]:
    """(length, query chunk) pairs to count at, as many as `seq_terms`
    has terms at `seq`: lengths whole multiples of the scan's chunk that
    'model' also divides (the sequence is sharded over it), from two
    chunks (a single chunk adds no slice gradients, which puts it off the
    terms' curve). Where the attention at `seq` is `chunked`, every pair
    is too, so that each count runs the program the solve extrapolates:
    the smallest lengths, each split into 2, 3, ... query chunks, that
    add a term's worth (a length gives two); else each length runs its
    attention whole (a chunk no shorter than it)."""
    unit = math.lcm(scan_chunk(cfg), mesh.shape.get("model", 1))
    n_terms = len(seq_terms(cfg, seq, train, attn_chunk))
    if not chunked(cfg, seq, attn_chunk):
        return [(unit * i, max(attn_chunk, unit * i))
                for i in range(2, n_terms + 2)]
    out, s = [], 2 * unit
    while len(out) < n_terms:
        for n in range(2, s // 2 + 1):
            if len(out) < n_terms and s % n == 0 and _rank(
                    [seq_terms(cfg, l, train, c) for l, c in out]
                    + [seq_terms(cfg, s, train, s // n)]) > len(out):
                out.append((s, s // n))
        s += unit
    return out


def count_depths(cfg, shape, mesh,
                 attn_chunk: int = Runtime.attn_chunk) -> Counted:
    """`count_one` at `depths` and `extrapolate`d to the configuration's
    depth, or counted directly where that depth is no deeper than
    them."""
    train = shape.kind == "train"
    ds = depths(cfg, train)
    if cfg.n_layers <= max(ds):
        return count_one(cfg, shape, mesh, attn_chunk)
    return extrapolate(cfg, {d: count_one(at_depth(cfg, d), shape, mesh,
                                          attn_chunk)
                             for d in ds}, train)


def count_combo(cfg, shape, mesh,
                attn_chunk: int = Runtime.attn_chunk) -> Counted:
    """`count_depths`, and for a recurrent family's training or prefill
    step longer than its `seq_points` that at each of them, solved for
    `shape.seq` over `seq_terms` (the peak rounded, as in
    `extrapolate`)."""
    if not scan_chunk(cfg) or shape.kind == "decode":
        return count_depths(cfg, shape, mesh, attn_chunk)
    train = shape.kind == "train"
    points = seq_points(cfg, mesh, shape.seq, train, attn_chunk)
    if shape.seq <= max(s for s, _ in points):
        return count_depths(cfg, shape, mesh, attn_chunk)
    return _combine(
        [seq_terms(cfg, s, train, c) for s, c in points],
        [count_depths(cfg, dataclasses.replace(shape, seq=s), mesh, c)
         for s, c in points],
        seq_terms(cfg, shape.seq, train, attn_chunk),
        f"sequence: at {shape.seq} from (length, chunk) {points}")


def run_combo(arch: str, shape_name: str, *, multi_pod=False, split=None,
              k=64, alpha=0.1, clock: Clock = SYSTEM_CLOCK, mesh=None):
    """`clock` (`testing.clock`) feeds the count-time report, injectable
    so tests can pin the printed timing. `mesh`: a `meta` mesh to count
    on instead of the production one."""
    cfg, shape = build_config(arch, shape_name, split=split, k=k, alpha=alpha)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, devices="meta")
    chips = mesh.size
    t0 = clock.monotonic()
    got = count_combo(cfg, shape, mesh)
    dt = clock.monotonic() - t0
    tokens = shape.batch * (shape.seq if shape.kind != "decode" else 1)
    mf = analysis.model_flops(cfg, tokens=tokens,
                              training=(shape.kind == "train"))
    roof = analysis.from_program(
        got.counts, arch=arch, shape=shape_name,
        mesh_desc="x".join(map(str, mesh.shape.values())), chips=chips,
        model_flops=mf, args_bytes=got.args_bytes)
    per_device = device_args_bytes(cfg, mesh, shape.kind)
    in_use = device_use_bytes(cfg, mesh, shape.kind)
    print(f"== {arch} x {shape_name} mesh={roof.mesh} "
          f"(count {dt:.1f}s) ==")
    print(f"  memory: args/device={per_device / 1e9:.2f}GB (the blocks "
          f"of the params{' and moments' if shape.kind == 'train' else ''}"
          f", per device) params/device in a step={in_use / 1e9:.2f}GB "
          f"(their use blocks) args={got.args_bytes / 1e9:.2f}GB "
          f"peak={roof.peak_memory / 1e9:.2f}GB (one device holding "
          f"every position: no per-chip peak)")
    r = roof.row()
    print(f"  cost: flops={r['hlo_flops']:.3e} "
          f"model_flops={r['model_flops']:.3e} "
          f"useful={r['useful_ratio']:.2f} bytes={roof.hlo_bytes:.3e}")
    print(f"  roofline: compute={r['t_compute_s']*1e3:.2f}ms "
          f"memory={r['t_memory_s']*1e3:.2f}ms "
          f"collective={r['t_collective_s']*1e3:.2f}ms "
          f"-> {r['bottleneck']}-bound")
    print("  collectives: " + ", ".join(
        f"{op}={b/1e9:.2f}GB" for op, b in r["coll_detail"].items()))
    return roof


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--split", default=None,
                    help="cut-layer compressor (randtopk/topk/...)")
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s) for a in configs.ARCHS for s in specs_mod.SHAPES]
    else:
        combos = [(args.arch, args.shape)]

    rows, failures = [], []
    for arch, shape in combos:
        try:
            roof = run_combo(arch, shape, multi_pod=args.multi_pod,
                             split=args.split, k=args.k, alpha=args.alpha)
            rows.append(roof.row())
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            failures.append((arch, shape, f"{type(e).__name__}: {e}"))

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"rows": rows, "failures": failures}, f, indent=1)
    print(f"\n{len(rows)} OK, {len(failures)} FAILED")
    for a, s, e in failures:
        print(f"  FAIL {a} x {s}: {e}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
