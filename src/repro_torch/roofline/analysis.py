"""Roofline terms and the serving closed forms of the reference's
`src/repro/roofline/analysis.py`, for one NVIDIA H100 SXM:

    compute    = FLOPs / (chips * peak FLOP/s)
    memory     = bytes / (chips * HBM bytes/s)
    collective = collective link bytes / link bytes/s

The closed forms (`active_param_count`, `model_flops`,
`top_matmul_params`, `serving_{decode,encode,step}_costs`,
`serving_collective_costs`, `serving_collective_slack`) and the bands
are the reference's, number for number. The reference fills `Roofline`
from a compiled program (`from_compiled`, with `roofline/hlo.py`); the
port has no compiler, so `from_program` fills it from a counted run
(`roofline/program.py`, the dry run's `launch/dryrun.py`).
`serving_collective_costs` predicts the collective bytes that one
sharded arena step counts (`repro_torch.mesh.collective_bytes`) exactly,
`training_collective_costs` those of one training step on a mesh
(`launch.steps.make_train_step` with `Runtime.mesh`), and
`decode_collective_costs` those of one whole-batch decode step on a mesh
(`launch.steps.make_serve_step` with `Runtime.mesh`) and
`decode_cache_collective_costs` those of building its cache, the port's
own.
"""
from __future__ import annotations

import dataclasses
import math
from collections import Counter
from typing import Dict

from repro_torch.models import tp
from repro_torch.split import protocol

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit
PEAK_FLOPS = 989e12          # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
LINK_BW = 450e9              # NVLink 4: 900 GB/s to the host's other
                             # cards, all to all; 450 GB/s each way

#: per-op ring factor: link bytes a device moves per raw byte of a
#: collective's output (the reference's `roofline.hlo.RING_FACTOR`)
RING_FACTOR = {
    "all-gather": 1.0,          # receives (N-1)/N of the gathered result
    "all-reduce": 2.0,          # reduce-scatter + all-gather phases
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float          # whole-program FLOPs (all chips)
    hlo_bytes: float          # whole-program bytes accessed
    coll_bytes: float         # per-chip link bytes
    coll_detail: Dict[str, float]
    model_flops: float = 0.0  # 6*N*D (or 6*N_active*D)
    peak_memory: float = 0.0  # bytes (from_program: one device, every
                              # position)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "hlo_flops": self.hlo_flops,
            "useful_ratio": self.useful_flops_ratio,
            "peak_mem_gb": self.peak_memory / 1e9,
            "coll_detail": self.coll_detail,
        }


def from_program(counts, *, arch: str, shape: str, mesh_desc: str,
                 chips: int, model_flops: float = 0.0,
                 args_bytes: int = 0) -> Roofline:
    """A `Roofline` from a counted run (`roofline.program.ProgramCounts`):
    the port's counterpart of the reference's `from_compiled`, which has
    none (no compiled program). `hlo_flops` and `hlo_bytes` are the
    whole program's (the single controller runs every position), the
    collective bytes are per device. `peak_memory` is `args_bytes` plus
    the counted peak: ONE device holding every position, not a per-chip
    figure, which waits for positions on several cards (ROADMAP 8c). The
    per-device argument bytes, one position's blocks of the params and
    moments, are `launch.dryrun.device_args_bytes`'s; the dry run prints
    both."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_desc, chips=chips,
        hlo_flops=float(counts.flops), hlo_bytes=float(counts.bytes),
        coll_bytes=counts.collectives.total_link_bytes,
        coll_detail=counts.collectives.raw_bytes,
        model_flops=model_flops, peak_memory=float(args_bytes + counts.peak))


# --------------------------------------------------------------------------
# MODEL_FLOPS = 6 * N_active * D  (D = tokens processed in the step)
# --------------------------------------------------------------------------

def active_param_count(cfg) -> int:
    """Active params per token (MoE counts topk experts, not all)."""
    d, ff, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d

    if cfg.family in ("dense",):
        per_layer = attn + 3 * d * ff
        total = L * per_layer
    elif cfg.family == "moe":
        expert = 3 * d * ff
        per_layer = attn + cfg.topk_experts * expert + d * cfg.n_experts
        total = L * per_layer
    elif cfg.family == "hybrid":
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        mamba = d * 2 * di + d * (2 * N + H) + di * d
        n_attn = sum((i + 1) % cfg.attn_every == 0 for i in range(L))
        total = L * mamba + n_attn * (attn + 3 * d * ff)
    elif cfg.family == "ssm":
        total = L * (4 * d * d + d * d) + L * (2 * d * ff + d * d)
    elif cfg.family == "vlm":
        n_cross = L // cfg.cross_attn_every
        n_self = L - n_cross
        total = n_self * (attn + 3 * d * ff) + n_cross * (attn + 3 * d * ff)
    elif cfg.family == "audio":
        enc = cfg.n_enc_layers * (attn + 3 * d * ff)
        dec = L * (2 * attn + 3 * d * ff)
        total = enc + dec
    else:
        total = 0
    total += 2 * V * d  # embed + unembed
    return int(total)


def model_flops(cfg, *, tokens: int, training: bool) -> float:
    mult = 6.0 if training else 2.0
    return mult * active_param_count(cfg) * tokens


# --------------------------------------------------------------------------
# The serving programs' predicted (flops, bytes), under the reference's
# conventions (flops = dots only; bytes = 2x every materialized output).
# The bands are the reference's, calibrated on its XLA:CPU programs.
# --------------------------------------------------------------------------

#: measured decode bytes / predicted floor
DECODE_BYTES_BAND = (1.0, 5.0)
#: measured fused-step bytes / predicted floor
FUSED_BYTES_BAND = (1.0, 16.0)
#: fused-step dot flops against the prediction
FUSED_FLOPS_RTOL = 0.05
#: measured encode bytes / predicted floor
ENCODE_BYTES_BAND = (1.0, 10.0)


def top_matmul_params(cfg, cut: int) -> int:
    """Matmul params of the label owner's top model: attention + FFN
    projections of layers [cut, n_layers) plus the unembed over the
    padded vocab. Dense family only (the serving bench's arch)."""
    d, ff = cfg.d_model, cfg.d_ff
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
    return (cfg.n_layers - cut) * (attn + 3 * d * ff) + d * cfg.padded_vocab


def serving_decode_costs(rows: int, d: int, *, dtype_bytes: int = 4):
    """(flops, bytes floor) of the slot decode: no dots; the decoded
    update slice written and read."""
    return 0.0, 2.0 * rows * d * dtype_bytes


def serving_encode_costs(rows: int, d: int, *, dtype_bytes: int = 4):
    """(flops, bytes floor) of the client's fused encode: no dots; the
    activation read and an output write of the same order."""
    return 0.0, 2.0 * rows * d * dtype_bytes


def serving_step_costs(cfg, cut: int, capacity: int, max_len: int,
                       state_nbytes: int):
    """(flops, bytes floor) of the fused decode + step: every arena row
    pays the top matmul params and the two decode-attention dots against
    a `max_len` KV cache; the arena state (`state_nbytes`: cache leaves +
    xbuf) written and read."""
    score_dots = 2 * cfg.n_heads * cfg.hd * max_len
    flops = 2.0 * capacity * (top_matmul_params(cfg, cut) + score_dots)
    return flops, 2.0 * state_nbytes


def serving_collective_costs(cfg, capacity: int, mesh_axes,
                             *, dtype_bytes: int = 4):
    """Per-op raw collective bytes of one sharded arena step
    (`runtime.steps._make_sharded_arena_step`; raw bytes are each
    collective's per-device output size) and their total under
    `RING_FACTOR`:

      * 'model': the row gather of the hidden block (one all-gather of
        `capacity / positions * model` rows of d) and the exact argmax
        (one f32 max and one s32 min all-reduce, 4 B a gathered row);
      * 'pod': the ring crossing, one collective-permute of the local
        activation block forward and one of the gathered tokens back.

    `mesh_axes` maps each axis to its size; `capacity` is the padded row
    count; `dtype_bytes` the activation's."""
    sizes = dict(mesh_axes)
    n_model = sizes.get("model", 1)
    n_pod = sizes.get("pod", 1)
    n_dev = 1
    for s in sizes.values():
        n_dev *= s
    rows_local = capacity // n_dev          # per-device row shard
    rows_group = rows_local * n_model       # rows a model group reassembles
    d = cfg.d_model
    per_op: Dict[str, float] = {}
    if n_model > 1:
        per_op["all-gather"] = float(rows_group * d * dtype_bytes)
        # pmax f32[rows, 1] + pmin s32[rows, 1]: 4 bytes each per row
        per_op["all-reduce"] = float(2 * rows_group * 4)
    if n_pod > 1:
        per_op["collective-permute"] = float(
            rows_local * d * dtype_bytes     # activation block forward
            + rows_group * 4)                # s32 token rows back
    total = sum(RING_FACTOR.get(op, 1.0) * b for op, b in per_op.items())
    return per_op, total


def serving_collective_slack(cfg, capacity: int, mesh_axes,
                             *, dtype_bytes: int = 4):
    """Per-op bytes the reference's audit allows above
    `serving_collective_costs` for traffic its partitioner adds: a
    collective-permute reshard of the replicated `xbuf`'s live rows (at
    most one copy, `capacity * d_model * dtype_bytes`) and, with a model
    axis of 1, the argmax's degenerate all-reduces (4 B twice a row).
    The gate is `predicted <= measured <= predicted + slack` per op."""
    sizes = dict(mesh_axes)
    n_dev = 1
    for s in sizes.values():
        n_dev *= s
    rows_group = (capacity // n_dev) * sizes.get("model", 1)
    slack = {"collective-permute":
             float(capacity * cfg.d_model * dtype_bytes)}
    if sizes.get("model", 1) == 1:
        slack["all-reduce"] = float(2 * 4 * rows_group)
    return slack


def training_collective_costs(cfg, batch: int, seq: int, mesh_axes, *,
                              act_bytes: int = 4, param_bytes: int = 4,
                              seq_shard: bool = True, dp_only: bool = False,
                              remat: bool = True):
    """Per-op raw collective bytes of one training step of any family on a
    mesh (`repro_torch.mesh` convention: each collective's per-device
    output, once a collective; a backward's collectives too) and their
    total under `RING_FACTOR`.

    With M = 'model' (1 under `dp_only`), D = 'data', P = 'pod', a batch
    shard of b = batch / (positions / M) rows, a gathered activation
    G = b * s * d over a sequence of s (the tokens, or whisper's F
    frames; activation bytes) and a position's chunk G / M, and that
    sequence sharded (M > 1, `seq_shard`, s divisible by M):

      * each norm gathers (all-gather G; backward reduce-scatter G / M);
      * each output projection over n heads (or d_ff columns) with n
        divisible by M: the weight's local rows all-gathered over 'data'
        when D > 1 (rows / M x d parameter bytes; backward a
        reduce-scatter of rows / M x d / D) and the partial product
        reduce-scattered (G / M; backward all-gather G);
      * with `remat` each block's forward collectives run again in the
        backward's recompute, but for the trailing ones it stops before
        (checkpoint's early stop, `transformer.apply_layers_mesh`);
      * dense, the vlm's self layers, zamba2's shared block: two norm
        gathers, attention's projection (recomputed) and the MLP's
        (trailing);
      * moe: with M > 1 its E / M experts' three matrices all-gathered
        over 'data' when D > 1 (E / M x d x d_ff each; backward d / D),
        the combine reduce-scattered (G / M; backward G), or all-reduced
        (G both ways) without sequence parallelism, and with more than
        one batch shard the balance loss all-reduced (4 B both ways),
        the combine and the balance loss trailing;
      * hybrid (zamba2): a norm gather and Mamba2's projection over its
        heads (trailing in a layer without a shared-attention site), and
        with the heads split the gated norm's sum of squares all-reduced
        (b x s x 4 B f32, both ways, recomputed); then the shared block
        at each site (every `attn_every`-th layer);
      * ssm (rwkv6): two norm gathers, the time mix's projection over
        its d / 64 heads and the channel mix's over d_ff, both
        recomputed (the receptance's product saves the channel mix's
        reduce-scattered chunk);
      * vlm: each group's `cross_attn_every` - 1 self layers, then the
        cross layer's two norm gathers and its cross attention's and
        gated MLP's projections, both recomputed (the gate's product
        saves the chunk); the patches are each shard's own;
      * audio (whisper): each decoder layer three norm gathers, self and
        cross attention's projections (recomputed) and the MLP's
        (trailing); the encoder's layers as dense layers over F, and its
        normed output gathered to full F once (G over F; backward G / M
        over F);
      * the cut: its gather (G; backward G / M) and, with a 'pod' axis
        and `transfer_over_pod`, the payload leaves' collective-permute
        (b * seq tokens of `split.protocol.pod_leaf_sizes`; backward
        the gradient leaves'), and whisper's encoder output with them
        (G over F, both ways);
      * the lm head's final-norm gather (G; backward G / M)."""
    sizes = dict(mesh_axes)
    tp = "model" in sizes and not dp_only
    m = sizes["model"] if tp else 1
    n_data, n_pod = sizes.get("data", 1), sizes.get("pod", 1)
    shards = math.prod(sizes.values()) // m
    b, d, a, w = batch // shards, cfg.d_model, act_bytes, param_bytes
    per_op = Counter()

    def run(ops, times=1):
        """Add one block's collectives `times` over: (op, bytes, 'fwd' |
        'tail' | 'bwd'), 'fwd' again in the recompute."""
        for op, nb, at in ops:
            per_op[op] += times * nb * (2 if remat and at == "fwd" else 1)

    def sharded(s):
        return m > 1 and seq_shard and s % m == 0

    def gathers(s, n):
        g = b * s * d * a
        return ([("all-gather", g, "fwd"), ("reduce-scatter", g // m, "bwd")]
                * n if sharded(s) else [])

    def proj(s, n, rows, at):
        if not sharded(s) or n % m:
            return []
        g, ops = b * s * d * a, []
        if n_data > 1 and d % n_data == 0:
            ops += [("all-gather", rows // m * d * w, "fwd"),
                    ("reduce-scatter", rows // m * (d // n_data) * w, "bwd")]
        return ops + [("reduce-scatter", g // m, at), ("all-gather", g, "bwd")]

    def dense(s):
        return (gathers(s, 2) + proj(s, cfg.n_heads, cfg.n_heads * cfg.hd,
                                     "fwd")
                + proj(s, cfg.d_ff, cfg.d_ff, "tail"))

    L, S = cfg.n_layers, seq
    if cfg.family == "moe":
        e, g = cfg.n_experts // m, b * S * d * a
        ops = gathers(S, 2) + proj(S, cfg.n_heads, cfg.n_heads * cfg.hd,
                                   "fwd")
        if m > 1 and n_data > 1 and d % n_data == 0:
            ops += [("all-gather", 3 * e * d * cfg.d_ff * w, "fwd"),
                    ("reduce-scatter", 3 * e * (d // n_data) * cfg.d_ff * w,
                     "bwd")]
        if m > 1:
            ops += ([("reduce-scatter", g // m, "tail"),
                     ("all-gather", g, "bwd")] if sharded(S)
                    else [("all-reduce", g, "tail"), ("all-reduce", g, "bwd")])
        if shards > 1:
            ops += [("all-reduce", 4, "tail"), ("all-reduce", 4, "bwd")]
        run(ops, L)
    elif cfg.family == "hybrid":
        sites = sum((i + 1) % cfg.attn_every == 0 for i in range(L))
        norm = ([("all-reduce", b * S * 4, "fwd"), ("all-reduce", b * S * 4,
                                                    "bwd")]
                if sharded(S) and cfg.ssm_heads % m == 0 else [])
        for at, n in (("tail", L - sites), ("fwd", sites)):
            run(gathers(S, 1) + norm
                + proj(S, cfg.ssm_heads, cfg.d_inner, at), n)
        run(dense(S), sites)
    elif cfg.family == "ssm":
        run(gathers(S, 2) + proj(S, d // 64, d, "fwd")
            + proj(S, cfg.d_ff, cfg.d_ff, "fwd"), L)
    elif cfg.family == "vlm":
        n_cross = L // cfg.cross_attn_every
        run(dense(S), L - n_cross)
        run(gathers(S, 2) + proj(S, cfg.n_heads, cfg.n_heads * cfg.hd, "fwd")
            + proj(S, cfg.d_ff, cfg.d_ff, "fwd"), n_cross)
    elif cfg.family == "audio":
        attn = proj(S, cfg.n_heads, cfg.n_heads * cfg.hd, "fwd")
        run(gathers(S, 3) + attn + attn
            + proj(S, cfg.d_ff, cfg.d_ff, "tail"), L)
        F = cfg.n_frames
        run(dense(F), cfg.n_enc_layers)
        run([(op, nb, "tail") for op, nb, _ in gathers(F, 1)])
    else:
        run(dense(S), L)
    heads = 1 if cfg.split is None or cfg.split.cut_layer <= 0 else 2
    run([(op, nb, "tail") for op, nb, _ in gathers(S, heads)])
    if heads == 2 and n_pod > 1 and cfg.split.transfer_over_pod:
        leaf, grad = protocol.pod_leaf_sizes(cfg)
        per_op["collective-permute"] += b * S * (leaf + grad * a)
        if cfg.family == "audio":
            per_op["collective-permute"] += 2 * b * cfg.n_frames * d * a
    per_op = {op: float(nb) for op, nb in per_op.items() if nb}
    total = sum(RING_FACTOR.get(op, 1.0) * nb for op, nb in per_op.items())
    return per_op, total


def decode_collective_costs(cfg, batch: int, max_len: int, mesh_axes, *,
                            flash_decode: bool = True, dp_only: bool = False,
                            act_bytes: int = 4, argmax: bool = True):
    """Per-op raw collective bytes of one whole-batch decode step on a
    mesh (`split.model.decode_mesh`, every family; `repro_torch.mesh`
    convention: each collective's per-device output, once a collective)
    and their total under `RING_FACTOR`.

    With M = 'model' (1 under `dp_only`), P = 'pod', a batch shard of
    b = batch / (positions / M) rows (b = batch where that does not
    divide: the batch stays whole), a ring of size = min(max_len,
    sliding_window) slots, a cross KV of N tokens (the vlm's patches,
    whisper's frames), flash decode over a KV where `flash_decode`,
    M > 1 and M divides its slots or tokens (`tp.flash_split`);
    activation bytes a; every collective over 'model' moves nothing when
    M is 1:

      * attention (dense and moe layers, the vlm's self layers, zamba2's
        shared block at each site, whisper's self attention): with flash
        decode three f32 all-reduces of the partials, b x Hq x 4 (the
        max), b x Hq x 4 (the sum) and b x Hq x hd x 4 (the output); and
        where M divides Hq the output projection's partial products
        summed (all-reduce b x d x a);
      * cross attention (the vlm's cross layers, whisper's every layer):
        the same terms with flash decode over the N tokens;
      * each MLP (gated or not, zamba2's shared one at each site) where M
        divides d_ff, and each moe combine (its experts over 'model'): an
        all-reduce of b x d x a;
      * each Mamba2 layer (hybrid) where M divides `ssm_heads`: the gated
        norm's sum of squares (an f32 all-reduce of b x 4) and `w_out`'s
        partial products (b x d x a);
      * each RWKV6 layer (ssm): the time mix's `w_out` where M divides
        its d / 64 heads and the channel mix's `w_v` where M divides
        d_ff, b x d x a each;
      * the cut, with a 'pod' axis and `transfer_over_pod`: the payload
        leaves' collective-permute, b tokens of
        `split.protocol.pod_leaf_sizes`;
      * with `argmax` (`launch.steps.make_serve_step`; `decode_step`
        returns the logits), where M divides the padded vocab, the
        vocab-parallel argmax's f32 max and s32 min all-reduces (b x 4
        each), and on the pod ring the tokens' way back, a
        collective-permute of b x 4 (s32).

    A cache's own collectives (whisper's encoder output over the pod
    ring) are `decode_cache_collective_costs`'."""
    sizes = dict(mesh_axes)
    m = sizes["model"] if "model" in sizes and not dp_only else 1
    n_pod = sizes.get("pod", 1)
    b = _decode_rows(batch, sizes, m)
    d, a, hq, L = cfg.d_model, act_bytes, cfg.n_heads, cfg.n_layers
    size = min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len
    per_op = Counter()

    def attention(n, kv):
        if tp.flash_split(flash_decode, m, kv):
            per_op["all-reduce"] += n * b * hq * (2 + cfg.hd) * 4
        if hq % m == 0:
            per_op["all-reduce"] += n * b * d * a

    def proj(n, width):
        if width % m == 0:
            per_op["all-reduce"] += n * b * d * a

    if m > 1:
        if cfg.family == "hybrid":
            sites = sum((i + 1) % cfg.attn_every == 0 for i in range(L))
            if cfg.ssm_heads % m == 0:
                per_op["all-reduce"] += L * (b * 4 + b * d * a)
            attention(sites, size)
            proj(sites, cfg.d_ff)
        elif cfg.family == "ssm":
            proj(L, d // 64)
            proj(L, cfg.d_ff)
        elif cfg.family == "vlm":
            n_cross = L // cfg.cross_attn_every
            attention(L - n_cross, size)
            attention(n_cross, cfg.n_image_tokens)
            proj(L, cfg.d_ff)           # every layer, self or cross
        elif cfg.family == "audio":
            attention(L, size)
            attention(L, cfg.n_frames)
            proj(L, cfg.d_ff)
        else:
            attention(L, size)
            if cfg.family == "moe":
                per_op["all-reduce"] += L * b * d * a
            else:
                proj(L, cfg.d_ff)
        if argmax and cfg.padded_vocab % m == 0:
            per_op["all-reduce"] += 2 * b * 4
    cut = cfg.split is not None and cfg.split.cut_layer > 0
    if cut and n_pod > 1 and cfg.split.transfer_over_pod:
        per_op["collective-permute"] += b * protocol.pod_leaf_sizes(cfg)[0]
        if argmax:
            per_op["collective-permute"] += b * 4
    return _with_total(per_op)


def decode_cache_collective_costs(cfg, batch: int, mesh_axes, *,
                                  dp_only: bool = False, act_bytes: int = 4):
    """Per-op raw collective bytes of building a decode mesh's cache
    (`split.model.init_decode_cache` with the batch's side inputs) and
    their total under `RING_FACTOR`: with a cut, a 'pod' axis and
    `transfer_over_pod`, whisper's encoder output crosses the pod ring
    with its rows to the top layers' cross KV, a collective-permute of
    b x F x d x a (b as in `decode_collective_costs`); whisper's encoder
    runs whole on every position (`seq_shard` off) and the vlm's patches
    are read where they are, so nothing else moves."""
    sizes = dict(mesh_axes)
    m = sizes["model"] if "model" in sizes and not dp_only else 1
    per_op = Counter()
    cut = cfg.split is not None and cfg.split.cut_layer > 0
    if (cfg.family == "audio" and cut and sizes.get("pod", 1) > 1
            and cfg.split.transfer_over_pod):
        per_op["collective-permute"] += (_decode_rows(batch, sizes, m)
                                         * cfg.n_frames * cfg.d_model
                                         * act_bytes)
    return _with_total(per_op)


def _decode_rows(batch: int, sizes, m: int) -> int:
    """A decode batch shard's rows: batch / (positions / M), or the whole
    batch where that does not divide."""
    shards = math.prod(sizes.values()) // m
    return batch // shards if batch % shards == 0 else batch


def _with_total(per_op):
    per_op = {op: float(nb) for op, nb in per_op.items() if nb}
    return per_op, sum(RING_FACTOR.get(op, 1.0) * nb
                       for op, nb in per_op.items())
