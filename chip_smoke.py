#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (`src/repro_torch`), one card.

    python3 chip_smoke.py                  # everything
    python3 chip_smoke.py --phase kernels  # build + kernel checks only
    python3 chip_smoke.py --phase train    # kernel checks + training
    python3 chip_smoke.py --phase serve    # kernel checks + serving

Phases, each fatal on failure:

  1. build the seven CUDA kernels from `src/repro_torch/csrc` (nvcc,
     sm_90a, one process per source);
  2. hold each kernel against its plain PyTorch version on the card, at
     the shapes its path gives it (serving: one row of d 4096; training:
     1024 rows of d 4096, k 64) and at odd ones (rows not a multiple of a
     block, d not a multiple of 32, k in {1, 64, d-1}, ties, duplicate and
     out-of-range indices, d = 16384): masks, indices, words, scattered
     and non-quant values exact; quant headers and decoded values within
     1 ulp, quant codes exact; projected rows within 1 ulp plus 1e-5 of
     the summed |terms|; time kernel, plain version and, where one
     exists, the single PyTorch call that computes the same function;
  3. serve yi-6b at full width (d 4096, bf16, random weights from a seed)
     through `runtime.engine.run_streaming` with `randtopk --k 64`, the cut
     at n_layers // 2: the launch counts (zeroed just before) must show
     every kernel ran, no host densification, measured payload bytes per
     token = `comp.fwd_bits(d) / 8`, and the tokens must equal a second run
     with the plain versions forced (`backend="torch"`); tokens/s of two
     untraced runs, and the card's busy share from a `torch.profiler` trace
     of a third run of the threaded loop itself;
  4. the client and server steps timed alone, with their kernel time from
     a `torch.profiler` trace of calls made alone;
  5. the same path with the identity, quant and randtopk_mask compressors,
     so every encode and decode kind reaches a kernel;
  6. yi-6b SMOKE in f32: the card's tokens equal the port's CPU run;
  7. train yi-6b at full width, depth cut to 8 layers (cut at 4), batch 4
     x seq 256, randtopk k 64, AdamW: the first step's forward gives the
     same support, view and loss with the kernels and with the plain
     versions, and a whole first step with the plain versions launches
     nothing and gives the kernels' first loss, grad norm and updated
     parameters, bit for bit (its backward scatters the wire gradient
     through `scatter_rows`); 10 steps through the
     kernels (counts zeroed just before: every kernel of the path ran),
     their synchronized step times, tokens/s, peak memory, and the busy
     share from a `torch.profiler` trace of 3 more; then 2 steps each
     with randtopk_mask, quant and size_reduction, so every decode kind
     of the path reaches `decode_rows`;
  8. the paper's two-party tabular trainer (`split.tabular.train`, the
     `SplitSpec` defaults, batch 128) for one epoch with randtopk, with
     the kernels and with the plain versions: its byte assertion holds
     and the two runs end with the same loss and trained weights, bit for
     bit;
  9. yi-6b SMOKE in f32: 3 training steps on the CPU (plain versions) and
     on the card (kernels) from one set of weights, batches and RandTopK
     draws give losses within rtol 1e-5.

Prints the card's name and power limit, a `kernels` JSON line (each
kernel's launches on its path's randtopk run, its largest difference from
its plain version, the CUDA-event times of kernel, plain version and
library call at its path's shapes, and the card's bound for the same
work), the loop's and the step's numbers, and as its last line
{"ok": true, "device": {...}}. Exits nonzero, with no result line, when
CUDA is unavailable or any phase fails.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM non-tensor f32 (data sheet)
D, K, W_IDX = 4096, 64, 12     # yi-6b cut width, top-k, index bits
N_CLIENTS, PROMPT_LEN = 4, 4   # closed-loop sessions and prompt tokens
GEN = 16                       # generated tokens per session, randtopk runs
GEN_OTHER = 8                  # ... and for the other compressors


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, iters: int = 200, reps: int = 5) -> float:
    """Median over `reps` of CUDA-event time per call, `iters` calls each,
    after a warm-up."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / iters)
    return statistics.median(out)


def bound_ms(nbytes: float, ops: float):
    """The least time the card needs: max(bytes / HBM rate, ops / f32 rate).
    Returns (ms, "bytes" | "operations")."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def max_diff(a, b) -> float:
    import torch

    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def ulp(t):
    """One ulp of f32 at each element's magnitude."""
    import torch

    t = t.float().abs()
    return torch.nextafter(t, torch.full_like(t, float("inf"))) - t


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_topk(dev, g):
    import torch
    from repro_torch.kernels.randtopk import ops, ref

    cases = [((1, D), torch.bfloat16, K), ((37, 1000), torch.float32, 1),
             ((37, 1000), torch.float32, 64), ((37, 1000), torch.float32,
                                               999),
             ((3, 16384), torch.bfloat16, K), ((5, 4097), torch.float32, 64)]
    err = 0.0
    for shape, dt, k in cases:
        x = torch.randn(shape, generator=g, device=dev).to(dt)
        for xx in (x, torch.round(x * 2) / 2, torch.zeros_like(x),
                   -x.abs()):                       # plus ties and zeros
            mk, tk = ops.topk_mask_threshold(xx, k)
            mp, tp = ref.topk_mask_threshold(xx, k)
            torch.cuda.synchronize()
            if not torch.equal(mk, mp) or not torch.equal(tk, tp):
                fail(f"topk kernel != plain at {shape} {dt} k={k}")
            if not bool((mk.sum(-1) == k).all()):
                fail(f"topk kernel selected != {k} at {shape}")
            err = max(err, max_diff(mk, mp), max_diff(tk, tp))
    x = torch.randn((1, D), generator=g, device=dev).to(torch.bfloat16)
    mag = x.abs().float()
    ms = time_ms(lambda: ops.topk_mask_threshold(x, K))
    plain = time_ms(lambda: ref.topk_mask_threshold(x, K))
    lib = time_ms(lambda: torch.topk(mag, K, dim=-1))
    b = bound_ms(D * 2 + D * 1 + 4, 5 * D)   # 4 radix passes + emit
    return dict(name="topk_mask_threshold", route="cuda",
                source="src/repro_torch/csrc/topk_select.cu",
                replaces="src/repro/kernels/randtopk/kernel.py:133",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=lib,
                library_call="torch.topk(|x| f32, k)")


KIND_CASES = [("dense", 0, 0), ("slice", K, 0), ("sparse", K, 0),
              ("quant", 0, 4), ("sparse_quant", K, 8), ("mask", K, 0)]


def _encode_case(x, kind, k, bits):
    import torch
    from repro_torch.core.payload import KIND_LEAVES
    from repro_torch.kernels.encode import ops, ref
    from repro_torch.kernels.randtopk import ref as tref

    mask = tref.topk_mask_threshold(x, k)[0] if k else None
    p = ops.encode_rows(x, kind, k=k, bits=bits, mask=mask)
    got = [getattr(p, name) for name in KIND_LEAVES[kind]]
    want = ref.encode_rows(x, kind, k, bits, mask)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(KIND_LEAVES[kind], got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"encode {kind} {name}: {a.shape}/{a.dtype} vs "
                 f"{b.shape}/{b.dtype}")
        if kind in ("quant", "sparse_quant") and name == "header":
            if not bool(((a - b).abs() <= ulp(b)).all()):
                fail(f"encode {kind} header beyond 1 ulp")
        elif not torch.equal(a, b):
            fail(f"encode {kind} {name}: kernel != plain at "
                 f"{tuple(x.shape)} k={k}")
        err = max(err, max_diff(a, b))
    return err


def check_encode(dev, g):
    import torch
    from repro_torch.kernels.encode import ops, ref
    from repro_torch.kernels.randtopk import ref as tref

    err = 0.0
    for kind, k, bits in KIND_CASES:
        x = torch.randn((1, D), generator=g, device=dev).to(torch.bfloat16)
        err = max(err, _encode_case(x, kind, k, bits))
        xo = torch.randn((37, 1000), generator=g, device=dev)
        for kk in ((1, 64, 999) if k else (0,)):
            err = max(err, _encode_case(xo, kind, kk, bits))
        err = max(err, _encode_case(torch.zeros((3, 70), device=dev), kind,
                                    min(k, 70), bits))
    x = torch.randn((1, D), generator=g, device=dev).to(torch.bfloat16)
    mask = tref.topk_mask_threshold(x, K)[0]
    ms = time_ms(lambda: ops.encode_rows(x, "sparse", k=K, mask=mask))
    plain = time_ms(lambda: ref.encode_rows(x, "sparse", K, 0, mask))
    b = bound_ms(D * 2 + D + K * 8, 2 * D)
    return dict(name="encode_rows", route="cuda",
                source="src/repro_torch/csrc/encode_rows.cu",
                replaces="src/repro/kernels/encode/kernel.py:160",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=None)


def check_pack(dev, g):
    import torch
    from repro_torch.kernels.encode import ops, ref

    err = 0.0
    for w in range(1, 33):
        for n in (1, K, 1000, 4097):
            hi = 2 ** w
            v = torch.randint(0, min(hi, 2 ** 31 - 1), (n,), generator=g,
                              device=dev, dtype=torch.int64)
            if w == 32:
                v = v * 2 - 2 ** 31 + torch.randint(0, 2, (n,), generator=g,
                                                    device=dev)
            v = v.to(torch.int32)
            a, b = ops.pack_bits(v, w), ref.pack_bits(v, w)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                fail(f"pack_bits kernel != plain at width {w}, n {n}")
            err = max(err, max_diff(a, b))
    idx = torch.randint(0, D, (K,), generator=g, device=dev,
                        dtype=torch.int32)
    ms = time_ms(lambda: ops.pack_bits(idx, W_IDX))
    plain = time_ms(lambda: ref.pack_bits(idx, W_IDX))
    b = bound_ms(K * 4 + (K + 31) // 32 * W_IDX * 4, K * 4)
    return dict(name="pack_bits", route="cuda",
                source="src/repro_torch/csrc/pack_bits.cu",
                replaces="src/repro/kernels/encode/kernel.py:236",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=None)


def _flush_payload(dev, g, kind, k, bits, n, d, n_real):
    """A stacked flush of n rows (n_real real, the rest zero pad rows)."""
    import torch
    from repro_torch.core.payload import KIND_LEAVES, Payload, PayloadMeta
    from repro_torch.kernels.encode import ref as eref
    from repro_torch.kernels.randtopk import ref as tref

    x = torch.randn((n, d), generator=g, device=dev)
    mask = tref.topk_mask_threshold(x, k)[0] if k else None
    leaves = list(eref.encode_rows(x, kind, k, bits, mask))
    for leaf in leaves:
        leaf[n_real:] = 0
    meta = PayloadMeta(kind, d=d, k=k if kind != "quant" else 0,
                       bits=bits)
    return Payload(meta=meta, **dict(zip(KIND_LEAVES[kind], leaves)))


def check_decode(dev, g):
    import torch
    from repro_torch.core.payload import KIND_LEAVES
    from repro_torch.kernels.decode import ops, ref

    err = 0.0
    for kind, k, bits in KIND_CASES:
        for d, dt, n, n_real, kk in ((D, torch.bfloat16, 4, 3, k),
                                     (1000, torch.float32, 8, 5,
                                      min(k, 999) or 0),
                                     (1000, torch.float32, 3, 3,
                                      999 if k else 0)):
            cap = 6
            p = _flush_payload(dev, g, kind, kk, bits, n, d, n_real)
            slots = torch.tensor(list(range(n_real)) + [cap] * (n - n_real),
                                 dtype=torch.int32, device=dev)
            base = torch.randn((cap + 1, 1, 1, d), generator=g,
                               device=dev).to(dt)
            xa, xb = base.clone(), base.clone()
            ops.decode_rows_to_slots(xa, p, slots)
            leaves = [getattr(p, nm) for nm in KIND_LEAVES[kind]]
            ref.decode_to_slots(xb, leaves, slots, kind, d)
            torch.cuda.synchronize()
            if kind in ("quant", "sparse_quant"):
                if not bool(((xa.float() - xb.float()).abs()
                             <= ulp(xb)).all()):
                    fail(f"decode {kind} beyond 1 ulp at d={d}")
            elif not torch.equal(xa, xb):
                fail(f"decode {kind}: kernel != plain at d={d} n={n}")
            err = max(err, max_diff(xa, xb))
    n = 4
    p = _flush_payload(dev, g, "sparse", K, 0, n, D, 3)
    slots = torch.tensor([0, 1, 2, n], dtype=torch.int32, device=dev)
    xbuf = torch.zeros((n + 1, 1, 1, D), dtype=torch.bfloat16, device=dev)
    leaves = [p.values, p.indices]
    ms = time_ms(lambda: ops.decode_rows_to_slots(xbuf, p, slots))
    plain = time_ms(lambda: ref.decode_to_slots(xbuf, leaves, slots,
                                                "sparse", D))
    rows = slots.long()[:, None].expand(n, K)
    cols = p.indices.long()
    vals = p.values.to(torch.bfloat16)
    x2 = xbuf.view(-1, D)
    lib = time_ms(lambda: x2.index_put_((rows, cols), vals))
    b = bound_ms(n * K * 8 + n * 4 + n * D * 2, n * (D + K))
    return dict(name="decode_to_slots", route="cuda",
                source="src/repro_torch/csrc/decode_to_slots.cu",
                replaces="src/repro/kernels/decode/kernel.py:224",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=lib,
                library_call="xbuf.index_put_((slot, index), values): the "
                             "k values only, the row is not zeroed")


TRAIN_ROWS = 1024               # yi-6b training step: batch 4 x seq 256


def _tol_ok(a, b, slack=None) -> bool:
    """|a - b| within one ulp of b in b's dtype (bf16: 2**-7 relative),
    plus `slack` where given."""
    import torch

    bf = b.float()
    if b.dtype == torch.bfloat16:
        tol = bf.abs() * 2.0 ** -7 + 1e-30
    else:
        tol = ulp(bf)
    if slack is not None:
        tol = tol + slack
    return bool(((a.float() - bf).abs() <= tol).all())


def check_randtopk(dev, g):
    import torch
    from repro_torch.kernels.randtopk import ops, ref
    from repro_torch.core import selection

    cases = [((TRAIN_ROWS, D), torch.bfloat16, K), ((37, 1000), torch.float32,
                                                   1),
             ((37, 1000), torch.float32, 64), ((37, 1000), torch.float32,
                                               500),
             ((37, 1000), torch.float32, 999), ((3, 16384), torch.bfloat16, K),
             ((5, 4097), torch.float32, 64)]
    err = 0.0
    for shape, dt, k in cases:
        x = torch.randn(shape, generator=g, device=dev).to(dt)
        gum = selection.gumbel_noise(g, shape, device=dev)
        rows, d = shape
        cap = min(k, d - k)
        m_rand = torch.randint(-2, cap + 3, (rows, 1), generator=g,
                               device=dev)                # clipped in both
        for xx, gg, m in ((x, gum, m_rand),
                          (x, gum, torch.zeros((rows, 1), device=dev,
                                               dtype=torch.int64)),
                          (x, gum, torch.full((rows, 1), cap, device=dev)),
                          (torch.round(x * 2) / 2, torch.round(gum),
                           m_rand),                       # tied scores
                          (torch.zeros_like(x), torch.zeros_like(gum),
                           m_rand)):
            a = ops.randtopk_mask(xx, gg, m, k)
            b = ref.randtopk_mask(xx, gg, m, k)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                fail(f"randtopk kernel != plain at {shape} {dt} k={k}")
            if not bool((a.sum(-1) == k).all()):
                fail(f"randtopk kernel selected != {k} at {shape}")
            err = max(err, max_diff(a, b))
    x = torch.randn((TRAIN_ROWS, D), generator=g, device=dev).to(
        torch.bfloat16)
    gum = selection.gumbel_noise(g, x.shape, device=dev)
    m = selection.binomial_nontop_count(g, 0.1, K, D, (TRAIN_ROWS,),
                                        device=dev)
    ms = time_ms(lambda: ops.randtopk_mask(x, gum, m, K), iters=50)
    plain = time_ms(lambda: ref.randtopk_mask(x, gum, m, K), iters=10)
    # x bf16 + noise f32 + m i32 read, mask written; three radix selects of
    # 4 histogram passes + 1 emit pass over each row
    b = bound_ms(TRAIN_ROWS * (D * 2 + D * 4 + 4 + D), 15 * TRAIN_ROWS * D)
    return dict(name="randtopk_mask", route="cuda",
                source="src/repro_torch/csrc/randtopk_mask.cu",
                replaces="src/repro/kernels/randtopk/kernel.py:162",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=None)


def _rows_payload(dev, g, kind, k, bits, n, d, hostile=False):
    """n payload rows of `kind` from the plain encode of random rows; with
    `hostile`, sparse indices repeat and leave [0, d), mask words carry
    set bits past k, and values are multiples of 1/8 so duplicate sums are
    exact in any order."""
    import torch
    from repro_torch.core.payload import KIND_LEAVES, Payload, PayloadMeta
    from repro_torch.kernels.encode import ref as eref
    from repro_torch.kernels.randtopk import ref as tref

    x = torch.randn((n, d), generator=g, device=dev)
    if hostile:
        x = torch.round(x * 8) / 8
    mask = tref.topk_mask_threshold(x, k)[0] if k else None
    leaves = dict(zip(KIND_LEAVES[kind],
                      eref.encode_rows(x, kind, k, bits, mask)))
    if hostile and kind in ("sparse", "sparse_quant"):
        idx = leaves["indices"]
        idx[:, 1::3] = idx[:, 0:1]                        # duplicates
        idx[:, 2::7] = d + 5                              # out of range
    if hostile and kind == "mask":
        leaves["indices"] = leaves["indices"] | 0x11      # extra bits
    if hostile and kind in ("quant", "sparse_quant"):
        leaves["header"][:, 0] = -4.0                     # exact dequant
        leaves["header"][:, 1] = 1 / 32
    meta = PayloadMeta(kind, d=d, k=k if kind != "quant" else 0, bits=bits)
    return Payload(meta=meta, **leaves)


def check_decode_rows(dev, g):
    import torch
    from repro_torch.kernels.decode import ops, ref

    err = 0.0
    for kind, k, bits in KIND_CASES:
        for n, d, kk, hostile in ((TRAIN_ROWS, D, k, False),
                                  (37, 1000, min(k, 999), False),
                                  (5, 1000, 999 if k else 0, False),
                                  (37, 1000, min(k, 999), True),
                                  (3, 16384, k, False)):
            p = _rows_payload(dev, g, kind, kk, bits, n, d, hostile)
            quant = kind in ("quant", "sparse_quant")
            for dt in (torch.float32, torch.bfloat16):
                a = ops.decode_rows(p, dtype=dt)
                b = ref.decode_rows(p, dt)
                torch.cuda.synchronize()
                if a.shape != b.shape or a.dtype != b.dtype:
                    fail(f"decode_rows {kind}: {a.shape}/{a.dtype} vs "
                         f"{b.shape}/{b.dtype}")
                if quant and not _tol_ok(a, b):
                    fail(f"decode_rows {kind} beyond 1 ulp at d={d} {dt}")
                if not quant and not torch.equal(a, b):
                    fail(f"decode_rows {kind}: kernel != plain at d={d} "
                         f"n={n} {dt} hostile={hostile}")
                err = max(err, max_diff(a, b))
            if d > 4096:
                continue
            for p_out in (1, 96, 130):
                w = torch.randn((d, p_out), generator=g, device=dev) / d**0.5
                rows = ref.decode_rows(p, torch.float32)
                # f32 sums in another order: 1e-5 of the sum of |terms|
                slack = 1e-5 * (rows.abs() @ w.abs())
                for dt in (torch.float32, torch.bfloat16):
                    a = ops.decode_rows(p, dtype=dt, project=w)
                    b = ref.decode_rows(p, dt, w)
                    torch.cuda.synchronize()
                    if a.shape != (n, p_out) or not _tol_ok(a, b, slack):
                        fail(f"decode_rows {kind} project {p_out}: kernel "
                             f"!= plain at d={d} {dt}")
                    err = max(err, max_diff(a, b))
    p = _rows_payload(dev, g, "sparse", K, 0, TRAIN_ROWS, D)
    dense = torch.zeros((TRAIN_ROWS, D), dtype=torch.bfloat16, device=dev)
    idx, vals = p.indices.long(), p.values.to(torch.bfloat16)
    ms = time_ms(lambda: ops.decode_rows(p, dtype=torch.bfloat16))
    plain = time_ms(lambda: ref.decode_rows(p, torch.bfloat16), iters=50)
    lib = time_ms(lambda: dense.scatter_add_(-1, idx, vals))
    b = bound_ms(TRAIN_ROWS * (K * 8 + D * 2), TRAIN_ROWS * (D + K))
    return dict(name="decode_rows", route="cuda",
                source="src/repro_torch/csrc/decode_rows.cu",
                replaces="src/repro/kernels/decode/kernel.py:181",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=lib,
                library_call="dense.scatter_add_(-1, index, values) into a "
                             "zeroed bf16 buffer it does not zero again")


def check_scatter_rows(dev, g):
    import torch
    from repro_torch.kernels.randtopk import ops, ref

    err = 0.0
    for n, k, d in ((TRAIN_ROWS, K, D), (37, 1, 1000), (37, 999, 1000),
                    (5, 64, 4097), (3, 64, 16384)):
        for dt in (torch.float32, torch.bfloat16):
            vals = (torch.round(torch.randn((n, k), generator=g,
                                            device=dev) * 8) / 8).to(dt)
            idx = torch.randint(0, d, (n, k), generator=g, device=dev,
                                dtype=torch.int32)
            for ii in (idx, torch.sort(idx, dim=-1).values,
                       torch.where(idx % 5 == 0, d + 3, idx)):
                a = ops.scatter_rows(vals, ii, d)
                b = ref.scatter_rows(vals, ii, d)
                torch.cuda.synchronize()
                if a.dtype != dt or not torch.equal(a, b):
                    fail(f"scatter_rows kernel != plain at n={n} k={k} "
                         f"d={d} {dt}")
                err = max(err, max_diff(a, b))
    vals = torch.randn((TRAIN_ROWS, K), generator=g, device=dev).to(
        torch.bfloat16)
    idx = torch.sort(torch.randperm(D, generator=g, device=dev)[:K]).values
    idx = idx.expand(TRAIN_ROWS, K).to(torch.int32).contiguous()
    dense = torch.zeros((TRAIN_ROWS, D), dtype=torch.bfloat16, device=dev)
    idx64 = idx.long()
    ms = time_ms(lambda: ops.scatter_rows(vals, idx, D))
    plain = time_ms(lambda: ref.scatter_rows(vals, idx, D), iters=50)
    lib = time_ms(lambda: dense.scatter_add_(-1, idx64, vals))
    b = bound_ms(TRAIN_ROWS * (K * 2 + K * 4 + D * 2), TRAIN_ROWS * (D + K))
    return dict(name="scatter_rows", route="cuda",
                source="src/repro_torch/csrc/decode_rows.cu",
                replaces="src/repro/kernels/randtopk/kernel.py:199",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=lib,
                library_call="dense.scatter_add_(-1, index, values) into a "
                             "zeroed bf16 buffer it does not zero again")


# ---------------------------------------------------------------------------
# phases 3-6: the serving path
# ---------------------------------------------------------------------------

PATH_KERNELS = {
    "randtopk": ("topk_mask_threshold", "encode_rows", "pack_bits",
                 "decode_to_slots"),
    "identity": ("encode_rows", "decode_to_slots"),
    "quant": ("encode_rows", "pack_bits", "decode_to_slots"),
    "randtopk_mask": ("topk_mask_threshold", "encode_rows",
                      "decode_to_slots"),
}


def serve(cfg, params, compressor, *, gen, backend=None, trace=False):
    """One closed-loop run of N_CLIENTS sessions; returns (result, launch
    counts of the run, analytic payload bytes per token). With `trace` the
    call runs under `torch.profiler`, and the result also holds the trace's
    device ms (`device_ms`) and the wall ms of the whole call, warm-up
    included (`call_ms`)."""
    from repro_torch.kernels import _lib
    from repro_torch.models.config import SplitConfig
    from repro_torch.runtime import engine
    from repro_torch.split import protocol

    scfg = cfg.with_(split=SplitConfig(cut_layer=cfg.n_layers // 2,
                                       compressor=compressor, k=K,
                                       backend=backend))
    densify0 = protocol.HOST_DENSIFY_COUNT.value
    _lib.reset_launch_counts()
    res, dev_ms, call_ms, _ = traced(lambda: engine.run_streaming(
        scfg, n_clients=N_CLIENTS, prompt_len=PROMPT_LEN, gen=gen,
        params=params, device="cuda"), enabled=trace)
    res.update(device_ms=dev_ms, call_ms=call_ms)
    counts = _lib.launch_counts()
    if protocol.HOST_DENSIFY_COUNT.value != densify0:
        fail(f"{compressor}: host densification on the serving path")
    toks = res["tokens"]
    if toks.shape != (N_CLIENTS, gen) or toks.min() < 0 \
            or toks.max() >= cfg.vocab:
        fail(f"{compressor}: tokens {toks.shape} out of shape/range")
    comp = res["compressor_objs"][0]
    want = comp.fwd_bits(cfg.d_model) / 8
    for s in res["client_stats"] + res["server_stats"]:
        got = s["payload_bytes_up"] / s["frames_up"]
        if got != want:
            fail(f"{compressor}: {got} payload B/token measured, {want} "
                 f"analytic")
    return res, counts, want


def step_times(cfg, params, n_clients, max_len, reps: int = 20):
    """Median host-clock ms of one client step (bottom layers + encode +
    pack + pull of the packed sections) and one server step (decode-free
    arena top step over `n_clients` rows + token readback), each alone and
    synchronized: what the serving loop would cost without its threads."""
    import numpy as np
    import torch
    from repro_torch.kernels.encode import ops as enc_ops
    from repro_torch.models import transformer
    from repro_torch.models.config import SplitConfig
    from repro_torch.runtime import steps
    from repro_torch.split import protocol

    dev = torch.device("cuda")
    cut = cfg.n_layers // 2
    comp = protocol.make_cut_compressor(SplitConfig(
        cut_layer=cut, compressor="randtopk", k=K))
    bottom = steps.make_bottom_step_device(cfg, cut, comp)
    top = steps.make_arena_top_step(cfg, cut)
    cache = transformer.init_cache(cfg, 1, max_len, device=dev)
    arena = transformer.init_cache(cfg, n_clients, max_len, device=dev)
    xbuf = torch.randn((n_clients + 1, 1, 1, cfg.d_model), device=dev).to(
        cfg.adtype())
    active = np.ones(n_clients, bool)
    tok = np.zeros((1, 1), np.int32)

    def client():
        p, sections = bottom(params, cache, tok)
        enc_ops.sections_to_bytes(p.meta, p.batch_shape, sections)

    def server():
        top(params, xbuf, arena, active).cpu()

    out = []
    for fn in (client, server):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        _, dev_ms, _, _ = traced(lambda: [fn() for _ in range(5)])
        out += [statistics.median(times), dev_ms and dev_ms / 5]
    return out


def traced(fn, enabled: bool = True):
    """Run `fn()`, under `torch.profiler` when `enabled`; returns (its
    result, the summed duration in ms of the device work in the trace, the
    wall ms of `fn()` and a synchronize, the trace's device kernels as
    (name, ms, count) from the longest). The times are None when not
    traced, the device time also when the trace holds none; the list is
    then empty. Every thread launches on the one default stream, so
    durations do not overlap."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not enabled:
        return fn(), None, None, []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA),
                key=lambda e: -e[1])
    ms = sum(e[1] for e in ev)
    return out, (ms if ms > 0 else None), wall_ms, ev


def serve_phase(dev, layers):
    """Phases 3-6: serve yi-6b through the codec. Returns the launch counts
    of the randtopk run (counts zeroed just before it)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = configs.get("yi-6b").with_(n_layers=layers)
    print(f"serving yi-6b: {cfg.n_layers} layers (cut at "
          f"{cfg.n_layers // 2}), d_model {cfg.d_model}, "
          f"{cfg.dtype}, {N_CLIENTS} clients x ({PROMPT_LEN} prompt + "
          f"{GEN} gen) tokens for randtopk, {GEN_OTHER} gen for the "
          f"other compressors")
    t0 = time.perf_counter()
    params = transformer.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    print(f"init: {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    res, counts, nb = serve(cfg, params, "randtopk", gen=GEN)
    missing = [n for n in PATH_KERNELS["randtopk"] if counts[n] == 0]
    if missing:
        fail(f"randtopk path never launched {missing}")
    print(f"randtopk: {res['tokens'].size} tokens in {res['wall_s']} s, "
          f"{res['flushes']} flushes, {nb:.0f} payload B/token, "
          f"launches {counts}")
    again, _, _ = serve(cfg, params, "randtopk", gen=GEN)
    tps = [res["tokens_per_s"], again["tokens_per_s"]]
    if not (again["tokens"] == res["tokens"]).all():
        fail("randtopk tokens differ between two runs")
    print(f"randtopk tokens/s, two untraced runs: {tps[0]} and {tps[1]} "
          f"(spread {abs(tps[0] - tps[1]) / min(tps) * 100:.2f}%)")
    rounds = PROMPT_LEN + GEN - 1
    lat = [t for c in res["client_latencies"] for t in c]
    print(f"randtopk time: {res['wall_s'] / rounds * 1e3:.1f} ms per "
          f"round of {N_CLIENTS} tokens; client send->reply median "
          f"{statistics.median(lat) * 1e3:.1f} ms; serve loop s "
          f"{ {k: round(v, 4) for k, v in res['stage_s'].items()} }")
    tr, _, _ = serve(cfg, params, "randtopk", gen=GEN, trace=True)
    if tr["device_ms"] is None:
        print("randtopk loop busy share: not measured (the profiler "
              "trace held no device time)")
    else:
        busy = tr["device_ms"] / tr["call_ms"]
        print(f"randtopk loop under torch.profiler (warm-up included): "
              f"device time {tr['device_ms']} ms of {tr['call_ms']} ms "
              f"wall, card busy {busy * 100:.2f}%, idle "
              f"{(1 - busy) * 100:.2f}%; {tr['tokens_per_s']} tokens/s "
              f"traced")
    client_ms, client_dev, server_ms, server_dev = step_times(
        cfg, params, N_CLIENTS, PROMPT_LEN + GEN)
    print(f"steps alone (synchronized, median): client bottom + encode "
          f"+ pack + pull {client_ms:.2f} ms, server top step over "
          f"{N_CLIENTS} rows {server_ms:.2f} ms; device ms per step "
          f"(torch.profiler of calls made alone): client "
          f"{client_dev or 'not measured'}, server "
          f"{server_dev or 'not measured'}")
    plain, pcounts, _ = serve(cfg, params, "randtopk", backend="torch",
                              gen=GEN)
    if any(pcounts.values()):
        fail(f"plain-version run launched kernels {pcounts}")
    if not (plain["tokens"] == res["tokens"]).all():
        fail("randtopk tokens differ between kernels and plain versions")
    print(f"randtopk plain versions: same tokens, "
          f"{plain['tokens_per_s']} tokens/s")
    for comp in ("identity", "quant", "randtopk_mask"):
        r, c, nb = serve(cfg, params, comp, gen=GEN_OTHER)
        missing = [n for n in PATH_KERNELS[comp] if c[n] == 0]
        if missing:
            fail(f"{comp} path never launched {missing}")
        print(f"{comp}: {r['tokens_per_s']} tokens/s, {nb:.0f} "
              f"payload B/token, launches {c}")
    del params
    torch.cuda.empty_cache()

    from repro_torch.models.config import SplitConfig
    from repro_torch.runtime import engine
    small = configs.get("yi-6b", smoke=True).with_(
        split=SplitConfig(cut_layer=1, compressor="randtopk", k=16))
    sp = transformer.init_model(small, torch.Generator().manual_seed(1))
    on_cpu = engine.run_streaming(small, n_clients=3, prompt_len=3,
                                  gen=4, params=sp, device="cpu")
    on_card = engine.run_streaming(
        small, n_clients=3, prompt_len=3, gen=4, device="cuda",
        params=_to(sp, dev))
    if not (on_cpu["tokens"] == on_card["tokens"]).all():
        fail("yi-6b SMOKE f32: card tokens != CPU tokens")
    print("yi-6b SMOKE f32: card tokens equal the CPU run")
    return counts


# ---------------------------------------------------------------------------
# phases 7-9: the training path
# ---------------------------------------------------------------------------

TRAIN_LAYERS, TRAIN_CUT = 8, 4     # yi-6b at full width, depth cut to fit
TRAIN_BATCH, TRAIN_SEQ = 4, 256    # 1024 tokens per step
TRAIN_STEPS = 10
TRAIN_OTHER_STEPS = 2              # each of the other compressors
TRAIN_PATH_KERNELS = {
    # forward: the Eq. (7) mask, the decode of the sparse payload;
    # backward: the scatter of the wire gradient onto the support
    "randtopk": ("randtopk_mask", "decode_rows", "scatter_rows"),
    "randtopk_mask": ("randtopk_mask", "decode_rows"),
    "quant": ("decode_rows",),
    "size_reduction": ("decode_rows",),
}


def _train_cfg(compressor, backend=None, layers=TRAIN_LAYERS,
               cut=TRAIN_CUT, smoke=False, k=K):
    from repro_torch.launch import train as train_cli

    return train_cli.build("yi-6b", smoke=smoke, layers=layers,
                           split=compressor, k=k, cut=cut, backend=backend)


def _cut_probe(params, cfg, batch, seed, dev):
    """The first step's forward alone, under no autograd: the support the
    codec selects, the decoded view the top layers see, and the loss."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.config import Runtime
    from repro_torch.split import protocol

    gen = torch.Generator(device=dev).manual_seed(seed)
    rt = Runtime(training=True)
    with torch.no_grad():
        x = transformer.embed(params, cfg, batch["tokens"])
        x, _ = transformer.apply_layers(params, cfg, rt, x, {}, 0,
                                        cfg.split.cut_layer)
        comp = protocol.make_cut_compressor(cfg.split)
        p = comp.encode(x, generator=gen, training=True)
        view = comp.decode(p, dtype=x.dtype)
        y, _ = transformer.apply_layers(params, cfg, rt, view, {},
                                        cfg.split.cut_layer, cfg.n_layers)
        ce = transformer.cross_entropy(transformer.lm_head(params, cfg, y),
                                       batch["labels"])
    return p.indices, view, ce


def _same_first_step(params, m, p_plain, m_plain):
    """The first training step with the kernels against the same step with
    the plain versions: the backward runs `scatter_rows` on the wire
    gradient, so the gradient norm and every updated parameter (the layers
    below the cut and the embedding included) must be bit-identical."""
    import torch
    from repro_torch.optim.adamw import tree_leaves

    for key in ("loss", "grad_norm"):
        if not torch.equal(m[key], m_plain[key]):
            fail(f"first step {key} {float(m[key])} with kernels, "
                 f"{float(m_plain[key])} with the plain versions")
    names = _leaf_names(params)
    off = [(n, float((a.float() - b.float()).abs().max()))
           for n, a, b in zip(names, tree_leaves(params),
                              tree_leaves(p_plain)) if not torch.equal(a, b)]
    if off:
        fail(f"first step updated parameters differ from the plain "
             f"versions' (leaf, max |diff|): {off}")
    print(f"first step, kernels vs plain versions: identical loss "
          f"({float(m['loss'])}), grad norm ({float(m['grad_norm'])}) and "
          f"{len(names)} updated parameter tensors")


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{prefix}{k}.")]
    return [prefix[:-1]]


def train_phase(dev):
    """yi-6b split training at full width through the cut codec. Returns
    the launch counts of the randtopk run (counts zeroed just before)."""
    import math

    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import _lib
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.models.config import Runtime
    from repro_torch.optim.adamw import adamw_init, tree_leaves

    cfg = _train_cfg("randtopk")
    rt = Runtime(training=True)
    params = transformer.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"training yi-6b: {cfg.n_layers} layers (cut at {TRAIN_CUT}), "
          f"d_model {cfg.d_model}, {cfg.dtype}, {n_params:,} params, "
          f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, randtopk k={K} "
          f"alpha={cfg.split.alpha}, AdamW, remat={rt.remat}")
    pipe = TokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, device="cuda")
    batch0 = pipe.next_batch(0)

    # the first step's forward, kernels vs plain versions: same support,
    # same view, same loss; the plain run launches nothing
    _lib.reset_launch_counts()
    idx_p, view_p, ce_p = _cut_probe(params, _train_cfg("randtopk", "torch"),
                                     batch0, 1, dev)
    if any(_lib.launch_counts().values()):
        fail(f"plain-version forward launched {_lib.launch_counts()}")
    idx_k, view_k, ce_k = _cut_probe(params, cfg, batch0, 1, dev)
    if not (torch.equal(idx_k, idx_p) and torch.equal(view_k, view_p)
            and torch.equal(ce_k, ce_p)):
        fail("training forward: kernels and plain versions disagree")
    print(f"first forward, kernels vs plain versions: identical support, "
          f"view and loss ({float(ce_k)})")

    # the same first step (forward, backward, AdamW) with the plain
    # versions: no launch, the same loss, and (checked after the kernels'
    # first step) the same gradient norm and updated parameters
    plain_step = steps.make_train_step(_train_cfg("randtopk", "torch"), rt)
    _lib.reset_launch_counts()
    p_plain, opt_plain, m_plain = plain_step(
        params, adamw_init(params), batch0,
        torch.Generator(device=dev).manual_seed(1))
    del opt_plain                       # its f32 moments: 15 GB at 8 layers
    torch.cuda.synchronize()
    if any(_lib.launch_counts().values()):
        fail(f"plain-version step launched {_lib.launch_counts()}")
    torch.cuda.empty_cache()

    step = steps.make_train_step(cfg, rt)
    opt = adamw_init(params)
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [pipe.next_batch(i) for i in range(TRAIN_STEPS + 3)]
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    times, losses = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batches[i], gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        if i == 0:
            _same_first_step(params, m, p_plain, m_plain)
            del p_plain
            torch.cuda.reset_peak_memory_stats(dev)   # peak of steps 2-N
    counts = _lib.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    missing = [n for n in TRAIN_PATH_KERNELS["randtopk"] if counts[n] == 0]
    if missing:
        fail(f"training randtopk path never launched {missing}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"training losses not finite: {losses}")
    per_step = {n: counts[n] / TRAIN_STEPS for n in
                TRAIN_PATH_KERNELS["randtopk"]}
    print(f"randtopk training: losses {losses}; the first equals the "
          f"plain-version step's loss (the no-autograd forward gave "
          f"{float(ce_k)}); launches {counts} ({per_step} per step)")
    med = statistics.median(times[1:])
    print(f"train step (synchronized host clock, steps 2-{TRAIN_STEPS}): "
          f"median {med:.2f} ms, min {min(times[1:]):.2f}, max "
          f"{max(times[1:]):.2f}; first step {times[0]:.2f} ms; "
          f"{TRAIN_BATCH * TRAIN_SEQ / med * 1e3:.1f} tokens/s; peak "
          f"device memory of steps 2-{TRAIN_STEPS} {peak:.2f} GiB")

    def three_steps():
        nonlocal params, opt
        for b in batches[TRAIN_STEPS:]:
            params, opt, _ = step(params, opt, b, gen)

    _, dev_ms, wall_ms, kernels = traced(three_steps)
    if dev_ms is None:
        print("train step busy share: not measured (the profiler trace "
              "held no device time)")
    else:
        n = sum(c for _, _, c in kernels)
        print(f"3 train steps under torch.profiler: device time {dev_ms} ms "
              f"of {wall_ms} ms wall, card busy "
              f"{dev_ms / wall_ms * 100:.2f}%, idle "
              f"{(1 - dev_ms / wall_ms) * 100:.2f}%; {n / 3:.0f} device "
              f"kernels per step")
        print("  device ms per step by kernel, longest first:")
        for name, ms, count in kernels[:14]:
            print(f"    {ms / 3:9.3f} ms {count / 3:6.0f}x  {name[:110]}")
        ours = {n: sum(ms for k, ms, _ in kernels if n in k) / 3
                for n in ("randtopk_mask_kernel", "decode_rows_kernel")}
        print(f"  the codec kernels per step: {ours} (decode_rows_kernel "
              f"covers decode_rows and scatter_rows)")

    for comp in ("randtopk_mask", "quant", "size_reduction"):
        other = steps.make_train_step(_train_cfg(comp), rt)
        _lib.reset_launch_counts()
        ls = []
        for i in range(TRAIN_OTHER_STEPS):
            params, opt, m = other(params, opt, batches[i], gen)
            ls.append(float(m["loss"]))
        c = _lib.launch_counts()
        missing = [n for n in TRAIN_PATH_KERNELS[comp] if c[n] == 0]
        if missing:
            fail(f"training {comp} path never launched {missing}")
        if not all(math.isfinite(v) for v in ls):
            fail(f"training {comp} losses not finite: {ls}")
        print(f"{comp} training: losses {ls}, launches {c}")
    del params, opt
    torch.cuda.empty_cache()
    return counts


def tabular_phase(dev):
    """The paper's two-party tabular trainer (Table 3's setting) for one
    epoch with randtopk, kernels against the plain versions on the card."""
    import torch
    from repro_torch.data.synthetic import ManyClassDataset
    from repro_torch.kernels import _lib
    from repro_torch.split import tabular

    ds = ManyClassDataset()
    out = {}
    for backend in ("torch", None):
        spec = tabular.SplitSpec(method="randtopk", backend=backend)
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        out[backend] = r = tabular.train(spec, ds, epochs=1, device="cuda")
        torch.cuda.synchronize()
        r["wall_s"] = time.perf_counter() - t0
        r["launches"] = _lib.launch_counts()
    plain, kern = out["torch"], out[None]
    if any(plain["launches"].values()):
        fail(f"tabular plain-version run launched {plain['launches']}")
    if kern["launches"]["randtopk_mask"] < kern["steps"]:
        fail(f"tabular randtopk launched its mask kernel "
             f"{kern['launches']['randtopk_mask']} times in "
             f"{kern['steps']} steps")
    # one generator, one card and bit-identical masks, decodes and
    # scatters: the two runs train the same weights, bit for bit
    off = [f"{part}.{n}" for part in ("bottom", "top")
           for n in kern[part]
           if not torch.equal(kern[part][n], plain[part][n])]
    if off or kern["final_loss"] != plain["final_loss"]:
        fail(f"tabular training with kernels differs from the plain "
             f"versions: final loss {kern['final_loss']} vs "
             f"{plain['final_loss']}, differing tensors {off}")
    if kern["test_acc"] != plain["test_acc"]:
        fail(f"tabular test accuracy {kern['test_acc']} with kernels, "
             f"{plain['test_acc']} with the plain versions")
    print(f"tabular randtopk (in 64, hidden 256, cut 128, 100 classes, "
          f"k={kern['k']}, batch 128, 1 epoch = {kern['steps']} steps): "
          f"final loss {kern['final_loss']} and every trained tensor "
          f"identical to the plain versions' run; test acc "
          f"{kern['test_acc']} (both runs); train bytes "
          f"{kern['train_bytes_measured']:.0f} measured, "
          f"{kern['train_bytes']:.0f} Table 2; wall {kern['wall_s']:.2f} s "
          f"kernels, {plain['wall_s']:.2f} s plain; launches "
          f"{kern['launches']}")


def smoke_train_cpu_vs_card(dev, n_steps=3, rtol=1e-5):
    """yi-6b SMOKE in f32, randtopk: the CPU's plain versions against the
    card's kernels, from one set of weights and batches. The RandTopK
    draws are made on the CPU for both runs, so both see the same noise."""
    import torch
    from repro_torch.core import selection
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import _lib
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.models.config import Runtime
    from repro_torch.optim.adamw import adamw_init

    cfg = _train_cfg("randtopk", layers=None, cut=1, smoke=True, k=16)
    p0 = transformer.init_model(cfg, torch.Generator().manual_seed(2))
    pipe = TokenPipeline(cfg, 2, 32, seed=3, device="cpu")
    batches = [pipe.next_batch(i) for i in range(n_steps)]
    draw_m, draw_g = selection.binomial_nontop_count, selection.gumbel_noise
    losses = {}
    try:
        for device in ("cpu", "cuda"):
            cpu_gen = torch.Generator().manual_seed(4)
            selection.binomial_nontop_count = \
                lambda g, *a, device=None, **kw: draw_m(
                    cpu_gen, *a, **kw).to(device)
            selection.gumbel_noise = \
                lambda g, shape, device=None: draw_g(cpu_gen, shape).to(
                    device)
            params = _to(p0, device)
            opt = adamw_init(params)
            step = steps.make_train_step(cfg, Runtime(training=True),
                                         lr=1e-3)
            _lib.reset_launch_counts()
            losses[device] = []
            for b in batches:
                params, opt, m = step(params, opt, _to(b, device),
                                      torch.Generator())
                losses[device].append(float(m["loss"]))
            counts = _lib.launch_counts()
            launched = sum(counts[n] for n in TRAIN_PATH_KERNELS["randtopk"])
            if (device == "cpu") != (launched == 0):
                fail(f"SMOKE training on {device}: launches {counts}")
    finally:
        selection.binomial_nontop_count = draw_m
        selection.gumbel_noise = draw_g
    for a, b in zip(losses["cpu"], losses["cuda"]):
        if abs(a - b) > rtol * abs(a):
            fail(f"yi-6b SMOKE f32 training: card losses {losses['cuda']} "
                 f"!= CPU losses {losses['cpu']}")
    print(f"yi-6b SMOKE f32 training, {n_steps} steps: card losses "
          f"{losses['cuda']} vs CPU {losses['cpu']} (rtol {rtol})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("all", "kernels", "serve", "train"),
                    default="all",
                    help="kernels: build + kernel checks only; serve / "
                         "train: the checks and one path")
    ap.add_argument("--layers", type=int, default=32,
                    help="serving depth of yi-6b (width is never cut)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _lib.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for line in _lib.LAST_BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    g = torch.Generator(device=dev).manual_seed(0)
    records = [check_topk(dev, g), check_encode(dev, g), check_pack(dev, g),
               check_decode(dev, g), check_randtopk(dev, g),
               check_decode_rows(dev, g), check_scatter_rows(dev, g)]
    print("kernel checks: all seven kernels agree with their plain versions "
          "(masks, indices, words, packed bits, quant codes, scattered and "
          "non-quant decoded values exact; quant headers and decoded "
          "values within 1 ulp; projected rows within 1 ulp plus 1e-5 of "
          "the summed |terms|)")

    # each kernel's launches are read from the run of the path it serves:
    # the four codec kernels of serving from the serving randtopk run, the
    # three of training from the training randtopk run
    launches = {r["name"]: 0 for r in records}
    if args.phase in ("all", "serve"):
        t0 = time.perf_counter()
        counts = serve_phase(dev, args.layers)
        for n in PATH_KERNELS["randtopk"]:
            launches[n] = counts[n]
        print(f"serving phases: {time.perf_counter() - t0:.1f} s")
    if args.phase in ("all", "train"):
        t0 = time.perf_counter()
        counts = train_phase(dev)
        for n in TRAIN_PATH_KERNELS["randtopk"]:
            launches[n] = counts[n]
        tabular_phase(dev)
        smoke_train_cpu_vs_card(dev)
        print(f"training phases: {time.perf_counter() - t0:.1f} s")

    for r in records:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


if __name__ == "__main__":
    sys.exit(main())
