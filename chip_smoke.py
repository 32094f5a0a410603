#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (`src/repro_torch`), one card.

    python3 chip_smoke.py                     # everything
    python3 chip_smoke.py --phase kernels     # build, kernel checks, probes
    python3 chip_smoke.py --phase train       # kernel checks + training
    python3 chip_smoke.py --phase serve       # kernel checks + serving
    python3 chip_smoke.py --phase fedtrain    # kernel checks + fedtrain
    python3 chip_smoke.py --phase loadgen     # kernel checks + open loop
    python3 chip_smoke.py --phase families    # kernel checks + 5 models
    python3 chip_smoke.py --phase probe       # build + `probe_kernels`
    python3 chip_smoke.py --phase ab --parent DIR   # probes, P C C P
    python3 chip_smoke.py --phase predict     # CPU: phase 11's reports

Phases, each fatal on failure:

  1. build the port's CUDA kernels from `src/repro_torch/csrc` (nvcc,
     sm_90a, one process per source, seven sources, twelve launchers);
  2. hold each kernel against its plain PyTorch version on the card, at
     the shapes its path gives it (serving: one row of d 4096, 1024 and
     3072, and 1- and 2-row flushes at d 1024 and 3072; training: 1024
     rows of d 4096 and 1024, k 64; the standalone top-k: the tabular
     evaluation's 4000 and 20000 rows of 128 f32, k 3) and at odd ones (rows not a multiple of a
     block, d not a multiple of 32, k in {1, 64, d-1}, ties, duplicate and
     out-of-range indices, d = 16384): masks, indices, words, scattered
     and non-quant values exact; the fused client codec
     (`encode_sections`) byte for byte, leaves and wire sections, with the
     support selected in the launch and given as a mask, for every kind at
     the serving row, the fedtrain batch (128 x 128 f32 k 3, whose rows
     share packed words), 16384-wide and odd rows, on random rows, ties,
     zeros, signed zeros and rows of few magnitudes; quant headers of
     `encode_rows` and decoded values within
     1 ulp, quant codes exact; projected rows within 1 ulp plus 1e-5 of
     the summed |terms|; the serve's flush decode (`decode_to_slots`)
     for every kind at a 4-row bf16 flush with a pad row on the scratch
     slot, slots out of order, two pad rows on one slot, slots outside
     the buffer (skipped), d 16384 and odd widths, duplicate and
     out-of-range sparse indices; `quantize` (no path runs it) at a
     training cut (1024 x 4096 bf16), a serving flush (4 x 4096 bf16), odd
     shapes, a constant row and rows of signed zeros (d 4, 1001, 4096) for
     bits 2, 4, 8: codes exact, lo and step equal as u32, dequantized
     values within 1 ulp; flash attention (no path runs it): the f32 SIMT
     kernel at the reference tests' four configurations (atol 3e-5), the
     bf16 tensor-core kernel at the same four, at S 32 (below its 128-row
     tile) and at yi-6b's width (Hq 32, Hkv 4, hd 128; B 4 S 256, B 1 S
     4096, B 1 S 4096 with a 1024 window; atol 3e-2), and `project_qkv` +
     flash + wo against the model's `full_attention` at yi-6b width in f32
     (atol and rtol 3e-4); time kernel, plain version and, where one
     exists, the single PyTorch call that computes the same function; for
     flash also the kernel's own device time per launch from a profiler
     trace and its TFLOP/s; for decode_rows (the training cut, a fedtrain
     frame) and scatter_rows where the wrapper's time goes (device time
     per launch, host time per call, of it the allocation and the bare
     launch), with `scatter_add_` in place and out of place and a zero
     fill of the output beside decode_rows; then the codec probes
     (`probe_kernels`, `probe_fused`, `codec_token_ms`): the same split
     for topk_mask_threshold (serving row, tabular batch, the tabular
     evaluation, 1024 x 4096), pack_bits (serving row, fedtrain batch),
     encode_rows (serving row, fedtrain batch) and the fused encode,
     randtopk_mask (training cut, tabular batch), decode_to_slots at
     each serve kind's 4-row flush, quantize (1024 x 4096 and 4 x 4096
     bf16, 4 bits), scatter_rows beside a fresh `zeros.scatter_add`, and
     the serving
     client's whole codec per token (host clock around
     `client_encode_device` + `sections_to_bytes`) with its launches;
  3. serve yi-6b at full width (d 4096, bf16, random weights from a seed)
     through `runtime.engine.run_streaming` with `randtopk --k 64`, the cut
     at n_layers // 2: the launch counts (zeroed just before) must show
     every kernel ran, the fused encode once per client token (and once
     for the engine's warm-up step) and no top-k, encode_rows or
     bit-pack launch beside it, the flush decode once per flush (and
     twice per flush bucket in the warm-up), no host densification,
     measured payload
     bytes per
     token = `comp.fwd_bits(d) / 8`, and the tokens must equal a second run
     with the plain versions forced (`backend="torch"`); tokens/s of two
     untraced runs, and the card's busy share from a `torch.profiler` trace
     of a third run of the threaded loop itself;
  4. the client and server steps timed alone, with their kernel time from
     a `torch.profiler` trace of calls made alone;
  5. the same path with the identity, quant and randtopk_mask compressors,
     so every encode and decode kind reaches a kernel, each token's codec
     again one fused launch;
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
     of the path reaches `decode_rows`; then a checkpoint round trip
     through `launch.train.main --ckpt-dir`: granite-moe-1b-a400m at
     full width, depth cut from 24 to 2 layers (cut at 1), batch 4 x seq
     256, randtopk k 64, 3 steps with `--ckpt-every 3` and resumed to 6
     = 6 uninterrupted steps bit for bit (printed losses, final params),
     with the checkpoint's size and its save and restore seconds;
  8. the paper's two-party tabular trainer (`split.tabular.train`, the
     `SplitSpec` defaults, batch 128) for one epoch with randtopk, with
     the kernels and with the plain versions: its byte assertion holds
     and the two runs end with the same loss and trained weights, bit for
     bit;
  9. yi-6b SMOKE in f32: 3 training steps on the CPU (plain versions) and
     on the card (kernels) from one set of weights, batches and RandTopK
     draws give losses within rtol 1e-5;
 10. federated split training over the wire (`fedtrain.run_fedtrain`) at
     the tabular phase's widths, batch 128: one randtopk client for one
     epoch gives `tabular.train`'s losses (rtol 1e-5) and final weights on
     the card; four randtopk_mask clients with the adaptive schedule and
     4 local steps for two epochs (78 steps), stopped at step 40 and
     resumed from a checkpoint every 20 steps in a temporary directory,
     equal the uninterrupted run in losses, bytes and final weights;
     measured bytes within 5% of the analytics both ways, no host
     densification, and the codec kernels' launches (counts zeroed just
     before each run) show the path went through them, two a client step
     for one randtopk client (the Eq. (7) mask and the fused encode); wall
     time, steps
     per second and the busy share from a `torch.profiler` trace of a
     rerun; then under seeded chaos with the kernels built, ARQ 0.3 s x
     40 retries: one randtopk client under `FaultPlan(seed=7)` and under
     the heavy-corruption plan (ARQ 0.2 s x 60; reconnects > 0) equals
     the clean card run bit for bit (losses, test accuracy, final
     weights) with the clean run's launches (one Eq. (7) mask and one
     fused encode a logical step, whatever the retransmits); four
     randtopk_mask clients under chaos complete every sync step; each
     run's registry bytes agree with its byte accounting; and a traced
     clean run gives one `client.encode` and one `server.queue_wait`
     span a step, with their median host ms;
 11. open-loop serving of yi-6b FULL (32 layers, cut at 16, bf16):
     (a) 6 clients x (4 + 8) tokens, randtopk k 64, max_batch 4, at
     capacity 2 with the kernels and with the plain versions and at
     capacity 6: equal tokens, evictions and readmissions > 0 in both
     contended runs; (b) the same clients under `FaultPlan(seed=3)` chaos
     with ARQ (retry_timeout 0.3 s, 40 retries): the clean run's tokens,
     replays, reconnects and detected faults > 0; (c) `run_loadgen`, the
     reference tests' `_mini` scenario at full width (mmpp, 2.5 s,
     prompt 2-3, gen 3-5, 400 kB/s links, capacity 16, max_batch 8),
     static (randtopk k 64, 12/24 sessions/s) and QoS (randtopk_quant
     k 64 8-bit down a ladder to (8, 4), 20/40 sessions/s), each with the
     kernels and then the plain versions: equal reports (tokens
     included) but `wall_s_real`, no real waits, no failures, QoS
     switches > 0 with the 4-bit rung reached, one fused encode per
     served token and one flush decode per (flush, meta) group; (d) a
     traced closed-loop `launch/serve --trace`: spans nest, each span's
     count and median host ms;
 12. the qk-norm dense and mixture-of-experts families at full width
     (`--phase families`), random bf16 weights from a seed: serve
     granite-moe-1b-a400m (24 layers, d 1024), qwen3-8b (36, qk-norm),
     granite-3-8b (40), phi3-mini-3.8b (32, d 3072) and
     qwen3-moe-235b-a22b (depth cut from 94 to 4 layers to fit the card),
     each with the cut at n_layers // 2, through `run_streaming` with 2
     clients x (4 + 8) tokens, randtopk k 64, with the kernels and with
     the plain versions: equal tokens below the vocabulary, payload bytes
     per token = `fwd_bits(d) / 8`, one fused encode per served token
     and one flush decode per flush group, no host densification; tokens/s,
     init time and peak memory of each; then train granite-moe-1b-a400m
     FULL (cut 12, batch 4 x seq 256, randtopk k 64 alpha 0.1): two plain
     first steps equal each other and the kernels' first step bit for
     bit (loss, aux, grad norm, updated parameters), aux > 0, the pairs
     dropped at capacity in the first forward, 3 steps through the
     kernels with their median ms and peak memory.

Prints the card's name and power limit, a `kernels` JSON line (each
kernel's launches on its path's randtopk run, for the serve's two kernels
plus the loadgen phase's kernel runs, plus the families phase's serves
and training, plus the fedtrain phase's chaos runs and launch.train's
resumed checkpoint run, or in its check's own loop for the
five no path runs, its largest difference from its plain version,
the CUDA-event times of kernel, plain version and library call at its
path's shapes, and the card's bound for the same work), the loop's and
the step's numbers, and as its last line {"ok": true, "device": {...}}.
Exits nonzero, with no result line, when CUDA is unavailable or any phase
fails.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM non-tensor f32 (data sheet)
BF16_TENSOR_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
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


def device_ms(fn, match=None, n: int = 20):
    """Device time per call of `fn` from a `torch.profiler` trace of `n`
    calls after a warm-up: the summed time of the device kernels whose name
    holds `match` (every kernel when None) over `n`, and their names; the
    time is None when the trace holds no such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
          and (match is None or match in e.key)]
    total = sum(e.self_device_time_total for e in ev) / 1e3
    return (total / n if total > 0 else None), sorted({e.key for e in ev})


def host_us(fn, n: int = 1000) -> float:
    """Host microseconds per call of `fn` over `n` calls with no
    synchronize, the card idle at the start (what the caller's thread
    pays to enqueue the work)."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def split_probe(label, wrapper, kernel, alloc, launch, bound):
    """Where a wrapper's time goes at one shape: its CUDA-event ms, the
    device ms per launch of the kernels whose name holds `kernel` (every
    kernel of the call when None; from a profiler trace), the host us per
    call, and of that the output allocation (`alloc`, None for a wrapper
    that allocates nothing) and the bare launch with fixed arguments
    (`launch`: ctypes call, kernel launch, count). Prints one line and
    returns the numbers."""
    ms = time_ms(wrapper)
    dev, names = device_ms(wrapper, kernel)
    rec = dict(shape=label, ms=ms, device_ms=dev, kernels=names,
               host_us=host_us(wrapper),
               alloc_us=None if alloc is None else host_us(alloc),
               launch_us=host_us(launch), bound_ms=bound[0],
               bound_by=bound[1])
    print(f"  {label}: wrapper {ms} ms (CUDA events), kernel device {dev} "
          f"ms per launch {names}, host {rec['host_us']} us per call, of "
          f"which output allocation {rec['alloc_us']} us and bare launch "
          f"{rec['launch_us']} us; bound {bound[0]} ms ({bound[1]})")
    return rec


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """The least time the card needs: max(bytes / HBM rate, ops / peak
    rate), the f32 peak unless another is named. Returns (ms, "bytes" |
    "operations")."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
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

def _tabular_eval_shape():
    """The shapes a path gives the standalone top-k: the tabular trainer's
    evaluation, the whole test set's and then the train set's cut rows at
    once (`n_test` and `n_train` rows of `cut_dim` f32, k of
    `SplitSpec`)."""
    from repro_torch.data.synthetic import ManyClassDataset
    from repro_torch.split.tabular import SplitSpec

    spec = SplitSpec()
    return (ManyClassDataset.n_test, ManyClassDataset.n_train, spec.cut_dim,
            spec.k)


def check_topk(dev, g):
    """The standalone top-k against its plain version, exact, at the
    tabular evaluation's shapes (its only path), the serving row, odd
    shapes and 16384-wide rows, each on random rows, ties (halves), zeros
    and negatives; timed at the test set's rows."""
    import torch
    from repro_torch.kernels.randtopk import ops, ref

    rows, rows_train, d_tab, k_tab = _tabular_eval_shape()
    cases = [((rows, d_tab), torch.float32, k_tab),
             ((rows_train, d_tab), torch.float32, k_tab),
             ((128, d_tab), torch.float32, k_tab),
             ((1, D), torch.bfloat16, K), ((37, 1000), torch.float32, 1),
             ((37, 1000), torch.float32, 64), ((37, 1000), torch.float32,
                                               999),
             ((3, 16384), torch.bfloat16, K), ((5, 4097), torch.float32, 64),
             ((9, 70), torch.float32, 3), ((9, 512), torch.bfloat16, 64)]
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
    x = torch.randn((rows, d_tab), generator=g, device=dev)
    mag = x.abs()
    ms = time_ms(lambda: ops.topk_mask_threshold(x, k_tab))
    plain = time_ms(lambda: ref.topk_mask_threshold(x, k_tab))
    lib = time_ms(lambda: torch.topk(mag, k_tab, dim=-1))
    # radix passes, rank, store
    b = bound_ms(rows * (d_tab * 4 + d_tab + 4), 5 * rows * d_tab)
    print(f"  topk_mask_threshold: {len(cases) * 4} cases equal to the "
          f"plain version (mask and threshold), the tabular evaluation's "
          f"{rows} and {rows_train} x {d_tab} f32 k {k_tab} among them; "
          f"timed at the first: "
          f"kernel {ms} ms, plain {plain} ms, torch.topk {lib} ms, bound "
          f"{b[0]} ms")
    return dict(name="topk_mask_threshold", route="cuda",
                source="src/repro_torch/csrc/topk_select.cu",
                replaces="src/repro/kernels/randtopk/kernel.py:133",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=lib,
                library_call="torch.topk(|x| f32, k)")


KIND_CASES = [("dense", 0, 0), ("slice", K, 0), ("sparse", K, 0),
              ("quant", 0, 4), ("sparse_quant", K, 8), ("mask", K, 0)]
# the QoS ladder's lower rungs the loadgen serves (k 32/16/8, 8 and 4 bits)
RUNG_KS = (32, 16, 8)
RUNG_CASES = [("sparse_quant", k, bits) for k in RUNG_KS for bits in (8, 4)]


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
    """`encode_rows` (mask given, no sections) against its plain version.
    No path runs it since the client's codec is the fused encode, so its
    launches are those of this check's own loop."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels.encode import ops, ref
    from repro_torch.kernels.randtopk import ref as tref

    err = 0.0
    _lib.reset_launch_counts()
    for kind, k, bits in KIND_CASES:
        x = torch.randn((1, D), generator=g, device=dev).to(torch.bfloat16)
        err = max(err, _encode_case(x, kind, k, bits))
        xo = torch.randn((37, 1000), generator=g, device=dev)
        for kk in ((1, 64, 999) if k else (0,)):
            err = max(err, _encode_case(xo, kind, kk, bits))
        err = max(err, _encode_case(torch.zeros((3, 70), device=dev), kind,
                                    min(k, 70), bits))
    launches = _lib.launch_counts()["encode_rows"]
    # its times at the serving row (sparse: a top-k mask, values and
    # indices); `probe_kernels` splits them into host and device
    x = torch.randn((1, D), generator=g, device=dev).to(torch.bfloat16)
    mask = tref.topk_mask_threshold(x, K)[0]
    ms = time_ms(lambda: ops.encode_rows(x, "sparse", k=K, mask=mask))
    plain = time_ms(lambda: ref.encode_rows(x, "sparse", K, 0, mask))
    b = bound_ms(D * 2 + D + K * 8, 2 * D)
    return dict(name="encode_rows", route="cuda",
                source="src/repro_torch/csrc/encode_rows.cu",
                replaces="src/repro/kernels/encode/kernel.py:160",
                launches=launches,
                launches_from="this check's own loop: no path runs it (the "
                              "client's codec is encode_sections)",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=None)


def _hostile_rows(x, g):
    """The rows a selection can trip on, from one random batch: ties at
    the kth (values rounded to halves), all zeros, -0.0 beside +0.0, and
    many equal magnitudes (a handful of values, signs mixed)."""
    import torch

    few = torch.tensor([0.5, -0.5, 1.0, -1.0, 2.0], device=x.device)
    pick = torch.randint(0, 5, x.shape, generator=g, device=x.device)
    return [("random", x), ("halves", torch.round(x * 2) / 2),
            ("zeros", torch.zeros_like(x)),
            ("signed zeros", torch.where(x < 0, -0.0, 0.0).to(x.dtype)),
            ("few magnitudes", few[pick].to(x.dtype))]


SECTION_CASES = [((1, D), "bfloat16"),          # the serving client's row
                 ((1, 1024), "bfloat16"),       # ... granite-moe's (10 bits)
                 ((1, 3072), "bfloat16"),       # ... phi3's (12 bits)
                 ((128, 128), "float32"),       # fedtrain: rows share words
                 ((3, 16384), "bfloat16"), ((3, 16384), "float32"),
                 ((37, 1000), "float32"), ((5, 4097), "float32"),
                 ((9, 70), "bfloat16"), ((9, 512), "bfloat16"),
                 ((6, 200), "float32")]


def check_encode_sections(dev, g):
    """The fused client codec against `ref.encode_sections`, byte for byte:
    every leaf and every wire section equal, in both modes (`select`: the
    kernel's own top-k; `mask=`: a Eq. (7) mask drawn by the plain
    version, and a top-k one), for every kind at the serving rows (d 4096,
    1024 and 3072), the
    fedtrain batch (128 x 128 f32 k 3: 21 index bits a row, so rows share
    packed words), 16384-wide rows and odd widths, on the hostile rows of
    `_hostile_rows`. Then its times at the serving row (sparse, select)."""
    import torch
    from repro_torch.core import selection
    from repro_torch.core.payload import KIND_LEAVES
    from repro_torch.kernels import _lib
    from repro_torch.kernels.encode import ops, ref
    from repro_torch.kernels.randtopk import ref as tref

    err, n = 0.0, 0
    for shape, dt in SECTION_CASES:
        x0 = torch.randn(shape, generator=g, device=dev).to(
            getattr(torch, dt))
        rows, d = shape
        ks = sorted({min(k, d) for k in (1, 3, K) + RUNG_KS} | {d})
        for label, x in _hostile_rows(x0, g):
            for kind, bits_list in (("sparse", (0,)), ("mask", (0,)),
                                    ("sparse_quant", (3, 4, 8)),
                                    ("quant", (3, 4, 8)), ("dense", (0,)),
                                    ("slice", (0,))):
                for k in (ks if kind != "quant" and kind != "dense"
                          else (0,)):
                    for bits in bits_list:
                        modes = [("", False, None)]
                        if kind in ops.MASK_KINDS:
                            gum = selection.gumbel_noise(g, shape,
                                                         device=dev)
                            m = torch.randint(0, k + 1, (rows, 1),
                                              generator=g, device=dev)
                            modes = [
                                ("select", True, None),
                                ("top-k mask", False,
                                 tref.topk_mask_threshold(x, k)[0]),
                                ("Eq. 7 mask", False,
                                 tref.randtopk_mask(x, gum, m, k))]
                        for mode, select, mask in modes:
                            p, secs = ops.encode_sections(
                                x, kind, k=k, bits=bits, mask=mask,
                                select=select)
                            leaves, want = ref.encode_sections(
                                x, kind, k, bits, mask, select)
                            torch.cuda.synchronize()
                            got = [getattr(p, nm) for nm in KIND_LEAVES[kind]]
                            for a, b in list(zip(got, leaves)) + \
                                    list(zip(secs, want)):
                                if a.shape != b.shape or a.dtype != b.dtype \
                                        or not torch.equal(
                                            a.contiguous().view(-1).view(
                                                torch.uint8),
                                            b.contiguous().view(-1).view(
                                                torch.uint8)):
                                    fail(f"encode_sections {kind} {mode} "
                                         f"!= plain at {shape} {dt} k={k} "
                                         f"bits={bits} rows {label}")
                                err = max(err, max_diff(a, b))
                            n += 1
    print(f"  encode_sections: {n} cases, leaves and wire sections equal "
          f"to ref.encode_sections byte for byte (select and mask= modes; "
          f"shapes {[s for s, _ in SECTION_CASES]}; rows random, ties, "
          f"zeros, signed zeros, few magnitudes)")
    x = torch.randn((1, D), generator=g, device=dev).to(torch.bfloat16)
    ms = time_ms(lambda: ops.encode_sections(x, "sparse", k=K, select=True))
    plain = time_ms(lambda: ref.encode_sections(x, "sparse", K, 0,
                                                select=True))
    b = sections_bound(D, 2, "sparse", K, 0)
    return dict(name="encode_sections", route="cuda",
                source="src/repro_torch/csrc/encode_rows.cu",
                replaces="src/repro/kernels/encode/kernel.py:160",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=None,
                library_call="none: no PyTorch call selects, gathers and "
                             "bit-packs a row")


def sections_bound(d, x_bytes, kind, k, bits, rows=1, masked=False):
    """The fused encode's bound: x read once (and a mask byte per element
    where one is given), the leaves and sections written
    once; the operations of two radix passes, the scan and the gather per
    element (select) or one per element, f32 peak."""
    import math

    r = math.ceil(math.log2(d)) if d > 1 else 1
    per = {"sparse": k * 4 + k * 4 + math.ceil(k * r / 8),
           "quant": d * 4 + 8 + math.ceil(d * bits / 8),
           "sparse_quant": k * 8 + 8 + math.ceil(k * (r + bits) / 8),
           "mask": k * 4 + 4 * math.ceil(d / 32),
           "dense": d * 4, "slice": k * 4}[kind]
    return bound_ms(rows * (d * x_bytes + (d if masked else 0) + per),
                    4 * rows * d)


def check_pack(dev, g):
    """`pack_bits` against its plain version at every width. No path runs
    it since the fused encode packs its own streams, so its launches are
    those of this check's own loop."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels.encode import ops, ref

    err = 0.0
    _lib.reset_launch_counts()
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
    launches = _lib.launch_counts()["pack_bits"]
    idx = torch.randint(0, D, (K,), generator=g, device=dev,
                        dtype=torch.int32)
    ms = time_ms(lambda: ops.pack_bits(idx, W_IDX))
    plain = time_ms(lambda: ref.pack_bits(idx, W_IDX))
    b = bound_ms(K * 4 + (K + 31) // 32 * W_IDX * 4, K * 4)
    return dict(name="pack_bits", route="cuda",
                source="src/repro_torch/csrc/pack_bits.cu",
                replaces="src/repro/kernels/encode/kernel.py:236",
                launches=launches,
                launches_from="this check's own loop: no path runs it (the "
                              "fused encode packs its own streams)",
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


# the serve's four compressors and the payload kinds they send
SERVE_KINDS = (("randtopk", "sparse", K, 0), ("identity", "dense", 0, 0),
               ("quant", "quant", 0, 4), ("randtopk_mask", "mask", K, 0))


def _decode_to_slots_case(dev, g, p, slots, cap, dt):
    """The kernel and the plain version on one flush, each into a copy of
    one random xbuf (cap + 1, 1, 1, d) in `dt`; a row aimed outside
    [0, cap] goes to the kernel alone (which skips it; the plain version's
    index would wrap or raise). Returns (kernel's xbuf, plain's)."""
    import torch
    from repro_torch.core.payload import KIND_LEAVES
    from repro_torch.kernels.decode import ops, ref

    kind, d = p.meta.kind, p.meta.d
    base = torch.randn((cap + 1, 1, 1, d), generator=g, device=dev).to(dt)
    xa, xb = base.clone(), base.clone()
    ops.decode_rows_to_slots(xa, p, slots)
    keep = (slots >= 0) & (slots <= cap)
    leaves = [getattr(p, nm)[keep] for nm in KIND_LEAVES[kind]]
    ref.decode_to_slots(xb, leaves, slots[keep], kind, d)
    torch.cuda.synchronize()
    return xa, xb


def _decode_cases(kind, k):
    """(label, d, dtype, rows, real rows, slots, k, hostile, cap) of one
    kind; the scratch slot is cap (6 as in the serve phase, 16 as in the
    loadgen's), pad rows (zero leaves) follow the real ones."""
    import torch

    bf, f32 = torch.bfloat16, torch.float32
    cases = [
        ("serve flush, one pad row", D, bf, 4, 3, [0, 1, 2, 6], k, False),
        ("slots out of order", D, bf, 4, 4, [3, 0, 5, 1], k, False),
        ("two pad rows on the scratch slot", D, bf, 4, 2, [4, 2, 6, 6], k,
         False),
        ("slots outside [0, cap1) skipped", D, bf, 4, 4, [0, 9, 2, -1], k,
         False),
        ("d 16384", 16384, bf, 4, 3, [1, 0, 2, 6], k, False),
        ("d 1000, f32", 1000, f32, 8, 5, [5, 3, 1, 0, 2, 6, 6, 6],
         min(k, 999), False),
        ("d 1000, k 999", 1000, f32, 3, 3, [2, 0, 1], 999 if k else 0,
         False),
        ("d 70, f32", 70, f32, 8, 6, [5, 4, 3, 2, 1, 0, 6, 6], k, False)]
    cases = [c + (6,) for c in cases]
    # the families phase's 2-client flushes (buckets of 1 and 2 rows into
    # a 3-row buffer) at granite-moe's and phi3's widths
    for d in (1024, 3072):
        cases += [(f"d {d} flush, 2 rows", d, bf, 2, 2, [1, 0], k, False,
                   2),
                  (f"d {d} flush, 1 row", d, bf, 1, 1, [1], k, False, 2),
                  (f"d {d} flush, one pad row", d, bf, 2, 1, [0, 2], k,
                   False, 2)]
    # the loadgen's flush buckets (1, 2, 4, 8 rows) into a 17-row buffer
    cases += [
        ("loadgen flush, 1 row", D, bf, 1, 1, [11], k, False, 16),
        ("loadgen flush, 2 rows", D, bf, 2, 2, [15, 0], k, False, 16),
        ("loadgen flush, 4 rows, one pad", D, bf, 4, 3, [13, 7, 1, 16], k,
         False, 16),
        ("loadgen flush, 8 rows, three pads", D, bf, 8, 5,
         [9, 2, 14, 5, 0, 16, 16, 16], k, False, 16)]
    if kind in ("sparse", "sparse_quant", "mask"):
        cases.append(("duplicate and out-of-range indices", D, bf, 4, 3,
                      [2, 0, 1, 6], k, True, 6))
    return cases


def check_decode(dev, g):
    """`decode_rows_to_slots` (the serve's flush decode) against its plain
    version: every kind, and sparse_quant on every QoS rung, at the serve's
    4-row bf16 flush with a pad row on the scratch slot, the loadgen's 1-,
    2-, 4- and 8-row flushes into 17 rows, the families phase's 1- and
    2-row flushes at d 1024 and 3072, slots out of order, two pad rows
    on one slot, slots outside the buffer, d 16384 and odd widths, and
    duplicate and out-of-range sparse indices (mask words with bits past
    k): every kind exact (both dequantize as lo + (code + 0.5) * step,
    each rounding explicit)."""
    import torch
    from repro_torch.kernels.decode import ops, ref

    err, n_cases = 0.0, 0
    for kind, k, bits in KIND_CASES + RUNG_CASES:
        for (label, d, dt, n, n_real, sl, kk, hostile,
             cap) in _decode_cases(kind, k):
            if hostile:
                p = _rows_payload(dev, g, kind, kk, bits, n, d, hostile=True)
                for leaf in (p.values, p.indices, p.header):
                    if leaf is not None:
                        leaf[n_real:] = 0
            else:
                p = _flush_payload(dev, g, kind, kk, bits, n, d, n_real)
            slots = torch.tensor(sl, dtype=torch.int32, device=dev)
            xa, xb = _decode_to_slots_case(dev, g, p, slots, cap, dt)
            if not torch.equal(xa, xb):
                fail(f"decode {kind} k={kk} bits={bits}: kernel != plain: "
                     f"{label}")
            err = max(err, max_diff(xa, xb))
            n_cases += 1
    print(f"decode_to_slots: {n_cases} flushes equal the plain version "
          f"exactly (every kind; sparse_quant at k {RUNG_KS} x 8/4 bits)")
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
                source="src/repro_torch/csrc/decode_rows.cu",
                replaces="src/repro/kernels/decode/kernel.py:224",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=lib,
                library_call="xbuf.index_put_((slot, index), values): the "
                             "k values only, the row is not zeroed")


TRAIN_ROWS = 1024               # a training step: batch 4 x seq 256
D_MOE = 1024                    # granite-moe-1b-a400m's width


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

    cases = [((TRAIN_ROWS, D), torch.bfloat16, K),
             ((TRAIN_ROWS, D_MOE), torch.bfloat16, K),
             ((37, 1000), torch.float32, 1),
             ((37, 1000), torch.float32, 64), ((37, 1000), torch.float32,
                                               500),
             ((37, 1000), torch.float32, 999), ((3, 16384), torch.bfloat16, K),
             ((5, 4097), torch.float32, 64),
             ((128, 128), torch.float32, 3),       # the tabular trainer's
             ((9, 70), torch.float32, 3), ((9, 512), torch.bfloat16, 64)]
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
    from repro_torch.core.payload import KINDS
    from repro_torch.kernels import _lib
    from repro_torch.kernels.decode import ops, ref

    err = 0.0
    for kind, k, bits in KIND_CASES:
        for n, d, kk, hostile in ((TRAIN_ROWS, D, k, False),
                                  (TRAIN_ROWS, D_MOE, k, False),
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
    # where the wrapper's time goes, at the yi-6b training cut and at one
    # fedtrain flush frame; beside it two yardsticks: in-place
    # `scatter_add_` into a zeroed buffer it does not zero again, and
    # out-of-place `zeros.scatter_add`, which returns a fresh buffer as the
    # decode must
    print("decode_rows, sparse, host/device split:")
    probes = []
    for label, n, d, k, dt in (
            ("training 1024 x 4096 k 64 -> bf16", TRAIN_ROWS, D, K,
             torch.bfloat16),
            ("fedtrain 128 x 128 k 3 -> f32", 128, 128, 3, torch.float32)):
        p = _rows_payload(dev, g, "sparse", k, 0, n, d)
        out = torch.empty((n, d), dtype=dt, device=dev)
        args = (p.values.data_ptr(), 0, p.indices.data_ptr(), 0, n, d,
                KINDS.index("sparse"), k, out.data_ptr(),
                int(dt == torch.bfloat16), _lib.stream_handle(out))
        probes.append(split_probe(
            label, lambda: ops.decode_rows(p, dtype=dt), "decode_rows",
            lambda: p.values.new_empty((n, d), dtype=dt),
            lambda: _lib.launch("decode_rows", *args),
            bound_ms(n * (k * 8 + d * out.element_size()), n * (d + k))))
        rec = probes[-1]
        zeros = torch.zeros((n, d), dtype=dt, device=dev)
        dense = zeros.clone()
        idx, vals = p.indices.long(), p.values.to(dt)
        rec["plain_ms"] = time_ms(lambda: ref.decode_rows(p, dt), iters=50)
        rec["library_ms"] = time_ms(lambda: dense.scatter_add_(-1, idx, vals))
        rec["library_fresh_ms"] = time_ms(
            lambda: zeros.scatter_add(-1, idx, vals))
        lib_dev, _ = device_ms(lambda: dense.scatter_add_(-1, idx, vals))
        fresh_dev, _ = device_ms(lambda: zeros.scatter_add(-1, idx, vals))
        # what the card takes to write the output alone: a zero fill
        fill_dev, _ = device_ms(lambda: out.zero_())
        print(f"    plain {rec['plain_ms']} ms; in-place scatter_add_ "
              f"{rec['library_ms']} ms (device {lib_dev}); out-of-place "
              f"zeros.scatter_add {rec['library_fresh_ms']} ms (device "
              f"{fresh_dev}); a zero fill of the output, device "
              f"{fill_dev} ms")
    # the projection epilogue (no path passes `project=`) at the training
    # cut with a square (4096, 4096) f32 matrix: f32 SIMT operations bound
    p = _rows_payload(dev, g, "sparse", K, 0, TRAIN_ROWS, D)
    w = torch.randn((D, D), generator=g, device=dev) / D ** 0.5
    pb = bound_ms(TRAIN_ROWS * (K * 8 + D * 4 + D * 2) + D * D * 4,
                  2 * TRAIN_ROWS * D * D)
    proj_ms = time_ms(lambda: ops.decode_rows(p, dtype=torch.bfloat16,
                                              project=w), iters=20)
    proj_dev, _ = device_ms(lambda: ops.decode_rows(
        p, dtype=torch.bfloat16, project=w), "project_rows")
    print(f"  decode_rows with project= (1024 x 4096 k 64 times a 4096 x "
          f"4096 f32 matrix -> bf16): wrapper {proj_ms} ms, product device "
          f"{proj_dev} ms ({2 * TRAIN_ROWS * D * D / proj_ms / 1e9} TFLOP/s "
          f"through the wrapper); bound {pb[0]} ms ({pb[1]}, f32 peak)")
    b = probes[0]
    return dict(name="decode_rows", route="cuda",
                source="src/repro_torch/csrc/decode_rows.cu",
                replaces="src/repro/kernels/decode/kernel.py:181",
                max_abs_err=err, ms=b["ms"], plain_ms=b["plain_ms"],
                bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                library_ms=b["library_ms"],
                library_call="dense.scatter_add_(-1, index, values) into a "
                             "zeroed bf16 buffer it does not zero again")


def check_scatter_rows(dev, g):
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels.randtopk import ops, ref

    err = 0.0
    # (2, 16384, 16384): a thread's 64 values, as many as its duplicate
    # record holds; (5, 9000, 70): k > d, more than that
    for n, k, d in ((TRAIN_ROWS, K, D), (TRAIN_ROWS, K, D_MOE),
                    (37, 1, 1000), (37, 999, 1000),
                    (5, 64, 4097), (3, 64, 16384), (2, 16384, 16384),
                    (5, 9000, 70)):
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
    # where the wrapper's time goes: the kernel's own device time from a
    # profiler trace, the host's time per call enqueueing it, and of that
    # the output's allocation and the bare launch (ctypes call, kernel
    # launch, count) with fixed arguments
    dev_ms, names = device_ms(lambda: ops.scatter_rows(vals, idx, D),
                              "decode_rows_scatter_kernel")
    lib_dev, lib_names = device_ms(
        lambda: dense.scatter_add_(-1, idx64, vals))
    out = vals.new_empty((TRAIN_ROWS, D))
    args = (vals.data_ptr(), 1, idx.data_ptr(), TRAIN_ROWS, D, K,
            out.data_ptr(), _lib.stream_handle(vals))
    print(f"  scatter_rows (1024 x 4096 bf16, k 64): wrapper {ms} ms "
          f"(CUDA events), kernel device {dev_ms} ms per launch {names}, "
          f"host {host_us(lambda: ops.scatter_rows(vals, idx, D))} us per "
          f"call, of which output allocation "
          f"{host_us(lambda: vals.new_empty((TRAIN_ROWS, D)))} us and bare "
          f"launch {host_us(lambda: _lib.launch('scatter_rows', *args))} "
          f"us; scatter_add_ wrapper {lib} ms, device {lib_dev} ms "
          f"{lib_names}, host "
          f"{host_us(lambda: dense.scatter_add_(-1, idx64, vals))} us per "
          f"call; bound {b[0]} ms ({b[1]})")
    return dict(name="scatter_rows", route="cuda",
                source="src/repro_torch/csrc/decode_rows.cu",
                replaces="src/repro/kernels/randtopk/kernel.py:199",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=lib,
                library_call="dense.scatter_add_(-1, index, values) into a "
                             "zeroed bf16 buffer it does not zero again")


QUANT_CASES = [((TRAIN_ROWS, D), "bfloat16"),    # a yi-6b training cut
               ((N_CLIENTS, D), "bfloat16"),     # a serving flush
               ((17, 96), "float32"), ((17, 96), "bfloat16"),
               ((3, 5, 96), "float32"), ((3, 5, 96), "bfloat16")]


def _signed_zero_rows(dev, g, rows, d):
    """Rows whose least value is a zero, with -0.0 in places: non-negative
    random rows with about one element in eight set to +0.0 or -0.0, the
    first row all +0.0 but a -0.0 at the end, the second all +0.0, the
    third all -0.0 (at d 4: the rows XLA's min and `fminf` disagree on)."""
    import torch

    x = torch.randn((rows, d), generator=g, device=dev).abs()
    at = torch.rand((rows, d), generator=g, device=dev)
    x = torch.where(at < 1 / 16, torch.zeros_like(x), x)
    x = torch.where(at > 15 / 16, torch.full_like(x, -0.0), x)
    x[0] = 0.0
    x[0, -1] = -0.0
    x[1] = 0.0
    x[2] = -0.0
    if d == 4:
        x[3] = torch.tensor([0.0, -0.0, 1.0, 2.0], device=dev)
        x[4] = torch.tensor([0.0, 0.0, -0.0, -0.0], device=dev)
        x[5] = torch.tensor([-0.0, 0.0, 1.0, 2.0], device=dev)
    return x


def _same_bits(a, b) -> bool:
    """f32 tensors equal as u32 patterns (-0.0 != +0.0)."""
    import torch

    return a.shape == b.shape and a.dtype == b.dtype == torch.float32 \
        and torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_quant(dev, g):
    """`quantize` against its plain version: codes exact, lo and step equal
    as u32 (so a -0.0 lo is held to its sign), the dequantized values
    within 1 ulp (and whether they were exact), on random rows, a constant
    row, and rows of signed zeros at d 4, an odd d (1001) and 4096. No
    path runs it, so its launches are those of this check's own loop."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels.quant import ops, ref

    err, deq_exact = 0.0, True
    _lib.reset_launch_counts()
    cases = QUANT_CASES + [((4, 32), "constant")] + [
        ((rows, d), "zeros " + dt) for rows, d in ((6, 4), (7, 1001),
                                                   (4, D))
        for dt in ("float32", "bfloat16")]
    for shape, dt in cases:
        if dt == "constant":
            x = torch.full(shape, 1.5, device=dev)
            x[1] = -3.0
        elif dt.startswith("zeros"):
            x = _signed_zero_rows(dev, g, *shape).to(getattr(torch,
                                                             dt[6:]))
        else:
            x = torch.randn(shape, generator=g, device=dev).to(
                getattr(torch, dt))
        for bits in (2, 4, 8):
            a, b = ops.quantize(x, bits), ref.quantize(x, bits)
            torch.cuda.synchronize()
            if a[0].dtype != b[0].dtype or not torch.equal(a[0], b[0]):
                fail(f"quantize codes: kernel != plain at {shape} {dt} "
                     f"bits={bits}")
            for name, u, w in (("lo", a[2], b[2]), ("step", a[3], b[3])):
                if not _same_bits(u, w):
                    fail(f"quantize {name}: kernel != plain as u32 at "
                         f"{shape} {dt} bits={bits}")
            if a[1].dtype != x.dtype or not _tol_ok(a[1], b[1]):
                fail(f"quantize deq beyond 1 ulp at {shape} {dt} "
                     f"bits={bits}")
            if torch.isnan(a[1]).any():
                fail(f"quantize gave NaN at {shape} {dt}")
            deq_exact = deq_exact and torch.equal(a[1], b[1])
            err = max(err, *(max_diff(u, w) for u, w in zip(a, b)))
    launches = _lib.launch_counts()["quantize"]
    print(f"quantize: {len(cases) * 3} cases, codes exact, lo and step "
          f"equal as u32 (signed-zero rows included), dequantized values "
          f"{'exact' if deq_exact else 'within 1 ulp, not all exact'}")
    x = torch.randn((TRAIN_ROWS, D), generator=g, device=dev).to(
        torch.bfloat16)
    ms = time_ms(lambda: ops.quantize(x, 4))
    plain = time_ms(lambda: ref.quantize(x, 4), iters=50)
    b = quant_bound(TRAIN_ROWS, D, 2)
    return dict(name="quantize", route="cuda",
                source="src/repro_torch/csrc/quantize.cu",
                replaces="src/repro/kernels/quant/kernel.py:34",
                launches=launches,
                launches_from="this check's own loop: no path runs it",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=None,
                library_call="none: no single PyTorch call gives per-row "
                             "min/max codes, dequantized values and "
                             "headers (torch.quantize_per_channel takes "
                             "the scales as inputs and rounds to nearest)")


def quant_bound(rows, d, x_bytes):
    """`quantize`'s bound: x read; u8 codes, values in x's dtype, f32 lo
    and step written; min, max, subtract, divide, floor, two clamps, add,
    multiply, add per element."""
    return bound_ms(rows * (d * (x_bytes + 1 + x_bytes) + 8), 10 * rows * d)


def _visible_pairs(S: int, causal: bool, window: int) -> int:
    """(q, k) pairs the mask leaves visible, per batch row and head: keys
    up to the query (causal) or all, from the window's start."""
    n = 0
    for i in range(S):
        hi = i if causal else S - 1
        lo = max(0, i - window + 1) if window else 0
        n += hi - lo + 1
    return n


FLASH_F32 = [dict(B=2, S=128, Hq=4, Hkv=2, hd=64, causal=True, window=0),
             dict(B=1, S=256, Hq=8, Hkv=8, hd=32, causal=True, window=0),
             dict(B=2, S=128, Hq=4, Hkv=1, hd=64, causal=False, window=0),
             dict(B=1, S=256, Hq=4, Hkv=2, hd=64, causal=True, window=64)]
YI = dict(Hq=32, Hkv=4, hd=128)        # yi-6b attention at full width
FLASH_SHORT = dict(B=2, S=32, Hq=4, Hkv=2, hd=64, causal=True, window=0)
FLASH_BF16 = [dict(B=4, S=256, causal=True, window=0, **YI),   # training
              dict(B=1, S=4096, causal=True, window=0, **YI),
              dict(B=1, S=4096, causal=True, window=1024, **YI)]


def _flash_inputs(g, dev, c, dtype):
    import torch

    shapes = [(c["B"], c["S"], h, c["hd"]) for h in (c["Hq"], c["Hkv"],
                                                      c["Hkv"])]
    return [torch.randn(sh, generator=g, device=dev).to(dtype)
            for sh in shapes]


def _sdpa_call(q, k, v, c):
    """The library yardstick: one `scaled_dot_product_attention` call on
    (B, H, S, hd) views, grouped heads by `enable_gqa` where this PyTorch
    has it, else K and V repeated beforehand (outside the timed call)."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    S = q.shape[1]
    mask = None
    if c["window"]:
        pos = torch.arange(S, device=q.device)
        mask = (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - c["window"])
    kw = dict(attn_mask=mask, is_causal=c["causal"] and mask is None)
    try:
        F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)
        return (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **kw)), "enable_gqa=True"
    except TypeError:
        rep = q.shape[2] // k.shape[2]
        kr, vr = (t.repeat_interleave(rep, dim=1) for t in (kt, vt))
        return (lambda: F.scaled_dot_product_attention(qt, kr, vr, **kw)), \
            "K and V repeated per q head"


def check_flash(dev, g):
    """Both flash kernels against their plain version: the f32 (SIMT)
    kernel at the reference tests' four configurations (atol 3e-5); the
    bf16 (tensor-core) kernel at the same four, at S 32 (below its 128-row
    tile, the ragged edge) and at yi-6b's full width (atol 3e-2); then
    project_qkv + the f32 kernel + wo against the model's attention at
    yi-6b full width (atol/rtol 3e-4). No path runs them, so their launches
    are those of this check's own loop. Times at each bf16 shape: kernel
    (wrapper, CUDA events, and its own device time per launch from a
    profiler trace, with the TFLOP/s on the visible pairs), plain version
    and one `scaled_dot_product_attention` call; the f32 kernel's at
    yi-6b's training shape in f32. Returns the two kernels' records."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flashattn import ops, ref
    from repro_torch.models import attention as A
    from repro_torch.models.config import Runtime

    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    _lib.reset_launch_counts()
    for c, dt, atol in ([(c, torch.float32, 3e-5) for c in FLASH_F32]
                        + [(c, torch.bfloat16, 3e-2)
                           for c in FLASH_F32 + [FLASH_SHORT] + FLASH_BF16]):
        q, k, v = _flash_inputs(g, dev, c, dt)
        kw = dict(causal=c["causal"], window=c["window"])
        bt = min(64, c["S"])
        a = ops.flash_attention(q, k, v, bq=bt, bk=bt, **kw)
        b = ref.attention(q, k, v, **kw)
        torch.cuda.synchronize()
        e = max_diff(a.float(), b.float())
        if a.dtype != dt or a.shape != q.shape or not e <= atol:
            fail(f"flash kernel != plain at {c} {dt}: max |diff| {e}")
        err[dt] = max(err[dt], e)
        print(f"  flash {dt} {c}: max |kernel - plain| {e} (atol {atol})")
        del b
    # against the model: yi-6b full width, one layer, B 2, S 256, f32
    cfg = configs.get("yi-6b").with_(n_layers=1, param_dtype="float32",
                                     dtype="float32")
    p = {n: w[0] for n, w in A.init_attention(
        torch.Generator(device=dev).manual_seed(5), cfg, 1,
        device=dev).items() if n != "norm"}
    x = torch.randn((2, 256, cfg.d_model), generator=g, device=dev)
    y_model = A.full_attention(p, cfg, Runtime(), x)
    q, k, v = A.project_qkv(p, cfg, x, torch.arange(256, device=dev)[None])
    y_flash = ops.flash_attention(q, k, v).reshape(2, 256, -1) @ p["wo"]
    torch.cuda.synchronize()
    tol = 3e-4 + 3e-4 * y_model.abs()
    if not bool(((y_flash - y_model).abs() <= tol).all()):
        fail(f"flash + project_qkv != full_attention at yi-6b width: max "
             f"|diff| {max_diff(y_flash, y_model)}")
    print(f"  flash + project_qkv vs full_attention, yi-6b width, B 2, "
          f"S 256, f32: max |diff| {max_diff(y_flash, y_model)} "
          f"(atol/rtol 3e-4)")
    launches = _lib.launch_counts()
    recs = {}
    for c, dt in [(c, torch.bfloat16) for c in FLASH_BF16] + \
            [(FLASH_BF16[0], torch.float32)]:
        q, k, v = _flash_inputs(g, dev, c, dt)
        kw = dict(causal=c["causal"], window=c["window"])
        big = c["S"] > 1024
        ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw),
                     iters=3 if big else 50, reps=3)
        plain = time_ms(lambda: ref.attention(q, k, v, **kw),
                        iters=1 if big else 10, reps=3)
        lib_fn, how = _sdpa_call(q, k, v, c)
        lib = time_ms(lib_fn, iters=10 if big else 100, reps=3)
        pairs = _visible_pairs(c["S"], c["causal"], c["window"])
        n = c["B"] * c["S"] * (c["Hq"] * 2 + c["Hkv"] * 2) * c["hd"]
        flops = 4 * c["B"] * c["Hq"] * c["hd"] * pairs
        bf16 = dt == torch.bfloat16
        peak = BF16_TENSOR_OPS_PER_S if bf16 else FP32_OPS_PER_S
        b = bound_ms(n * (2 if bf16 else 4), flops, peak)
        dev_ms, names = device_ms(
            lambda: ops.flash_attention(q, k, v, **kw), "flash",
            n=3 if big else 20)
        tflops = flops / (dev_ms * 1e-3) / 1e12 if dev_ms else None
        print(f"  flash {dt} B {c['B']} S {c['S']} window {c['window']}: "
              f"kernel {ms} ms (CUDA events, wrapper), device {dev_ms} ms "
              f"per launch {names} = {tflops} TFLOP/s, wrapper "
              f"{flops / (ms * 1e-3) / 1e12} TFLOP/s; plain {plain} ms, "
              f"sdpa ({how}) {lib} ms; bound {b[0]} ms ({b[1]}, "
              f"{'bf16 tensor' if bf16 else 'f32'} peak, {flops} "
              f"visible-pair FLOP)")
        name = "flash_attention" if bf16 else "flash_attention_simt"
        if name not in recs:            # the training shape goes in the line
            recs[name] = dict(
                name=name, route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flashattn/kernel.py:67",
                launches=launches[name],
                launches_from="this check's own loop: no path runs it",
                max_abs_err=err[dt], ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=lib, device_ms=dev_ms,
                library_call="torch.nn.functional.scaled_dot_product_"
                             f"attention ({how}), B 4 S 256 causal {dt} "
                             "at yi-6b width, as the other times")
        del q, k, v
        torch.cuda.empty_cache()
    return [recs["flash_attention"], recs["flash_attention_simt"]]


# ---------------------------------------------------------------------------
# codec probes: where the serving codec's time goes, kernel by kernel
# ---------------------------------------------------------------------------

CODEC_TOKENS = 300              # client_encode_device calls timed per kind


def codec_token_ms(dev, g, names=("randtopk", "quant", "randtopk_mask")):
    """The serving client's whole codec per token: host clock around
    `client_encode_device` + `sections_to_bytes` (its `.cpu()` pulls
    synchronize) at one row of yi-6b's cut (1 x 1 x 4096 bf16, k 64,
    4-bit quant), median over CODEC_TOKENS calls after a warm-up; with the
    kernel launches one call makes."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels.encode import ops as enc_ops
    from repro_torch.models.config import SplitConfig
    from repro_torch.split import protocol

    out = {}
    x = torch.randn((1, 1, D), generator=g, device=dev).to(torch.bfloat16)
    for name in names:
        comp = protocol.make_cut_compressor(SplitConfig(
            cut_layer=1, compressor=name, k=K))

        def token():
            p, sections = protocol.client_encode_device(comp, x)
            return enc_ops.sections_to_bytes(p.meta, p.batch_shape, sections)

        for _ in range(20):
            token()
        _lib.reset_launch_counts()
        token()
        per_call = {n: c for n, c in _lib.launch_counts().items() if c}
        times = []
        for _ in range(CODEC_TOKENS):
            t0 = time.perf_counter()
            token()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = dict(ms=statistics.median(times), launches=per_call)
        print(f"  codec per token, {name}: client_encode_device + "
              f"sections_to_bytes {out[name]['ms']} ms (host clock, median "
              f"of {CODEC_TOKENS}, ends in the .cpu() pull); launches per "
              f"token {per_call}")
    return out


def probe_kernels(dev, g):
    """Host/device split of the codec's kernels at the shapes the paths
    give them (wrapper ms by CUDA events, device ms per launch from a
    profiler trace, host us per call with its allocation and bare launch):
    the standalone top-k, pack_bits, encode_rows and randtopk_mask,
    scatter_rows beside a fresh `zeros.scatter_add`, and the serve's
    flush decode and quantize (`probe_slots_quant`)."""
    import torch
    from repro_torch.core import selection
    from repro_torch.kernels import _lib
    from repro_torch.kernels.encode import ops as enc_ops
    from repro_torch.kernels.randtopk import ops as tk_ops
    from repro_torch.kernels.randtopk import ref as tk_ref

    out = {}
    rows_eval, _, d_tab, k_tab = _tabular_eval_shape()
    print("topk_mask_threshold, host/device split:")
    for label, rows, d, dt, k in (
            ("serving 1 x 4096 bf16 k 64", 1, D, torch.bfloat16, K),
            ("tabular 128 x 128 f32 k 3", 128, d_tab, torch.float32, k_tab),
            (f"tabular evaluation {rows_eval} x {d_tab} f32 k {k_tab}",
             rows_eval, d_tab, torch.float32, k_tab),
            ("1024 x 4096 bf16 k 64", TRAIN_ROWS, D, torch.bfloat16, K)):
        x = torch.randn((rows, d), generator=g, device=dev).to(dt)
        mask = torch.empty((rows, d), dtype=torch.bool, device=dev)
        thr = torch.empty((rows,), dtype=torch.float32, device=dev)
        args = (x.data_ptr(), int(dt == torch.bfloat16), rows, d, k,
                mask.data_ptr(), thr.data_ptr(), _lib.stream_handle(x))
        out["topk " + label] = split_probe(
            label, lambda: tk_ops.topk_mask_threshold(x, k),
            "topk_select_kernel",
            lambda: (torch.empty((rows, d), dtype=torch.bool, device=dev),
                     torch.empty((rows,), dtype=torch.float32,
                                 device=dev)),
            lambda: _lib.launch("topk_mask_threshold", *args),
            bound_ms(rows * (d * x.element_size() + d + 4), 5 * rows * d))
    print("pack_bits, host/device split:")
    for label, n, width in (
            ("serving 64 x 12-bit indices", K, W_IDX),
            ("fedtrain 128 x 3 x 7-bit indices", 128 * k_tab, 7)):
        idx = torch.randint(0, 1 << width, (n,), generator=g, device=dev,
                            dtype=torch.int32)
        n_words = (n + 31) // 32 * width
        words = torch.empty((n_words,), dtype=torch.int32, device=dev)
        args = (idx.data_ptr(), n, width, words.data_ptr(),
                _lib.stream_handle(idx))
        out["pack_bits " + label] = split_probe(
            label, lambda: enc_ops.pack_bits(idx, width), "pack_bits_kernel",
            lambda: torch.empty((n_words,), dtype=torch.int32, device=dev),
            lambda: _lib.launch("pack_bits", *args),
            bound_ms(n * 4 + n_words * 4, n * 4))
    print("encode_rows (sparse, mask given), host/device split (no "
          "library call computes the same function):")
    for label, rows, d, dt, k in (
            ("serving 1 x 4096 bf16 k 64", 1, D, torch.bfloat16, K),
            ("fedtrain 128 x 128 f32 k 3", 128, d_tab, torch.float32,
             k_tab)):
        x = torch.randn((rows, d), generator=g, device=dev).to(dt)
        mask = tk_ref.topk_mask_threshold(x, k)[0]
        plan = enc_ops.encode_plan("sparse", x.shape, x.dtype, k, 0)
        p0 = enc_ops.launch_encode(plan, x, mask)
        args = (x.data_ptr(), plan.x_bf16, mask.data_ptr(), rows, d,
                plan.kind_id, k, 0, p0.values.data_ptr(),
                p0.indices.data_ptr(), 0, _lib.stream_handle(x))
        out["encode_rows " + label] = split_probe(
            label, lambda: enc_ops.encode_rows(x, "sparse", k=k, mask=mask),
            "encode_rows",
            lambda: [x.new_empty(s, dtype=t) for s, t in plan.leaves],
            lambda: _lib.launch("encode_rows", *args),
            bound_ms(rows * (d * x.element_size() + d + k * 8),
                     2 * rows * d))
    print("randtopk_mask, host/device split (no library call draws an "
          "Eq. 7 mask):")
    for label, rows, d, dt, k in (
            ("training cut 1024 x 4096 bf16 k 64", TRAIN_ROWS, D,
             torch.bfloat16, K),
            ("tabular 128 x 128 f32 k 3", 128, d_tab, torch.float32,
             k_tab)):
        x = torch.randn((rows, d), generator=g, device=dev).to(dt)
        gum = selection.gumbel_noise(g, x.shape, device=dev)
        m = selection.binomial_nontop_count(g, 0.1, k, d, (rows,),
                                            device=dev)
        m32 = m.to(torch.int32).contiguous()
        mask = torch.empty((rows, d), dtype=torch.bool, device=dev)
        args = (x.data_ptr(), int(dt == torch.bfloat16), gum.data_ptr(),
                m32.data_ptr(), rows, d, k, mask.data_ptr(),
                _lib.stream_handle(x))
        out["randtopk_mask " + label] = split_probe(
            label, lambda: tk_ops.randtopk_mask(x, gum, m, k),
            "randtopk_mask_kernel",
            lambda: torch.empty((rows, d), dtype=torch.bool, device=dev),
            lambda: _lib.launch("randtopk_mask", *args),
            bound_ms(rows * (d * x.element_size() + d * 4 + 4 + d),
                     15 * rows * d))
    out.update(probe_slots_quant(dev, g))
    print("scatter_rows beside a fresh zeros.scatter_add (1024 x 4096 bf16, "
          "k 64):")
    vals = torch.randn((TRAIN_ROWS, K), generator=g, device=dev).to(
        torch.bfloat16)
    idx = torch.sort(torch.randperm(D, generator=g, device=dev)[:K]).values
    idx = idx.expand(TRAIN_ROWS, K).to(torch.int32).contiguous()
    idx64 = idx.long()
    zeros = torch.zeros((TRAIN_ROWS, D), dtype=torch.bfloat16, device=dev)
    rec = dict(ms=time_ms(lambda: tk_ops.scatter_rows(vals, idx, D)),
               device_ms=device_ms(lambda: tk_ops.scatter_rows(vals, idx, D),
                                   "decode_rows_scatter_kernel")[0],
               fresh_ms=time_ms(lambda: zeros.scatter_add(-1, idx64, vals)),
               fresh_device_ms=device_ms(
                   lambda: zeros.scatter_add(-1, idx64, vals))[0])
    out["scatter_rows"] = rec
    print(f"  scatter_rows wrapper {rec['ms']} ms, device "
          f"{rec['device_ms']} ms; zeros.scatter_add(-1, idx, vals) "
          f"{rec['fresh_ms']} ms, device {rec['fresh_device_ms']} ms")
    return out


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def probe_slots_quant(dev, g):
    """The host/device split of `decode_to_slots` at each serve kind's
    4-row bf16 flush (d 4096, one pad row on the scratch slot; the serve's
    arena of N_CLIENTS slots) and of `quantize` at a training cut and a
    serving flush (bf16, 4 bits). Uses only the wrappers and the C
    launchers, so a parent tree's package can be probed the same way."""
    import torch
    from repro_torch.core.payload import KINDS
    from repro_torch.kernels import _lib
    from repro_torch.kernels.decode import ops as dec_ops
    from repro_torch.kernels.quant import ops as q_ops

    out = {}
    n, cap1 = 4, N_CLIENTS + 1
    print(f"decode_to_slots, host/device split ({n}-row flush of 4096 into "
          f"a ({cap1}, 1, 1, 4096) bf16 xbuf, one pad row on the scratch "
          f"slot; the wrapper allocates nothing):")
    slots = torch.tensor([0, 1, 2, cap1 - 1], dtype=torch.int32, device=dev)
    xbuf = torch.zeros((cap1, 1, 1, D), dtype=torch.bfloat16, device=dev)

    def flush(label, p):
        args = (xbuf.data_ptr(), 1, cap1, D, slots.data_ptr(), n,
                KINDS.index(p.meta.kind), p.meta.k, p.values.data_ptr(),
                0 if p.indices is None else p.indices.data_ptr(),
                0 if p.header is None else p.header.data_ptr(),
                _lib.stream_handle(xbuf))
        out["decode_to_slots " + label] = split_probe(
            label, lambda: dec_ops.decode_rows_to_slots(xbuf, p, slots),
            None, None, lambda: _lib.launch("decode_to_slots", *args),
            bound_ms(_nbytes(p.values, p.indices, p.header, slots)
                     + n * D * 2, n * D))

    for comp, kind, k, bits in SERVE_KINDS:
        flush(f"{comp} ({kind}) flush",
              _flush_payload(dev, g, kind, k, bits, n, D, n - 1))
    # a pad row's k zero values all sit at index 0; the same row with
    # nonzero values takes the scatter kernel's duplicate path (a second
    # barrier and k - 1 shared atomics on one address)
    p = _flush_payload(dev, g, "sparse", K, 0, n, D, n)
    p.indices[-1] = 0
    flush("randtopk (sparse) flush, last row k nonzero values at index 0",
          p)
    print("quantize, host/device split (no library call computes the same "
          "function):")
    for label, rows in (("training cut 1024 x 4096 bf16 4-bit", TRAIN_ROWS),
                        ("serving flush 4 x 4096 bf16 4-bit", N_CLIENTS)):
        x = torch.randn((rows, D), generator=g, device=dev).to(
            torch.bfloat16)
        code, deq, lo, step = q_ops.quantize(x, 4)
        args = (x.data_ptr(), 1, rows, D, 4, code.data_ptr(),
                deq.data_ptr(), lo.data_ptr(), step.data_ptr(),
                _lib.stream_handle(x))
        out["quantize " + label] = split_probe(
            label, lambda: q_ops.quantize(x, 4), None,
            lambda: (x.new_empty(x.shape, dtype=torch.uint8),
                     x.new_empty(x.shape),
                     x.new_empty((rows,), dtype=torch.float32),
                     x.new_empty((rows,), dtype=torch.float32)),
            lambda: _lib.launch("quantize", *args),
            quant_bound(rows, D, 2))
    return out


def probe_fused(dev, g):
    """The same host/device split for the fused client codec
    (`encode_sections`) at the serving row (select; quant) and the
    fedtrain batch (mask given)."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.kernels.encode import ops as enc_ops
    from repro_torch.kernels.randtopk import ref as tk_ref

    out = {}
    print("encode_sections (the fused client codec), host/device split:")
    for label, shape, dt, kind, k, bits, select in (
            ("serving randtopk 1 x 4096 bf16 k 64, select", (1, D),
             torch.bfloat16, "sparse", K, 0, True),
            ("serving quant 1 x 4096 bf16 4-bit", (1, D),
             torch.bfloat16, "quant", 0, 4, False),
            ("fedtrain randtopk 128 x 128 f32 k 3, mask given",
             (128, 128), torch.float32, "sparse", 3, 0, False)):
        x = torch.randn(shape, generator=g, device=dev).to(dt)
        mask = None if select or not k else \
            tk_ref.topk_mask_threshold(x, k)[0]
        plan = enc_ops.sections_plan(kind, x.shape, x.dtype, k, bits,
                                     select)
        bufs = enc_ops.sections_alloc(plan, x)
        args = enc_ops.sections_args(
            plan, x, 0 if mask is None else mask.data_ptr(), bufs)
        out["encode_sections " + label] = split_probe(
            label, lambda: enc_ops.encode_sections(
                x, kind, k=k, bits=bits, mask=mask, select=select),
            "encode_rows",
            lambda: enc_ops.sections_alloc(plan, x),
            lambda: _lib.launch("encode_sections", *args),
            sections_bound(shape[1], x.element_size(), kind, k, bits,
                           rows=shape[0], masked=mask is not None))
    return out


# ---------------------------------------------------------------------------
# phases 3-6: the serving path
# ---------------------------------------------------------------------------

# every served token's codec is one launch of the fused encode
PATH_KERNELS = {
    "randtopk": ("encode_sections", "decode_to_slots"),
    "identity": ("encode_sections", "decode_to_slots"),
    "quant": ("encode_sections", "decode_to_slots"),
    "randtopk_mask": ("encode_sections", "decode_to_slots"),
}
# what the fused encode does in its launch: none of these may run
NOT_ON_SERVING_PATH = ("topk_mask_threshold", "encode_rows", "pack_bits")


def _warm_decodes(max_batch, n_specs):
    """The server's warm-up flush decodes: per spec, two for each flush
    bucket (powers of two up to max_batch, and max_batch): its decode,
    then its fused step's."""
    buckets = {1 << i for i in range(max_batch.bit_length())} | {max_batch}
    return 2 * len(buckets) * n_specs


def _one_launch_per_token(res, counts, compressor):
    """The serve's counts show the fused encode once per client token (and
    once per compressor for the engine's warm-up step) and none of the
    kernels it replaced, and the flush decode once per flush (and twice
    per flush bucket in the server's warm-up: its decode, then its fused
    step's)."""
    frames = sum(s["frames_up"] for s in res["client_stats"])
    n_comps = len(set(res["compressor_objs"]))
    want = frames + n_comps
    if counts["encode_sections"] != want:
        fail(f"{compressor}: {counts['encode_sections']} fused encode "
             f"launches for {frames} client tokens and a warm-up step")
    extra = {n: counts[n] for n in NOT_ON_SERVING_PATH if counts[n]}
    if extra:
        fail(f"{compressor}: the serving codec launched {extra}")
    warm = _warm_decodes(res["max_batch"], n_comps)
    if counts["decode_to_slots"] != res["flushes"] + warm:
        fail(f"{compressor}: {counts['decode_to_slots']} flush decodes for "
             f"{res['flushes']} flushes and {warm} warm-up decodes")


def serve(cfg, params, compressor, *, gen, backend=None, trace=False,
          n_clients=N_CLIENTS, prompt_len=PROMPT_LEN):
    """One closed-loop run of `n_clients` sessions of `prompt_len` + `gen`
    tokens, the cut at n_layers // 2; returns (result, launch counts of
    the run, analytic payload bytes per token). With `trace` the
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
        scfg, n_clients=n_clients, prompt_len=prompt_len, gen=gen,
        params=params, device="cuda"), enabled=trace)
    res.update(device_ms=dev_ms, call_ms=call_ms)
    counts = _lib.launch_counts()
    if protocol.HOST_DENSIFY_COUNT.value != densify0:
        fail(f"{compressor}: host densification on the serving path")
    toks = res["tokens"]
    if toks.shape != (n_clients, gen) or toks.min() < 0 \
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
    _one_launch_per_token(res, counts, "randtopk")
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
        _one_launch_per_token(r, c, comp)
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
               cut=TRAIN_CUT, smoke=False, k=K, arch="yi-6b"):
    from repro_torch.launch import train as train_cli

    return train_cli.build(arch, smoke=smoke, layers=layers,
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


def _same_first_step(params, m, p_plain, m_plain,
                     what="kernels vs plain versions"):
    """The first training step with the kernels against the same step with
    the plain versions (or two runs of one, as `what` says): the backward
    runs `scatter_rows` on the wire gradient, so the gradient norm, the
    balance loss and every updated parameter (the layers below the cut and
    the embedding included) must be bit-identical."""
    import torch
    from repro_torch.optim.adamw import tree_leaves

    for key in ("loss", "aux", "grad_norm"):
        if not torch.equal(m[key], m_plain[key]):
            fail(f"first step {key} {float(m[key])} != "
                 f"{float(m_plain[key])} ({what})")
    names = _leaf_names(params)
    off = [(n, float((a.float() - b.float()).abs().max()))
           for n, a, b in zip(names, tree_leaves(params),
                              tree_leaves(p_plain)) if not torch.equal(a, b)]
    if off:
        fail(f"first step updated parameters differ ({what}; leaf, max "
             f"|diff|): {off}")
    print(f"first step, {what}: identical loss ({float(m['loss'])}), aux "
          f"({float(m['aux'])}), grad norm ({float(m['grad_norm'])}) and "
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
        # decode_rows (forward) and scatter_rows (backward) both launch
        # decode_rows_scatter_kernel: two launches a step under one name
        ours = {n: (sum(ms for k, ms, _ in kernels if n in k) / 3,
                    sum(c for k, _, c in kernels if n in k) / 3)
                for n in ("randtopk_mask_kernel",
                          "decode_rows_scatter_kernel")}
        print(f"  the codec kernels per step, (device ms, launches): {ours} "
              f"(decode_rows_scatter_kernel runs decode_rows and "
              f"scatter_rows)")

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
    epoch with randtopk, kernels against the plain versions on the card.
    Returns the kernel run's launch counts."""
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
    if not kern["launches"]["topk_mask_threshold"]:
        fail("tabular randtopk never launched its evaluation's top-k")
    print(f"tabular randtopk (in 64, hidden 256, cut 128, 100 classes, "
          f"k={kern['k']}, batch 128, 1 epoch = {kern['steps']} steps): "
          f"final loss {kern['final_loss']} and every trained tensor "
          f"identical to the plain versions' run; test acc "
          f"{kern['test_acc']} (both runs); train bytes "
          f"{kern['train_bytes_measured']:.0f} measured, "
          f"{kern['train_bytes']:.0f} Table 2; wall {kern['wall_s']:.2f} s "
          f"kernels, {plain['wall_s']:.2f} s plain; launches "
          f"{kern['launches']}")
    return kern["launches"]


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


CKPT_ARCH, CKPT_LAYERS, CKPT_CUT = "granite-moe-1b-a400m", 2, 1
CKPT_STOP, CKPT_STEPS = 3, 6


def _du(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def train_ckpt_phase(dev):
    """`launch.train.main` with `--ckpt-dir`: granite-moe-1b-a400m at full
    width (d 1024, 32 experts, top-8), depth cut from 24 to 2 layers (the
    cut at 1), batch 4 x seq 256, randtopk k 64: 3 steps with a checkpoint
    every 3, then resumed to 6, equal 6 uninterrupted steps bit for bit
    (printed losses and final params). The checkpoints go to a temporary
    directory, removed afterwards; `store.save` and `store.restore` are
    timed where `main` calls them."""
    import contextlib
    import io
    import re
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint import store
    from repro_torch.kernels import _lib
    from repro_torch.launch import train as train_cli
    from repro_torch.optim.adamw import tree_leaves

    timed = {"save": [], "restore": []}
    orig = {k: getattr(store, k) for k in timed}

    def timing(name):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = orig[name](*a, **kw)
            timed[name].append(time.perf_counter() - t0)
            return out
        return call

    def run(steps, ckpt=None):
        argv = ["--arch", CKPT_ARCH, "--layers", str(CKPT_LAYERS), "--cut",
                str(CKPT_CUT), "--batch", str(TRAIN_BATCH), "--seq",
                str(TRAIN_SEQ), "--split", "randtopk", "--k", str(K),
                "--steps", str(steps), "--log-every", "1"]
        if ckpt:
            argv += ["--ckpt-dir", ckpt, "--ckpt-every", str(CKPT_STOP)]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            params = train_cli.main(argv)
        torch.cuda.synchronize()
        out = buf.getvalue()
        return params, out, re.findall(r"step +(\d+) (loss=\S+ ce=\S+ "
                                       r"aux=\S+ gnorm=\S+)", out)

    full, out, want = run(CKPT_STEPS)
    print(out.splitlines()[0])
    ckpt = tempfile.mkdtemp(prefix="train_ckpt_")
    try:
        for k in timed:
            setattr(store, k, timing(k))
        _, _, first = run(CKPT_STOP, ckpt)
        nbytes = _du(ckpt)
        _lib.reset_launch_counts()
        resumed, out_b, second = run(CKPT_STEPS, ckpt)
        counts = _lib.launch_counts()
    finally:
        for k, f in orig.items():
            setattr(store, k, f)
        shutil.rmtree(ckpt, ignore_errors=True)
    if f"restored step {CKPT_STOP}" not in out_b:
        fail(f"launch.train did not resume from step {CKPT_STOP}")
    if first + second != want or len(want) != CKPT_STEPS:
        fail(f"launch.train stopped at {CKPT_STOP} and resumed: "
             f"{first + second}, uninterrupted: {want}")
    off = [i for i, (a, b) in enumerate(zip(tree_leaves(resumed),
                                            tree_leaves(full)))
           if not torch.equal(a, b)]
    if off:
        fail(f"launch.train resumed params differ in leaves {off}")
    if counts["randtopk_mask"] != CKPT_STEPS - CKPT_STOP:
        fail(f"launch.train resumed run: launches {counts}")
    print(f"launch.train {CKPT_ARCH} ({CKPT_LAYERS} of 24 layers, full "
          f"width), batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, randtopk k {K}: "
          f"stopped at step {CKPT_STOP} with --ckpt-every {CKPT_STOP} and "
          f"resumed to {CKPT_STEPS} = {CKPT_STEPS} uninterrupted steps, bit "
          f"for bit (losses {[w[1] for w in want]}, every final param); "
          f"the resumed run's launches {counts}")
    print(f"launch.train checkpoint at step {CKPT_STOP} (params, opt, rng): "
          f"{nbytes} B on disk; store.save {['%.3f' % t for t in timed['save']]}"
          f" s (3 files a checkpoint, 2 checkpoints), store.restore "
          f"{['%.3f' % t for t in timed['restore']]} s (params, opt, rng)")
    return counts


# the codec kernels of a fedtrain step: up, the Eq. (7) mask and the
# fused encode (gather and bit-pack in one launch); at the label owner the
# decode; down, for sparse kinds, the scatter onto the support
FED_KERNELS = {"randtopk": ("randtopk_mask", "encode_sections",
                            "decode_rows", "scatter_rows"),
               "randtopk_mask": ("randtopk_mask", "encode_sections",
                                 "decode_rows")}
FED_EPOCHS_N4, FED_CKPT_EVERY, FED_STOP = 2, 20, 40
# the reference tests' fault plans and ARQ settings (`tests/test_faults.py`)
CHAOS_PLAN = dict(corrupt=0.06, truncate=0.03, drop=0.05, duplicate=0.05,
                  reorder=0.03, rechunk=0.15, max_faults=30)
ARQ = dict(retry_timeout=0.3, max_retries=40)
HEAVY_PLAN = dict(corrupt=0.25, truncate=0.08, drop=0.1, duplicate=0.1,
                  reorder=0.05, rechunk=0.2, max_faults=60)
HEAVY_ARQ = dict(retry_timeout=0.2, max_retries=60)


def _fed_bytes_ok(res, what):
    for direction in ("up", "down"):
        got = res[f"payload_bytes_{direction}"]
        want = res[f"analytic_bytes_{direction}"]
        if not abs(got - want) <= 0.05 * want:
            fail(f"fedtrain {what}: {got} B {direction} measured, {want} "
                 f"analytic")


def _fed_same(a, b, what):
    """Two fedtrain results: the same losses from step `b`'s first on,
    bytes, final k and final weights, bit for bit."""
    import torch

    start = b["losses"][0][0][0] if b["losses"][0] else 0
    for cid in range(a["n_clients"]):
        if b["losses"][cid] != [x for x in a["losses"][cid]
                                if x[0] >= start]:
            fail(f"fedtrain {what}: client {cid} losses differ")
    for key in ("payload_bytes_up", "payload_bytes_down", "header_bytes",
                "final_k"):
        if a[key] != b[key]:
            fail(f"fedtrain {what}: {key} {a[key]} vs {b[key]}")
    off = [n for x, y in zip(a["bottoms"] + [a["top"]],
                             b["bottoms"] + [b["top"]])
           for n in x if not torch.equal(x[n], y[n])]
    if off:
        fail(f"fedtrain {what}: final weights differ in {off}")


def _reg(res, name, **labels):
    """One series of a run's `metrics` snapshot: a counter's value, a
    histogram's sample count."""
    for s in res["metrics"][name]["series"]:
        if s["labels"] == labels:
            return s.get("value", s.get("count"))
    fail(f"no {name}{labels} series in the run's registry")


def _fed_registry_bytes(res, clean, what):
    """The registry's byte counters against the result's byte accounting.
    The client counts a step's frame once in its registry and every
    retransmission in its `SessionStats`; the server counts each frame it
    accepted in both."""
    cs, ss = res["client_stats"], res["server_stats"]
    checks = {
        "client payload up (registry) = clean payload_bytes_up":
            (_reg(res, "payload_bytes_total", party="client",
                  direction="up"), clean["payload_bytes_up"]),
        "server payload up (registry) = server stats":
            (_reg(res, "payload_bytes_total", party="server",
                  direction="up"), sum(s["payload_bytes_up"] for s in ss)),
        "server wire down (registry) = server stats":
            (_reg(res, "wire_bytes_total", party="server",
                  direction="down"), sum(s["bytes_down"] for s in ss)),
    }
    if res is clean:
        checks["client wire down (registry) = payload_bytes_down + "
               "framing"] = (
            _reg(res, "wire_bytes_total", party="client", direction="down"),
            res["payload_bytes_down"]
            + sum(s["header_bytes_down"] for s in cs))
    off = {k: v for k, v in checks.items() if v[0] != v[1]}
    if off:
        fail(f"fedtrain {what}: registry bytes disagree: {off}")
    print(f"fedtrain {what}: registry bytes agree: " + "; ".join(
        f"{k} ({a})" for k, (a, _) in checks.items()))


def fedtrain_chaos(spec, ds, clean, clean_counts, spec4, kw4, full):
    """Fedtrain under seeded chaos on the card, with the kernels already
    built (their first launch would spend the 0.3 s retransmit timer):
    (c) one randtopk client under `FaultPlan(seed=7)`, ARQ 0.3 s x 40, =
    the clean card run bit for bit, with the clean run's launches per
    logical step; (d) the heavy-corruption plan: reconnects and the clean
    losses; (e) four randtopk_mask clients under chaos complete every
    sync step, one Eq. (7) mask and one fused encode per logical step;
    (f) a traced clean run: the median host ms of the spans. Returns the
    launch counts of the three chaos runs, summed."""
    import torch
    from repro_torch.fedtrain import run_fedtrain
    from repro_torch.kernels import _lib
    from repro_torch.obs import trace
    from repro_torch.testing import (DESTRUCTIVE_FAULTS, FaultInjector,
                                     FaultPlan)

    _fed_registry_bytes(clean, clean, "N=1 clean")
    total = {}
    base = dict(n_clients=1, epochs=1, batch=128, seed=0, device="cuda")
    for name, plan, arq in (
            ("N=1 chaos", dict(seed=7, **CHAOS_PLAN), ARQ),
            ("N=1 heavy chaos", dict(seed=3, **HEAVY_PLAN), HEAVY_ARQ)):
        inj = FaultInjector(FaultPlan(**plan))
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_fedtrain(spec, ds, wrap_endpoint=inj, **arq, **base)
        wall = time.perf_counter() - t0
        counts = _lib.launch_counts()
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
        fc, injected = res["fault_counters"], inj.injected()
        if not sum(injected[f] for f in DESTRUCTIVE_FAULTS):
            fail(f"fedtrain {name}: no destructive fault injected "
                 f"({dict(injected)})")
        if not fc["replays"] + fc["duplicates"] + fc["reconnects"]:
            fail(f"fedtrain {name}: no recovery ran ({fc})")
        if name == "N=1 heavy chaos" and not fc["reconnects"]:
            fail(f"fedtrain {name}: no reconnect ({fc})")
        if res["losses"] != clean["losses"]:
            fail(f"fedtrain {name}: losses differ from the clean card run")
        off = [n for x, y in zip(res["bottoms"] + [res["top"]],
                                 clean["bottoms"] + [clean["top"]])
               for n in x if not torch.equal(x[n], y[n])]
        if off or res["mean_test_acc"] != clean["mean_test_acc"]:
            fail(f"fedtrain {name}: final weights differ in {off} (test acc "
                 f"{res['mean_test_acc']} vs {clean['mean_test_acc']})")
        # a replay resends bytes and the server re-acks from its cache:
        # the clean run's launches, one mask and one encode a logical step
        steps = res["steps"]
        if counts != clean_counts or \
                not counts["randtopk_mask"] == counts["encode_sections"] \
                == steps:
            fail(f"fedtrain {name}: launches {counts} for {steps} logical "
                 f"steps; the clean run's {clean_counts}")
        if res["payload_bytes_up"] < clean["payload_bytes_up"] or \
                res["analytic_bytes_up"] != clean["analytic_bytes_up"]:
            fail(f"fedtrain {name}: bytes up {res['payload_bytes_up']} "
                 f"measured, {res['analytic_bytes_up']} analytic; clean "
                 f"{clean['payload_bytes_up']}, "
                 f"{clean['analytic_bytes_up']}")
        print(f"fedtrain {name} ({steps} steps, retry "
              f"{arq['retry_timeout']} s x {arq['max_retries']}): injected "
              f"{dict(injected)}; fault counters {fc}; losses, test acc "
              f"and final weights = the clean card run, bit for bit; "
              f"launches {counts} (= the clean run's); "
              f"{res['payload_bytes_up']} B up / "
              f"{res['payload_bytes_down']} B down measured (clean "
              f"{clean['payload_bytes_up']} / "
              f"{clean['payload_bytes_down']}); wall {wall:.3f} s "
              f"(clean {clean['wall_s']:.3f})")
        _fed_registry_bytes(res, clean, name)

    inj = FaultInjector(FaultPlan(seed=21, **CHAOS_PLAN))
    _lib.reset_launch_counts()
    res = run_fedtrain(spec4, ds, wrap_endpoint=inj, **ARQ, **kw4)
    counts = _lib.launch_counts()
    for n, c in counts.items():
        total[n] += c
    syncs = [[s for s, _ in x] for x in res["losses"]]
    n_sync = sum(map(len, syncs))
    if res["steps"] != full["steps"] or \
            syncs != [[s for s, _ in x] for x in full["losses"]]:
        fail(f"fedtrain N=4 chaos: {res['steps']} steps, sync steps "
             f"{[len(x) for x in syncs]} against the clean run's")
    if not counts["randtopk_mask"] == counts["encode_sections"] == n_sync:
        fail(f"fedtrain N=4 chaos: launches {counts} for {n_sync} sync "
             f"steps")
    print(f"fedtrain N=4 randtopk_mask chaos ({res['steps']} steps, "
          f"{n_sync} sync steps): completed every client's sync steps; "
          f"injected {dict(inj.injected())}; fault counters "
          f"{res['fault_counters']}; launches {counts}; mean test acc "
          f"{res['mean_test_acc']} (clean {full['mean_test_acc']}); wall "
          f"{res['wall_s']:.3f} s")
    _fed_registry_bytes(res, full, "N=4 chaos")

    tracer = trace.Tracer()
    res = run_fedtrain(spec, ds, tracer=tracer, **base)
    if res["losses"] != clean["losses"]:
        fail("fedtrain traced run: losses differ from the clean run")
    for span, n in ((trace.SPAN_CLIENT_ENCODE, res["steps"]),
                    (trace.SPAN_QUEUE_WAIT, res["steps"])):
        ms = [e["dur"] * 1e3 for e in tracer.events()
              if e["name"] == span]
        if len(ms) != n:
            fail(f"fedtrain traced run: {len(ms)} {span} spans for {n} "
                 f"steps")
        print(f"fedtrain N=1 traced: {span} x {n}, host ms median "
              f"{statistics.median(ms):.4f}, min {min(ms):.4f}, max "
              f"{max(ms):.4f}")
    print(f"fedtrain N=1 traced: queue_wait_ms count "
          f"{_reg(res, 'queue_wait_ms')} = frames up "
          f"{_reg(res, 'frames_total', party='server', direction='up')}")
    return total


def fedtrain_phase(dev):
    """Federated split training over the wire on the card, at the tabular
    phase's paper widths: (a) one client with randtopk against
    `tabular.train` on the card; (b) four clients with randtopk_mask, the
    adaptive schedule and 4 local steps, stopped at step 40 and resumed
    from a checkpoint, against the uninterrupted run; then the same
    under seeded chaos (`fedtrain_chaos`)."""
    import shutil
    import tempfile

    import torch
    from repro_torch.data.synthetic import ManyClassDataset
    from repro_torch.fedtrain import AsyncPolicy, ScheduleSpec, run_fedtrain
    from repro_torch.kernels import _lib
    from repro_torch.split import protocol, tabular

    ds = ManyClassDataset()
    spec = tabular.SplitSpec(method="randtopk")
    densify0 = protocol.HOST_DENSIFY_COUNT.value
    tab = tabular.train(spec, ds, epochs=1, batch=128, seed=0,
                        record_every=1, device="cuda")
    _lib.reset_launch_counts()
    fed = run_fedtrain(spec, ds, n_clients=1, epochs=1, batch=128, seed=0,
                       device="cuda")
    counts = _lib.launch_counts()
    tl = [t[2] for t in tab["trace"]]
    fl = [x for _, x in fed["losses"][0]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(fl, tl))
    if len(fl) != len(tl) or not rel <= 1e-5:
        fail(f"fedtrain N=1 losses differ from tabular.train (max rel "
             f"{rel})")
    off = [n for part, mine in (("bottom", fed["bottoms"][0]),
                                ("top", fed["top"]))
           for n in mine if not torch.equal(mine[n], tab[part][n])]
    if off:
        fail(f"fedtrain N=1 final weights differ from tabular.train: {off}")
    _fed_bytes_ok(fed, "N=1")
    missing = [n for n in FED_KERNELS["randtopk"] if not counts[n]]
    if missing:
        fail(f"fedtrain N=1 randtopk path never launched {missing}")
    # two codec launches a client step: the Eq. (7) mask and the encode
    if not counts["randtopk_mask"] == counts["encode_sections"] == \
            fed["steps"] or counts["pack_bits"] or counts["encode_rows"]:
        fail(f"fedtrain N=1: launches {counts} for {fed['steps']} steps")
    print(f"fedtrain N=1 randtopk ({fed['steps']} steps, batch 128): losses "
          f"equal tabular.train's on the card (max rel diff {rel}), final "
          f"weights identical; {fed['payload_bytes_up']} B up / "
          f"{fed['payload_bytes_down']} B down measured vs "
          f"{fed['analytic_bytes_up']:.0f} / "
          f"{fed['analytic_bytes_down']:.0f} analytic; wall "
          f"{fed['wall_s']:.3f} s, {fed['steps'] / fed['wall_s']:.1f} "
          f"steps/s; launches {counts}")
    _, dev_ms, wall_ms, _ = traced(lambda: run_fedtrain(
        spec, ds, n_clients=1, epochs=1, batch=128, seed=0, device="cuda"))
    if dev_ms is None:
        print("fedtrain N=1 busy share: not measured (no device time)")
    else:
        print(f"fedtrain N=1 under torch.profiler: device {dev_ms} ms of "
              f"{wall_ms} ms wall, card busy {dev_ms / wall_ms * 100:.2f}%")

    spec4 = tabular.SplitSpec(method="randtopk_mask")
    kw = dict(n_clients=4, epochs=FED_EPOCHS_N4, batch=128, seed=0,
              schedule=ScheduleSpec(k=spec4.k, d=spec4.cut_dim,
                                    anneal_steps=8,
                                    k0=min(spec4.cut_dim, 2 * spec4.k),
                                    k_min=max(1, spec4.k // 2)),
              policy=AsyncPolicy(local_steps=4, warmup_sync=8),
              max_wait=5.0, device="cuda")
    _lib.reset_launch_counts()
    full = run_fedtrain(spec4, ds, **kw)
    counts4 = _lib.launch_counts()
    _fed_bytes_ok(full, "N=4")
    missing = [n for n in FED_KERNELS["randtopk_mask"] if not counts4[n]]
    if missing:
        fail(f"fedtrain N=4 randtopk_mask path never launched {missing}")
    ckpt = tempfile.mkdtemp(prefix="fedtrain_ckpt_")
    try:
        killed = run_fedtrain(spec4, ds, ckpt_dir=ckpt,
                              ckpt_every=FED_CKPT_EVERY,
                              stop_after_steps=FED_STOP, **kw)
        resumed = run_fedtrain(spec4, ds, ckpt_dir=ckpt,
                               ckpt_every=FED_CKPT_EVERY, **kw)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if killed["steps"] != FED_STOP or \
            resumed["losses"][0][0][0] != FED_STOP:
        fail(f"fedtrain N=4: killed at {killed['steps']}, resumed at "
             f"{resumed['losses'][0][:1]}")
    _fed_same(full, resumed, "N=4 resumed vs uninterrupted")
    syncs = [len(x) for x in full["losses"]]
    print(f"fedtrain N=4 randtopk_mask, adaptive schedule, 4 local steps "
          f"({full['steps']} steps, {syncs} sync steps, final k "
          f"{full['final_k']}): stopped at {FED_STOP} and resumed from the "
          f"checkpoint = the uninterrupted run (losses, bytes, weights); "
          f"{full['payload_bytes_up']} B up / {full['payload_bytes_down']} "
          f"B down measured vs {full['analytic_bytes_up']:.0f} / "
          f"{full['analytic_bytes_down']:.0f} analytic; mean test acc "
          f"{full['mean_test_acc']}; wall {full['wall_s']:.3f} s, "
          f"{4 * full['steps'] / full['wall_s']:.1f} client steps/s; "
          f"launches {counts4}")
    again, dev_ms, wall_ms, _ = traced(lambda: run_fedtrain(spec4, ds,
                                                            **kw))
    _fed_same(full, again, "N=4 traced rerun vs first run")
    if dev_ms is None:
        print("fedtrain N=4 busy share: not measured (no device time)")
    else:
        print(f"fedtrain N=4 under torch.profiler: device {dev_ms} ms of "
              f"{wall_ms} ms wall, card busy {dev_ms / wall_ms * 100:.2f}%"
              f"; the rerun trained the same weights")
    chaos_counts = fedtrain_chaos(spec, ds, fed, counts, spec4, kw, full)
    if protocol.HOST_DENSIFY_COUNT.value != densify0:
        fail("fedtrain densified a payload on the host")
    print("fedtrain: HOST_DENSIFY_COUNT unchanged (0 host densifications)")
    return chaos_counts


# ---------------------------------------------------------------------------
# phase 11: open-loop serving — eviction, chaos, the load generator, traces
# ---------------------------------------------------------------------------

LG_CLIENTS, LG_PROMPT, LG_GEN = 6, 4, 8     # (a), (b): 6 x (4 + 8) tokens
LG_RATES = {"static": (12.0, 24.0),          # the reference's `_mini`
            # raised from (12, 24), where the ladder moved 6 times but
            # reached only (32, 8) at d 4096 (`--phase predict`), until a
            # session reached the 4-bit rung
            "qos": (20.0, 40.0)}


def _metric(res, name) -> int:
    series = res["metrics"].get(name, {}).get("series", [])
    return int(series[0]["value"]) if series else 0


def _lg_config(kind, rate, burst):
    from repro_torch.runtime import loadgen as lg
    from repro_torch.runtime.qos import QoSSpec

    qos = None
    fleet = ("randtopk:k=64",)
    if kind == "qos":
        fleet = ("randtopk_quant:k=64,bits=8",)
        qos = QoSSpec(k=K, d=D, bits=8, bits_floor=4, k_floor=8,
                      high_depth=6, low_depth=2, deadline_s=0.04,
                      patience=16, cooldown=1)
    return lg.LoadGenConfig(
        seed=3, duration_s=2.5,
        arrivals=lg.ArrivalSpec(process="mmpp", rate=rate, burst_rate=burst,
                                mean_calm_s=1.0, mean_burst_s=1.0),
        fleet=lg.FleetSpec(compressors=fleet, prompt_len=(2, 3), gen=(3, 5),
                           bandwidth_Bps=400_000.0),
        service=lg.ServiceModel(1e-3, 1e-4, 3e-5),
        slo=lg.SLOSpec(p99_ms=60.0, max_reject_frac=0.02), qos=qos,
        capacity=16, max_batch=8, max_wait=0.004, admission_depth=24)


def _lg_warm(lgc):
    """(warm-up encodes, warm-up decodes) of a loadgen run: one bottom step
    per spec it can reach, and the server's warm-up decodes for each."""
    specs = len(lgc.qos.ladder()) if lgc.qos else len(lgc.fleet.compressors)
    return specs, _warm_decodes(lgc.max_batch, specs)


def _lg_launches_ok(kind, rep, counts, lgc):
    """The kernel run's launches: one fused encode per served token, one
    flush decode per (flush, meta) group, plus the warm-up's."""
    specs, warm_dec = _lg_warm(lgc)
    tokens = sum(len(v) for v in rep["trace"]["k_bits"].values())
    groups = rep["served"]["decode_groups"]
    if counts["encode_sections"] != tokens + specs:
        fail(f"loadgen {kind}: {counts['encode_sections']} fused encode "
             f"launches for {tokens} served tokens and {specs} warm-up "
             f"steps")
    if counts["decode_to_slots"] != sum(groups.values()) + warm_dec:
        fail(f"loadgen {kind}: {counts['decode_to_slots']} flush decodes "
             f"for {sum(groups.values())} (flush, meta) groups and "
             f"{warm_dec} warm-up decodes")
    extra = {n: c for n, c in counts.items()
             if c and n not in ("encode_sections", "decode_to_slots")}
    if extra:
        fail(f"loadgen {kind}: launched {extra} beside the serve's two "
             f"kernels")
    print(f"loadgen {kind} launches: encode_sections "
          f"{counts['encode_sections']} = {tokens} served tokens + {specs} "
          f"warm-up steps; decode_to_slots {counts['decode_to_slots']} = "
          f"{sum(groups.values())} (flush, meta) groups {groups} over "
          f"{rep['flushes']} flushes ({rep['served']['mixed_meta_flushes']}"
          f" mixed-meta) + {warm_dec} warm-up decodes")


def _lg_summary(kind, rep, rate, burst):
    s, lat = rep["sessions"], rep["latency_ms"]
    rungs = sorted({tuple(kb) for v in rep["trace"]["k_bits"].values()
                    for kb in v}, reverse=True)
    return (f"loadgen {kind} (mmpp {rate}/{burst} sessions/s, 2.5 s): "
            f"{s['arrived']} arrivals, {s['completed']} completed, "
            f"{s['rejected']} rejected, {rep['tokens_out']} tokens out, "
            f"{rep['flushes']} flushes, decode groups "
            f"{rep['served']['decode_groups']} "
            f"({rep['served']['mixed_meta_flushes']} mixed-meta flushes); "
            f"VIRTUAL-time latency p50 {lat['p50_ms']} / p99 "
            f"{lat['p99_ms']} ms (ServiceModel, not card time); qos "
            f"switches {rep['qos']['switches']}, rungs {rungs}, level hist "
            f"{rep['qos']['level_hist']}"), rungs


def loadgen_prediction() -> None:
    """`--phase predict`, on the CPU: the loadgen reports that phase 11
    must print. A report is a function of the seed, the vocabulary size
    (the prompts' `randrange(vocab)` draws share the fleet's random
    stream) and the wire bytes (virtual time; the bytes depend on d, k
    and bits, not on the weights), so a 2-layer f32 model of yi-6b's
    width and vocabulary gives the full model's report, but for
    `wall_s_real` and the tokens."""
    from repro_torch import configs
    from repro_torch.models.config import SplitConfig
    from repro_torch.runtime import loadgen as lg

    cfg = configs.get("yi-6b").with_(
        n_layers=2, d_ff=128, param_dtype="float32", dtype="float32",
        split=SplitConfig(cut_layer=1, compressor="randtopk", k=K))
    # the QoS fleet at the static fleet's rates first: the reason its
    # rates were raised
    runs = [("qos", *LG_RATES["static"]), ("static", *LG_RATES["static"]),
            ("qos", *LG_RATES["qos"])]
    for kind, rate, burst in runs:
        lgc = _lg_config(kind, rate, burst)
        rep = lg.run_loadgen(cfg, lgc, device="cpu")
        print(_lg_summary(kind, rep, rate, burst)[0])
        specs, warm_dec = _lg_warm(lgc)
        frames = sum(len(v) for v in rep["trace"]["k_bits"].values())
        groups = sum(rep["served"]["decode_groups"].values())
        print(f"  launches on the card: encode_sections {frames + specs}, "
              f"decode_to_slots {groups + warm_dec}")


def loadgen_phase(dev, card):
    """Phase 11: open-loop serving of yi-6b FULL (32 layers, cut at 16,
    bf16, random weights from a seed) on the card. (a) LRU eviction to
    the host: 6 clients over 2 slots, with the kernels and with the plain
    versions, against 6 slots; (b) chaos: the same clients under seeded
    faults with ARQ; (c) the load generator, static and QoS, each with the
    kernels and then the plain versions: equal reports; (d) a traced
    closed-loop `launch/serve --trace`. Returns the kernels' launches in
    (c), to add to the `kernels` line."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import transformer
    from repro_torch.models.config import SplitConfig
    from repro_torch.obs.export import check_span_nesting
    from repro_torch.runtime import engine
    from repro_torch.runtime import loadgen as lg
    from repro_torch.testing import (DESTRUCTIVE_FAULTS, FaultInjector,
                                     FaultPlan)

    t_phase = time.perf_counter()
    cfg = configs.get("yi-6b")
    cut = cfg.n_layers // 2
    kern_cfg, plain_cfg = (cfg.with_(split=SplitConfig(
        cut_layer=cut, compressor="randtopk", k=K, backend=b))
        for b in (None, "torch"))
    params = transformer.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    print(f"loadgen phase: yi-6b {cfg.n_layers} layers (cut at {cut}), "
          f"d_model {cfg.d_model}, {cfg.dtype}; {card}")

    # (a) eviction: contended with kernels and plain, uncontended
    kw = dict(n_clients=LG_CLIENTS, prompt_len=LG_PROMPT, gen=LG_GEN,
              max_batch=4, params=params, seed=0, device="cuda")
    runs = {}
    for name, c, cap in (("contended", kern_cfg, 2),
                         ("uncontended", kern_cfg, LG_CLIENTS),
                         ("contended plain", plain_cfg, 2)):
        _lib.reset_launch_counts()
        runs[name] = r = engine.run_streaming(c, capacity=cap, **kw)
        r["launches"] = _lib.launch_counts()
        print(f"eviction {name} (capacity {cap}): {r['wall_s']:.3f} s, "
              f"{r['flushes']} flushes, evictions "
              f"{_metric(r, 'slot_evictions_total')}, readmissions "
              f"{_metric(r, 'slot_readmissions_total')}, launches "
              f"{ {n: v for n, v in r['launches'].items() if v} }")
    ref = runs["uncontended"]["tokens"]
    for name in ("contended", "contended plain"):
        r = runs[name]
        if not np.array_equal(r["tokens"], ref):
            fail(f"eviction: {name} tokens differ from the uncontended "
                 f"run's")
        if not (_metric(r, "slot_evictions_total") > 0
                and _metric(r, "slot_readmissions_total") > 0):
            fail(f"eviction: the {name} run neither evicted nor "
                 f"re-admitted")
    if any(runs["contended plain"]["launches"].values()):
        fail("eviction: the plain-version run launched kernels")
    print("eviction: contended (kernels and plain) tokens equal the "
          "uncontended run's")

    # (b) chaos
    inj = FaultInjector(FaultPlan(seed=3, **CHAOS_PLAN))
    chaos = engine.run_streaming(kern_cfg, wrap_endpoint=inj, **ARQ, **kw)
    fc = chaos["fault_counters"]
    injected = dict(inj.injected())
    if not np.array_equal(chaos["tokens"], ref):
        fail("chaos: tokens differ from the clean run's")
    if not (fc["replays"] > 0 and fc["reconnects"] > 0
            and fc["server_faults_detected"] + fc["client_faults_detected"]
            > 0 and sum(injected.get(f, 0) for f in DESTRUCTIVE_FAULTS)):
        fail(f"chaos: the recovery did not engage: {fc}, injected "
             f"{injected}")
    print(f"chaos (FaultPlan seed 3, retry_timeout 0.3 s): tokens equal the "
          f"clean run's in {chaos['wall_s']:.3f} s; injected {injected}; "
          f"recovered {fc}")

    # (c) the load generator, kernels then plain versions
    launches = {"encode_sections": 0, "decode_to_slots": 0}
    for kind in ("static", "qos"):
        rate, burst = LG_RATES[kind]
        lgc = _lg_config(kind, rate, burst)
        _lib.reset_launch_counts()
        rep = lg.run_loadgen(kern_cfg, lgc, params=params, device="cuda")
        counts = _lib.launch_counts()
        prep = lg.run_loadgen(plain_cfg, lgc, params=params, device="cuda")
        if any(_lib.launch_counts()[n] != counts[n] for n in counts):
            fail(f"loadgen {kind}: the plain-version run launched kernels")
        a = {k: v for k, v in rep.items() if k != "wall_s_real"}
        b = {k: v for k, v in prep.items() if k != "wall_s_real"}
        if a != b:
            diff = sorted(k for k in a if a[k] != b.get(k))
            fail(f"loadgen {kind}: kernel and plain reports differ in "
                 f"{diff}")
        if rep["cv_waits"] != 0 or rep["sessions"]["failed"] != 0:
            fail(f"loadgen {kind}: cv_waits {rep['cv_waits']}, failed "
                 f"{rep['sessions']['failed']}")
        _lg_launches_ok(kind, rep, counts, lgc)
        for n in launches:
            launches[n] += counts[n]
        line, rungs = _lg_summary(kind, rep, rate, burst)
        if kind == "qos" and not (rep["qos"]["switches"] > 0
                                  and (8, 4) in rungs):
            fail(f"loadgen qos: {rep['qos']['switches']} switches, rungs "
                 f"{rungs}: the 4-bit rung was never reached")
        print(f"{line}; kernel report == plain report (tokens included); "
              f"wall_s_real {rep['wall_s_real']:.3f} s kernels, "
              f"{prep['wall_s_real']:.3f} s plain")

    # (d) a traced closed-loop run through the CLI
    del params
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serve_trace.json")
        serve_cli.main(["--arch", "yi-6b", "--clients", "4", "--prompt-len",
                        "4", "--gen", "8", "--split", "randtopk", "--k",
                        str(K), "--trace", path])
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    problems = check_span_nesting(events)
    if problems:
        fail(f"trace: spans straddle: {problems[:3]}")
    spans = {}
    for e in events:
        if e.get("ph") == "X":
            spans.setdefault(e["name"], []).append(e["dur"] / 1e3)
    print(f"trace ({len(events)} events, spans nest; host ms, median over "
          f"the spans; {card}): " + "; ".join(
              f"{n} x{len(v)} {statistics.median(v):.4f}"
              for n, v in sorted(spans.items())))
    print(f"loadgen phase wall: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 12: the qk-norm dense and mixture-of-experts families
# ---------------------------------------------------------------------------

# (arch, depth): full width; qwen3-moe's 94 layers (some 450 GB in bf16)
# cut to 4, cut at 2, to fit one card
FAMILY_SERVES = (("granite-moe-1b-a400m", None), ("qwen3-8b", None),
                 ("granite-3-8b", None), ("phi3-mini-3.8b", None),
                 ("qwen3-moe-235b-a22b", 4))
FAM_CLIENTS, FAM_PROMPT, FAM_GEN = 2, 4, 8
FAM_TRAIN = "granite-moe-1b-a400m"         # full: 24 layers, cut at 12
FAM_TRAIN_STEPS = 3


def _moe_drops(params, cfg, batch, seed, dev):
    """(token, expert) pairs dropped at capacity, summed over the moe
    layers, in the forward of the first step (its RandTopK draws, the plain
    versions, no autograd): `models.moe.route` wrapped to count them."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.config import Runtime
    from repro_torch.split import model as split_model

    route, dropped = moe.route, []

    def counting(probs, k, capacity):
        r = route(probs, k, capacity)
        n_slots = probs.shape[0] * probs.shape[2] * capacity
        dropped.append((r.slot == n_slots).sum())
        return r

    moe.route = counting
    try:
        with torch.no_grad():
            split_model.forward(params, cfg, Runtime(training=True), batch,
                                generator=torch.Generator(
                                    device=dev).manual_seed(seed))
    finally:
        moe.route = route
    return int(sum(dropped)), len(dropped)


def families_phase(dev, card):
    """Phase 12: serve each of the five qk-norm dense and moe models at
    full width through `run_streaming` (2 clients x (4 + 8) tokens,
    randtopk k 64, bf16, random weights from a seed), with the kernels and
    then the plain versions: equal tokens below the vocabulary, payload
    bytes per token = `fwd_bits(d) / 8`, one fused encode per served token
    and one flush decode per flush group, no host densification. Then
    train granite-moe-1b-a400m FULL (24 layers, cut 12, batch 4 x seq 256,
    randtopk k 64 alpha 0.1): two plain first steps equal each other and
    the kernels' first step bit for bit (loss, aux, grad norm, every
    updated parameter), aux > 0, 3 steps through the kernels. Returns the
    kernels' launches of the serves and the training run."""
    import collections
    import gc
    import math

    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import _lib
    from repro_torch.launch import steps
    from repro_torch.models import moe, transformer
    from repro_torch.models.config import Runtime
    from repro_torch.optim.adamw import adamw_init

    def held_gib():
        """Free what earlier runs left to the cyclic collector; reset the
        peak. Returns the GiB still allocated, which the peaks below
        exclude, so each is that model's own."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        return torch.cuda.memory_allocated(dev) / 2**30

    def peak_gib(base):
        return torch.cuda.max_memory_allocated(dev) / 2**30 - base

    t_phase = time.perf_counter()
    total = collections.Counter()
    print(f"families phase: {FAM_CLIENTS} clients x ({FAM_PROMPT} prompt + "
          f"{FAM_GEN} gen) tokens, randtopk k={K}, bf16; {card}")
    for arch, layers in FAMILY_SERVES:
        cfg = configs.get(arch)
        if layers:
            cfg = cfg.with_(n_layers=layers)
        base = held_gib()
        t0 = time.perf_counter()
        params = transformer.init_model(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        kw = dict(gen=FAM_GEN, n_clients=FAM_CLIENTS, prompt_len=FAM_PROMPT)
        res, counts, nb = serve(cfg, params, "randtopk", **kw)
        _one_launch_per_token(res, counts, f"{arch} randtopk")
        plain, pcounts, _ = serve(cfg, params, "randtopk", backend="torch",
                                  **kw)
        if any(pcounts.values()):
            fail(f"{arch}: plain-version run launched kernels {pcounts}")
        if not (plain["tokens"] == res["tokens"]).all():
            fail(f"{arch}: tokens differ between kernels and plain versions")
        total.update(counts)
        peak = peak_gib(base)
        print(f"  {arch}: {cfg.n_layers} layers (cut at "
              f"{cfg.n_layers // 2}), d_model {cfg.d_model}, "
              f"{cfg.family}; kernel tokens = plain tokens "
              f"({res['tokens'].tolist()}); {nb} payload B/token "
              f"(fwd_bits(d) / 8); encode_sections "
              f"{counts['encode_sections']}, decode_to_slots "
              f"{counts['decode_to_slots']} launches ({res['flushes']} "
              f"flushes); {res['tokens_per_s']} tokens/s kernels, "
              f"{plain['tokens_per_s']} plain; init {init_s:.2f} s; peak "
              f"{peak:.2f} GiB (above the {base:.2f} GiB held before it)")
        del params
        torch.cuda.empty_cache()

    cfg = _train_cfg("randtopk", layers=None, cut=0, arch=FAM_TRAIN)
    plain_cfg = _train_cfg("randtopk", "torch", layers=None, cut=0,
                           arch=FAM_TRAIN)
    rt = Runtime(training=True)
    base = held_gib()
    params = transformer.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    pipe = TokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, device="cuda")
    batches = [pipe.next_batch(i) for i in range(FAM_TRAIN_STEPS)]
    print(f"training {FAM_TRAIN}: {cfg.n_layers} layers (cut at "
          f"{cfg.split.cut_layer}), d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts top-{cfg.topk_experts}, batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, randtopk k={K} "
          f"alpha={cfg.split.alpha}, AdamW, remat={rt.remat}")
    plain_step = steps.make_train_step(plain_cfg, rt)
    _lib.reset_launch_counts()
    runs = []
    for _ in range(2):
        p1, _, m1 = plain_step(params, adamw_init(params), batches[0],
                               torch.Generator(device=dev).manual_seed(1))
        runs.append((p1, m1))
    torch.cuda.synchronize()
    if any(_lib.launch_counts().values()):
        fail(f"plain-version step launched {_lib.launch_counts()}")
    (p_plain, m_plain), (p_again, m_again) = runs
    del runs, p1
    _same_first_step(p_plain, m_plain, p_again, m_again,
                     "two runs of the plain versions")
    del p_again
    drops, n_moe = _moe_drops(params, plain_cfg, batches[0], 1, dev)
    step = steps.make_train_step(cfg, rt)
    opt = adamw_init(params)
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    times, losses, auxes = [], [], []
    for i in range(FAM_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batches[i], gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        auxes.append(float(m["aux"]))
        if i == 0:
            _same_first_step(params, m, p_plain, m_plain)
            del p_plain
    counts = _lib.launch_counts()
    peak = peak_gib(base)
    missing = [n for n in TRAIN_PATH_KERNELS["randtopk"] if counts[n] == 0]
    if missing:
        fail(f"{FAM_TRAIN} training never launched {missing}")
    if not all(math.isfinite(v) for v in losses + auxes):
        fail(f"{FAM_TRAIN} losses not finite: {losses}, aux {auxes}")
    if not all(a > 0 for a in auxes):
        fail(f"{FAM_TRAIN} balance loss not positive: {auxes}")
    total.update(counts)
    T = TRAIN_BATCH * TRAIN_SEQ
    cap = moe._capacity(T, cfg, rt.moe_capacity)
    print(f"  {FAM_TRAIN} training: losses {losses}, aux {auxes}; "
          f"launches {counts}; {drops} (token, expert) pairs dropped at "
          f"capacity {cap} of {T} tokens x {cfg.topk_experts} experts x "
          f"{n_moe} layers in the first step's forward; step ms "
          f"{[round(t, 2) for t in times]}, median of steps 2-"
          f"{FAM_TRAIN_STEPS} {statistics.median(times[1:]):.2f} ms; peak "
          f"{peak:.2f} GiB (the plain runs' two first steps included; "
          f"above the {base:.2f} GiB held before it); {card}")
    del params, opt
    torch.cuda.empty_cache()
    print(f"families phase wall: {time.perf_counter() - t_phase:.1f} s")
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("all", "kernels", "serve", "train",
                                        "fedtrain", "loadgen", "families",
                                        "probe", "ab", "predict"),
                    default="all",
                    help="kernels: build + kernel checks + codec probes; "
                         "serve / train / fedtrain / loadgen / families: "
                         "the checks, "
                         "probes and one path; probe: build + `probe_kernels` "
                         "alone; ab: `probe` in turns on a parent tree's "
                         "package and this one (--parent); predict: the "
                         "loadgen phase's reports computed on the CPU "
                         "(checks no card, exits 3)")
    ap.add_argument("--layers", type=int, default=32,
                    help="serving depth of yi-6b (width is never cut)")
    ap.add_argument("--src", help="import repro_torch from this directory "
                                  "(a parent tree's src/) for --phase probe")
    ap.add_argument("--parent", help="the parent tree's root for --phase ab")
    args = ap.parse_args(argv)
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))

    import torch

    if args.phase == "predict":
        loadgen_prediction()
        print("chip_smoke: --phase predict ran on the CPU and checked no "
              "card", file=sys.stderr)
        return 3
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

    if args.phase == "ab":
        ab_phase(args.parent, card)
        return _ok()
    g = torch.Generator(device=dev).manual_seed(0)
    if args.phase == "probe":
        print(f"repro_torch from {os.path.dirname(_lib.CSRC)}")
        print(json.dumps({"probe": probe_kernels(dev, g)}))
        return _ok()
    t0 = time.perf_counter()
    records = [check_topk(dev, g), check_encode_sections(dev, g),
               check_decode(dev, g), check_randtopk(dev, g),
               check_decode_rows(dev, g), check_scatter_rows(dev, g)]
    own = [check_encode(dev, g), check_pack(dev, g), check_quant(dev, g),
           *check_flash(dev, g)]
    print("kernel checks: all twelve kernels agree with their plain "
          "versions (masks, indices, words, packed bits and the fused "
          "encode's wire sections byte for byte, quant codes, lo and step, "
          "scattered and non-quant decoded values exact; encode_rows' quant "
          "headers and dequantized values within 1 ulp; projected rows "
          "within 1 ulp plus 1e-5 of the summed |terms|; flash within 3e-5 "
          f"in f32 and 3e-2 in bf16) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    probe_kernels(dev, g)
    probe_fused(dev, g)
    print("the serving client's codec per token:")
    codec_token_ms(dev, g)
    print(f"codec probes: {time.perf_counter() - t0:.1f} s")

    # each kernel's launches are read from the runs of the paths it serves:
    # the two codec kernels of serving from the serving randtopk run, the
    # three of training from the training randtopk run, the top-k from the
    # tabular trainer's (its evaluation), plus the loadgen's and the
    # families phase's kernel runs; encode_rows, pack_bits, quantize and
    # the two flash kernels, which no path runs, from their checks' own
    # loops
    launches = {r["name"]: 0 for r in records}
    sources = {r["name"]: [] for r in records}

    def add(name, n, source):
        launches[name] += n
        sources[name].append(source)

    if args.phase in ("all", "serve"):
        t0 = time.perf_counter()
        counts = serve_phase(dev, args.layers)
        for n in PATH_KERNELS["randtopk"]:
            add(n, counts[n], "serving randtopk run")
        print(f"serving phases: {time.perf_counter() - t0:.1f} s")
    if args.phase in ("all", "train"):
        t0 = time.perf_counter()
        counts = train_phase(dev)
        for n in TRAIN_PATH_KERNELS["randtopk"]:
            add(n, counts[n], "training randtopk run")
        add("topk_mask_threshold", tabular_phase(dev)["topk_mask_threshold"],
            "tabular trainer's randtopk run (its evaluation)")
        smoke_train_cpu_vs_card(dev)
        for n, c in train_ckpt_phase(dev).items():
            if n in launches and c:
                add(n, c, "launch.train's resumed checkpoint run")
        print(f"training phases: {time.perf_counter() - t0:.1f} s")
    if args.phase in ("all", "fedtrain"):
        t0 = time.perf_counter()
        for n, c in fedtrain_phase(dev).items():
            if n in launches and c:
                add(n, c, "the fedtrain phase's three chaos runs")
        print(f"fedtrain phase: {time.perf_counter() - t0:.1f} s")
    if args.phase in ("all", "loadgen"):
        for n, c in loadgen_phase(dev, card).items():
            add(n, c, "the loadgen phase's two kernel runs")
    if args.phase in ("all", "families"):
        counts = families_phase(dev, card)
        for n in launches:
            if counts[n]:
                add(n, counts[n], "the families phase's kernel serves and "
                                  "granite-moe training")

    for r in records:
        r["launches"] = launches[r["name"]]
        r["launches_from"] = " + ".join(sources[r["name"]]) or \
            "no path run in this invocation"
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_from", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in records + own]}))
    return _ok()


def _ok() -> int:
    import torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


AB_TURNS = "PCCP"


def ab_phase(parent, card):
    """`--phase probe` in fresh processes, in turns P, C, C, P on this
    card: P imports the parent tree's package (`parent`/src, built there),
    C this tree's, and both are driven by this file's probes. Prints each
    turn's output, then one line per probe with the four turns' wrapper
    ms, device ms and host us (allocation, bare launch)."""
    if not parent or not os.path.isdir(os.path.join(parent, "src")):
        fail("--phase ab needs --parent, a tree with src/repro_torch")
    turns = []
    for i, who in enumerate(AB_TURNS):
        src = os.path.join(os.path.abspath(parent) if who == "P" else ROOT,
                           "src")
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--phase", "probe", "--src", src],
                             capture_output=True, text=True, timeout=1200)
        print(f"=== turn {i + 1}: {who} ({src}), rc {run.returncode}, "
              f"{time.perf_counter() - t0:.1f} s")
        print(run.stdout)
        if run.returncode != 0:
            print(run.stderr[-4000:])
            fail(f"turn {i + 1} ({who}) failed")
        line = next(ln for ln in run.stdout.splitlines()
                    if ln.startswith('{"probe"'))
        turns.append((who, json.loads(line)["probe"]))
    names = " / ".join(f"{w}{i + 1}" for i, (w, _) in enumerate(turns))
    print(f"A/B summary, turns {names}, {card}:")
    for key in turns[0][1]:
        recs = [t.get(key) or {} for _, t in turns]

        def col(name, scale=1.0):
            return " / ".join("-" if r.get(name) is None
                              else f"{r[name] * scale:.5g}" for r in recs)
        print(f"  {key}: wrapper ms {col('ms')}; device us "
              f"{col('device_ms', 1e3)}; host us {col('host_us')} "
              f"(alloc {col('alloc_us')}, launch {col('launch_us')}); "
              f"bound us {col('bound_ms', 1e3)}")


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


if __name__ == "__main__":
    sys.exit(main())
