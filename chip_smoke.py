#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (`src/repro_torch`), one card.

    python3 chip_smoke.py                  # everything, yi-6b at 32 layers
    python3 chip_smoke.py --phase kernels  # build + kernel checks only

Phases, each fatal on failure:

  1. build the four CUDA kernels from `src/repro_torch/csrc` (nvcc, sm_90a);
  2. hold each kernel against its plain PyTorch version on the card, at the
     serving path's shapes and at odd ones (rows not a multiple of a block,
     d not a multiple of 32, k in {1, 64, d-1}, ties, d = 16384): masks,
     indices, words and non-quant values exact; quant headers and decoded
     values within 1 ulp, quant codes exact; time kernel, plain version and,
     where one exists, the single PyTorch call that computes the same
     function;
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
  6. yi-6b SMOKE in f32: the card's tokens equal the port's CPU run.

Prints the card's name and power limit, a `kernels` JSON line (each
kernel's launches on the randtopk run, its largest difference from its
plain version, the CUDA-event times of kernel, plain version and library
call at the serving shapes, and the card's bound for the same work),
tokens/s, and as its last line {"ok": true, "device": {...}}. Exits
nonzero, with no result line, when CUDA is unavailable or any phase fails.
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
    res, dev_ms, call_ms = traced(lambda: engine.run_streaming(
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
        _, dev_ms, _ = traced(lambda: [fn() for _ in range(5)])
        out += [statistics.median(times), dev_ms and dev_ms / 5]
    return out


def traced(fn, enabled: bool = True):
    """Run `fn()`, under `torch.profiler` when `enabled`; returns (its
    result, the summed duration in ms of the device work in the trace, the
    wall ms of `fn()` and a synchronize). The two times are None when not
    traced, the first also when the trace holds no device time. Every
    thread launches on the one default stream, so durations do not
    overlap."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not enabled:
        return fn(), None, None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return out, (us / 1e3 if us > 0 else None), wall_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("all", "kernels"), default="all")
    ap.add_argument("--layers", type=int, default=32,
                    help="yi-6b depth (width is never cut)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.kernels import _lib
    from repro_torch.models import transformer

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
               check_decode(dev, g)]
    print("kernel checks: all four kernels agree with their plain versions "
          "(masks, indices, words, packed bits, quant codes and non-quant "
          "values exact; quant headers and decoded values within 1 ulp)")

    launches = {r["name"]: 0 for r in records}
    if args.phase == "all":
        cfg = configs.get("yi-6b").with_(n_layers=args.layers)
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
        launches = {n: counts[n] for n in launches}
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
