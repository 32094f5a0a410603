"""Paper Table 2: compressed sizes, the analytic formulas against the
byte-exact wire encodings, the counterpart of `benchmarks/table2_sizes.py`.

Every method is measured the same way: the client's codec
(`protocol.client_encode_device`: on the card one launch of the fused
encode kernel) turns the probe activation into its payload and packed wire
sections, and the socket bytes are held against the Table-2 analytic row
and the codec's own bits per instance. Then a microbench of the top-k
kernel, timed with CUDA events on the card.
"""
import time

import numpy as np
import torch

from repro_torch.core import compressors as C, wire
from repro_torch.experiments import common
from repro_torch.kernels.encode import ops as enc_ops
from repro_torch.kernels.randtopk import ops as tk_ops
from repro_torch.split import protocol

CODECS = [("size_reduction", dict(k=3)), ("topk", dict(k=3)),
          ("randtopk", dict(k=3)), ("randtopk_mask", dict(k=3)),
          ("quant", dict(bits=4)), ("randtopk_quant", dict(k=3, bits=8)),
          ("identity", {})]


def wire_bytes(comp, x) -> tuple:
    """(payload meta, socket body) of `comp`'s inference encode of x."""
    p, sections = protocol.client_encode_device(comp, x)
    return p.meta, enc_ops.sections_to_bytes(p.meta, p.batch_shape, sections)


def measured_nbytes(comp, x) -> tuple:
    """(payload meta, socket bytes) of `comp`'s inference encode of x."""
    meta, body = wire_bytes(comp, x)
    return meta, len(body)


def _us_per_call(fn, dev, n: int = 5) -> float:
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e6 / n


def main(emit=print, device=None):
    dev = common.device(device)
    d, n_inst = 128, 64
    x = torch.from_numpy(
        np.random.RandomState(0).randn(n_inst, d).astype(np.float32)).to(dev)
    ok_all = True
    for method, kw in CODECS:
        row = wire.table2_row(method, d, **kw)
        comp = C.make_compressor(method, **kw)
        meta, nbytes = measured_nbytes(comp, x)
        measured = nbytes / (n_inst * d * 4)
        analytic = row["fwd"]
        if method == "quant":
            # Table 2 writes 2^b/N and ignores the per-instance (lo, step)
            # range header (8 B) that any real encoder ships; the byte-exact
            # measurement includes it.
            analytic += 2 * 32 / (d * 32)
        close = abs(measured - analytic) / max(analytic, 1e-9) < 0.11
        ok_all &= close
        emit(f"table2,{method},fwd_analytic={row['fwd']:.4f},"
             f"fwd_measured={measured:.4f},bwd={row['bwd']:.4f},"
             f"match={close}")
        # the codec's own per-instance analytic bits must agree byte-for-byte
        codec_bits = wire.payload_bits_per_instance(meta) * n_inst
        slop = 8 * 2  # two bit-packed streams round up to whole bytes
        codec_ok = abs(nbytes * 8 - codec_bits) <= slop
        ok_all &= codec_ok
        emit(f"table2,{method},codec_bits_match={codec_ok}")
    emit(f"table2_check,analytic_matches_measured,{ok_all}")

    # kernel microbench: the first call builds the kernels where they are
    # not built yet, so it stands apart as the warm-up
    xb = torch.randn((256, 1024), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    t0 = time.perf_counter()
    tk_ops.topk_mask_threshold(xb, 16)[0].cpu()
    t_first = time.perf_counter() - t0
    us = _us_per_call(lambda: tk_ops.topk_mask_threshold(xb, 16), dev)
    emit(f"kernel_bench,topk_bisect_256x1024,us_per_call,"
         f"{us:.0f},warmup_s={t_first:.2f}")
    return ok_all


if __name__ == "__main__":
    main()
