"""Explicit two-party split-learning trainer for the paper-scale experiments
(Table 3, Figs 3-4), the reference's `split/tabular.py` in PyTorch.

It follows the paper's Figure 1 protocol literally. The trust boundary is a
detached tensor, so the only things that cross it are the label owner's
view of the cut activation and the masked cut gradient:

  feature owner:  O_b = M_b(X)            -> Comp(O_b) ------> wire
  label owner:    C[O_b] -> M_t -> loss;  G = dL/dC[O_b]
                  Comp_bwd(G) <----------------------------- wire
  feature owner:  dM_b = (dO_b/dtheta_b)^T G_masked   (O_b.backward(G))

The cut layer is the last hidden layer and the top model is a linear +
softmax classifier, the setting of the paper's analysis (Section 4.1).
Wire bytes per step are accounted with the Table-2 formulas (`core.wire`)
and cross-checked against measured payload bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import compressors as C, selection, wire
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.runtime.engine import resolve_device
from repro_torch.split import protocol


@dataclasses.dataclass
class SplitSpec:
    in_dim: int = 64
    hidden: int = 256
    cut_dim: int = 128          # d — bottom model output (paper: 128 for CIFAR)
    n_classes: int = 100
    method: str = "none"  # none|topk|randtopk|randtopk_mask|size_reduction|quant|l1|randtopk_quant
    k: int = 3
    alpha: float = 0.1
    quant_bits: int = 4
    l1_lam: float = 1e-3
    lr: float = 1e-3
    backend: Optional[str] = None   # kernel backend: None->auto, torch, cuda


def init_parties(generator: torch.Generator, spec: SplitSpec, device=None):
    """He-initialized bottom MLP and top classifier, drawn from
    `generator` (the reference's `init_parties` layout)."""
    def normal(shape, fan_in):
        return (2.0 / fan_in) ** 0.5 * torch.randn(
            shape, generator=generator, device=device)

    bottom = {
        "w1": normal((spec.in_dim, spec.hidden), spec.in_dim),
        "b1": torch.zeros((spec.hidden,), device=device),
        "w2": normal((spec.hidden, spec.cut_dim), spec.hidden),
        "b2": torch.zeros((spec.cut_dim,), device=device),
    }
    top = {
        "w": normal((spec.cut_dim, spec.n_classes), spec.cut_dim),
        "b": torch.zeros((spec.n_classes,), device=device),
    }
    return bottom, top


def bottom_fn(bp, x):
    h = torch.relu(x @ bp["w1"] + bp["b1"])
    # post-ReLU cut activation, like the paper's ResNet/TextCNN cut layers
    return torch.relu(h @ bp["w2"] + bp["b2"])


def top_fn(tp, o, y):
    logits = o @ tp["w"] + tp["b"]
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.mean(torch.gather(logp, 1, y.long()[:, None]))
    return loss, logits


def spec_compressor(spec: SplitSpec) -> C.Compressor:
    """SplitSpec -> codec object, the tabular twin of
    `protocol.make_cut_compressor`."""
    m, kw = spec.method, {"backend": spec.backend}
    if m in (None, "none"):
        return C.Compressor(**kw)
    if m == "topk":
        return C.TopK(k=spec.k, **kw)
    if m == "randtopk":
        return C.RandTopK(k=spec.k, alpha=spec.alpha, **kw)
    if m == "randtopk_mask":
        return C.RandTopKMask(k=spec.k, alpha=spec.alpha, **kw)
    if m == "size_reduction":
        return C.SizeReduction(k=spec.k, **kw)
    if m == "quant":
        return C.Quantization(bits=spec.quant_bits, **kw)
    if m == "randtopk_quant":
        return C.RandTopKQuant(k=spec.k, alpha=spec.alpha,
                               bits=spec.quant_bits, **kw)
    if m == "l1":
        return C.L1Reg(lam=spec.l1_lam, **kw)
    raise ValueError(m)


def _forward_view(o_b, spec: SplitSpec, generator, training: bool):
    """Label-owner-side view of the cut activation + the backward mask."""
    d = spec.cut_dim
    if spec.method in ("none", "l1"):
        return o_b, None
    if spec.method == "topk":
        mask = selection.topk_mask(o_b, spec.k, backend=spec.backend)
    elif spec.method == "randtopk_quant":
        y, aux = spec_compressor(spec).forward(o_b, generator=generator,
                                               training=training)
        return y, aux["mask"]
    elif spec.method in ("randtopk", "randtopk_mask"):
        # randtopk_mask differs only in wire encoding; the selection is
        # shared
        mask = (selection.randtopk_mask(o_b, spec.k, spec.alpha, generator,
                                        backend=spec.backend)
                if training else
                selection.topk_mask(o_b, spec.k, backend=spec.backend))
    elif spec.method == "size_reduction":
        mask = (torch.arange(d, device=o_b.device) < spec.k).expand(
            o_b.shape)
    elif spec.method == "quant":
        comp = spec_compressor(spec)
        return comp.decode(comp.encode(o_b), dtype=o_b.dtype), None
    else:
        raise ValueError(spec.method)
    return o_b * mask.to(o_b.dtype), mask


def make_train_step(spec: SplitSpec):
    """One explicit two-party step: (bottom, top, opt_b, opt_t, x, y,
    generator) -> (bottom, top, opt_b, opt_t, loss). The optimizer states
    are updated in place (`optim.adamw`)."""

    def step(bottom, top, opt_b, opt_t, x, y, generator):
        bottom = {k: v.detach().requires_grad_(True)
                  for k, v in bottom.items()}
        top = {k: v.detach().requires_grad_(True) for k, v in top.items()}
        # ---- feature owner forward
        o_b = bottom_fn(bottom, x)
        # ---- wire: forward payload; the view crosses the trust boundary
        with torch.no_grad():
            view, mask = _forward_view(o_b.detach(), spec, generator,
                                       training=True)
        view = view.detach().requires_grad_(True)
        # ---- label owner forward + backward
        loss, _ = top_fn(top, view, y)
        *dtp, dview = torch.autograd.grad(loss, [*top.values(), view])
        # ---- wire: backward payload (masked per Table 2)
        g_cut = dview if mask is None else dview * mask.to(dview.dtype)
        if spec.method == "l1":
            g_cut = g_cut + spec.l1_lam * torch.sign(o_b.detach()) / \
                x.shape[0]
        # ---- feature owner backward
        dbp = torch.autograd.grad(o_b, list(bottom.values()), g_cut)
        new_b, opt_b, _ = adamw_update(bottom, dict(zip(bottom, dbp)), opt_b,
                                       lr=spec.lr, grad_clip=0.0)
        new_t, opt_t, _ = adamw_update(top, dict(zip(top, dtp)), opt_t,
                                       lr=spec.lr, grad_clip=0.0)
        return new_b, new_t, opt_b, opt_t, loss.detach()

    return step


def measured_step_bytes(spec: SplitSpec, o_b, *, generator=None) -> int:
    """Byte-exact fwd+bwd wire payload bytes of one batch step, measured by
    encoding the cut activation and the backward payload its kind
    dictates (`core.wire.payload_nbytes` on both) — the frame-level
    cross-check of the formula-based `wire_bytes`. L1 is the exception the
    reference documents: its Table-2 row models a sparse encoding of the
    nnz support, while the training transport is the dense activation."""
    comp = spec_compressor(spec)
    p = protocol.client_encode(comp, o_b, generator=generator,
                               training=True)
    g = np.zeros(tuple(o_b.shape[:-1]) + (spec.cut_dim,), np.float32)
    gp = protocol.server_grad_encode(p, g)
    return wire.payload_nbytes(p) + wire.payload_nbytes(gp)


def wire_bytes(spec: SplitSpec, batch: int, *, training: bool,
               measured_nnz: float = None) -> float:
    d = spec.cut_dim
    if spec.method == "none":
        return wire.bytes_per_step("identity", d, batch, training=training)
    if spec.method == "l1":
        k = measured_nnz if measured_nnz is not None else d
        return wire.bytes_per_step("l1", d, batch, k=k, training=training)
    return wire.bytes_per_step(spec.method, d, batch, k=spec.k,
                               bits=spec.quant_bits, training=training)


def _accuracy(logits, y) -> float:
    return float(torch.mean((torch.argmax(logits, -1) == y.long()).to(
        torch.float32)))


@torch.no_grad()
def evaluate(bottom, top, spec: SplitSpec, x, y) -> float:
    """Inference-time accuracy with the method's deterministic behavior
    (the reference's choice of methods: randtopk_mask and l1 evaluate
    without a mask)."""
    o = bottom_fn(bottom, x)
    if spec.method == "randtopk_quant":
        o, _ = spec_compressor(spec).forward(o, training=False)
    elif spec.method in ("topk", "randtopk"):
        o = o * selection.topk_mask(o, spec.k, backend=spec.backend).to(
            o.dtype)
    elif spec.method == "size_reduction":
        o = o * (torch.arange(o.shape[-1], device=o.device) < spec.k).to(
            o.dtype)
    elif spec.method == "quant":
        comp = spec_compressor(spec)
        o = comp.decode(comp.encode(o), dtype=o.dtype)
    return _accuracy(o @ top["w"] + top["b"], y)


def _nnz(o) -> float:
    return float(torch.mean(torch.sum(torch.abs(o) > 1e-4, -1).float()))


def train(spec: SplitSpec, dataset, *, epochs: int = 15, batch: int = 128,
          seed: int = 0, record_every: int = 0, device=None,
          params=None) -> Dict:
    """Full two-party training run on `device` (default the card). Returns
    accuracy + comm accounting + an optional convergence trace.

    `params` = (bottom, top) starts from given weights (the tests hand in
    the reference's, converted); otherwise they are drawn from `seed`. The
    batch order is numpy's RandomState(seed), as in the reference; the
    RandTopK draws of the steps come from a torch.Generator seeded with
    `seed`, and the one-off byte probe draws from a generator of its own,
    so the steps' draws do not depend on it."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if params is None:
        bottom, top = init_parties(gen, spec, dev)
    else:
        bottom, top = ({k: v.to(dev) for k, v in part.items()}
                       for part in params)
    opt_b, opt_t = adamw_init(bottom), adamw_init(top)
    step = make_train_step(spec)
    rng = np.random.RandomState(seed)
    trace = []
    total_bytes = measured_bytes = 0.0
    step_nbytes = None
    x_test = torch.from_numpy(dataset.x_test).to(dev)
    y_test = torch.from_numpy(dataset.y_test).to(dev)
    it = 0
    loss = None
    for _ in range(epochs):
        for xb, yb in dataset.batches(batch, rng=rng):
            xb = torch.from_numpy(xb).to(dev)
            yb = torch.from_numpy(yb).to(dev)
            bottom, top, opt_b, opt_t, loss = step(bottom, top, opt_b, opt_t,
                                                   xb, yb, gen)
            if step_nbytes is None:
                # the per-step wire size is shape-static for every method
                # (l1's training transport is dense): measure once
                with torch.no_grad():
                    o_probe = bottom_fn(bottom, xb)
                step_nbytes = measured_step_bytes(
                    spec, o_probe,
                    generator=torch.Generator(device=dev).manual_seed(seed))
            measured_bytes += step_nbytes
            nnz = None
            if spec.method == "l1":
                with torch.no_grad():
                    nnz = _nnz(bottom_fn(bottom, xb))
            total_bytes += wire_bytes(spec, batch, training=True,
                                      measured_nnz=nnz)
            it += 1
            if record_every and it % record_every == 0:
                acc = evaluate(bottom, top, spec, x_test, y_test)
                trace.append((it, total_bytes, float(loss), acc))
    test_acc = evaluate(bottom, top, spec, x_test, y_test)
    train_acc = evaluate(bottom, top, spec,
                         torch.from_numpy(dataset.x_train).to(dev),
                         torch.from_numpy(dataset.y_train).to(dev))
    # measured compressed size at inference (relative, %)
    if spec.method == "l1":
        with torch.no_grad():
            nnz = _nnz(bottom_fn(bottom, x_test))
        rel = wire.table2_row("l1", spec.cut_dim, k=nnz)["fwd"]
    elif spec.method == "none":
        rel = 1.0
    else:
        rel = wire.table2_row(spec.method, spec.cut_dim, k=spec.k,
                              bits=spec.quant_bits)["fwd"]
    # formula-vs-measured cross-check: the compressor's own fwd/bwd
    # accounting (which, unlike the quant Table-2 row, counts the 8 B range
    # header a real encoder ships) must match the measured payload bytes
    # within 5%, and so must Table 2 except for quant. L1 is exempt (see
    # measured_step_bytes).
    if spec.method != "l1" and it > 0:
        comp = spec_compressor(spec)
        analytic = (comp.fwd_bits(spec.cut_dim)
                    + comp.bwd_bits(spec.cut_dim)) / 8 * batch * it
        rel_err = abs(measured_bytes - analytic) / analytic
        assert rel_err < 0.05, (
            f"{spec.method}: measured train bytes {measured_bytes:.0f} vs "
            f"analytic {analytic:.0f} ({100 * rel_err:.1f}% apart)")
        if spec.method != "quant":  # quant's Table-2 row omits the header
            rel_err = abs(measured_bytes - total_bytes) / total_bytes
            assert rel_err < 0.05, (
                f"{spec.method}: measured train bytes {measured_bytes:.0f} "
                f"vs Table-2 {total_bytes:.0f} ({100 * rel_err:.1f}% apart)")
    return {
        "method": spec.method, "k": spec.k, "alpha": spec.alpha,
        "test_acc": test_acc, "train_acc": train_acc,
        "gen_gap": train_acc - test_acc,
        "compressed_size_pct": 100.0 * rel,
        "train_bytes": total_bytes,
        "train_bytes_measured": measured_bytes, "trace": trace,
        "steps": it, "final_loss": None if loss is None else float(loss),
        "bottom": bottom, "top": top,
    }
