"""Paper Appendix B analogue: an input-reconstruction (inversion) attack on
the cut-layer activations, the counterpart of
`benchmarks/appendixB_privacy.py`.

The attacker (the label owner, or an eavesdropper on the wire) trains an
inverter network from observed cut views back to the raw inputs, using its
own data. Paper claim: sparsified cut activations (Topk/RandTopk) leak
less than the dense cut (higher reconstruction error), and RandTopk's
error is at least Topk's.
"""
import numpy as np
import torch

from repro_torch.core import selection
from repro_torch.experiments import common
from repro_torch.experiments.common import EPOCHS, dataset, spec
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.split.tabular import bottom_fn, train


def _inverter_init(generator, d_in, d_out, hidden=256, device=None):
    def normal(shape, fan_in):
        return (2.0 / fan_in) ** 0.5 * torch.randn(
            shape, generator=generator, device=device)

    return {
        "w1": normal((d_in, hidden), d_in),
        "b1": torch.zeros((hidden,), device=device),
        "w2": normal((hidden, d_out), hidden),
        "b2": torch.zeros((d_out,), device=device),
    }


def _inverter_fn(p, o):
    h = torch.relu(o @ p["w1"] + p["b1"])
    return h @ p["w2"] + p["b2"]


def topk_view(o):
    return o * selection.topk_mask(o, 3).to(o.dtype)


def attack(bottom, view_fn, ds, *, epochs=8, seed=0, inv=None):
    """Train the inverter on (view(bottom(x)), x) pairs on the bottom's
    device; returns the test MSE. `inv` starts the inverter from given
    weights (the tests hand in the reference's), else they are drawn from
    `seed`."""
    dev = bottom["w1"].device
    if inv is None:
        inv = _inverter_init(torch.Generator(device=dev).manual_seed(seed),
                             128, ds.in_dim, device=dev)
    else:
        inv = {k: v.to(dev) for k, v in inv.items()}
    opt = adamw_init(inv)
    rng = np.random.RandomState(seed)
    for _ in range(epochs):
        for xb, _ in ds.batches(128, rng=rng):
            x = torch.from_numpy(xb).to(dev)
            with torch.no_grad():
                o = view_fn(bottom_fn(bottom, x))
            p = {k: v.detach().requires_grad_(True) for k, v in inv.items()}
            loss = torch.mean((_inverter_fn(p, o) - x) ** 2)
            g = torch.autograd.grad(loss, list(p.values()))
            inv, opt, _ = adamw_update(p, dict(zip(p, g)), opt, lr=1e-3,
                                       grad_clip=0.0)
    with torch.no_grad():
        xt = torch.from_numpy(ds.x_test).to(dev)
        o = view_fn(bottom_fn(bottom, xt))
        return float(torch.mean((_inverter_fn(inv, o) - xt) ** 2))


def checks(errs):
    return {
        "sparsified_leaks_less_than_dense":
            min(errs["topk"], errs["randtopk"]) > errs["none"],
        "randtopk_at_least_topk_privacy":
            errs["randtopk"] >= errs["topk"] * 0.9,
    }


def main(emit=print, device=None):
    dev = common.device(device)
    ds = dataset()
    ep = max(8, EPOCHS // 2)
    errs = {}
    for method, kw in [("none", {}), ("topk", dict(k=3)),
                       ("randtopk", dict(k=3, alpha=0.1))]:
        r = train(spec(method, **kw), ds, epochs=ep, seed=0, device=dev)
        view = (lambda o: o) if method == "none" else topk_view
        errs[method] = attack(r["bottom"], view, ds, epochs=max(4, ep // 2))
        emit(f"appendixB,{method},reconstruction_mse,{errs[method]:.4f}")
    out = checks(errs)
    for name, ok in out.items():
        emit(f"appendixB_check,{name},{ok}")
    return errs, out


if __name__ == "__main__":
    main()
