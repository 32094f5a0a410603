"""Beyond the paper: error feedback (Stich et al., cited by the paper for
HFL gradients) carried to split-learning cut activations, the counterpart
of `benchmarks/error_feedback.py`.

Activations are per-sample signals, so classic EF is ill-posed; a
per-class residual memory (`core.error_feedback.ef_topk_forward`) is the
closest analogue, and its effect is measured against plain Topk and
RandTopk at high compression. Reported either way, not checked.
"""
import numpy as np
import torch

from repro_torch.core.error_feedback import ef_topk_forward
from repro_torch.experiments import common
from repro_torch.experiments.common import EPOCHS, dataset, spec
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.split import tabular
from repro_torch.split.tabular import SplitSpec, bottom_fn, top_fn, train


def ef_step(sp: SplitSpec, bottom, top, opt_b, opt_t, err, x, y):
    """One two-party step with per-class error feedback at the cut:
    (bottom, top, opt_b, opt_t, err, loss). The residual memory is updated
    from the step's own forward, before either party's update, as the
    reference's jitted step does."""
    bottom = {k: v.detach().requires_grad_(True) for k, v in bottom.items()}
    top = {k: v.detach().requires_grad_(True) for k, v in top.items()}
    o_b = bottom_fn(bottom, x)
    with torch.no_grad():
        view, mask, new_err = ef_topk_forward(o_b.detach(), err, y, sp.k,
                                              sp.n_classes)
    view = view.requires_grad_(True)
    loss, _ = top_fn(top, view, y)
    *dtp, dview = torch.autograd.grad(loss, [*top.values(), view])
    dbp = torch.autograd.grad(o_b, list(bottom.values()),
                              dview * mask.to(dview.dtype))
    bottom, opt_b, _ = adamw_update(bottom, dict(zip(bottom, dbp)), opt_b,
                                    lr=sp.lr, grad_clip=0.0)
    top, opt_t, _ = adamw_update(top, dict(zip(top, dtp)), opt_t, lr=sp.lr,
                                 grad_clip=0.0)
    return bottom, top, opt_b, opt_t, new_err, loss.detach()


def fit_ef(sp: SplitSpec, ds, *, epochs, seed=0, device=None, params=None):
    """The trained (bottom, top) of `epochs` of EF training, from `params`
    (the tests hand in the reference's) or drawn from `seed`."""
    dev = common.device(device)
    if params is None:
        bottom, top = tabular.init_parties(
            torch.Generator(device=dev).manual_seed(seed), sp, dev)
    else:
        bottom, top = ({k: v.to(dev) for k, v in part.items()}
                       for part in params)
    opt_b, opt_t = adamw_init(bottom), adamw_init(top)
    err = torch.zeros((sp.n_classes, sp.cut_dim), device=dev)
    rng = np.random.RandomState(seed)
    for _ in range(epochs):
        for xb, yb in ds.batches(128, rng=rng):
            bottom, top, opt_b, opt_t, err, _ = ef_step(
                sp, bottom, top, opt_b, opt_t, err,
                torch.from_numpy(xb).to(dev), torch.from_numpy(yb).to(dev))
    return bottom, top


def train_ef(sp: SplitSpec, ds, *, epochs, seed=0, device=None,
             params=None) -> float:
    """Test accuracy after `fit_ef`."""
    bottom, top = fit_ef(sp, ds, epochs=epochs, seed=seed, device=device,
                         params=params)
    dev = bottom["w1"].device
    return tabular.evaluate(bottom, top, sp,
                            torch.from_numpy(ds.x_test).to(dev),
                            torch.from_numpy(ds.y_test).to(dev))


def main(emit=print, device=None):
    dev = common.device(device)
    ds = dataset()
    sp = spec("topk", k=3)
    acc_topk = train(sp, ds, epochs=EPOCHS, seed=0, device=dev)["test_acc"]
    acc_rand = train(spec("randtopk", k=3, alpha=0.1), ds,
                     epochs=EPOCHS, seed=0, device=dev)["test_acc"]
    acc_ef = train_ef(sp, ds, epochs=EPOCHS, seed=0, device=dev)
    emit(f"ef,topk,{acc_topk:.4f}")
    emit(f"ef,randtopk,{acc_rand:.4f}")
    emit(f"ef,topk+class_error_feedback,{acc_ef:.4f}")
    # informational: does EF close any of the randtopk-topk gap?
    emit(f"ef_info,ef_minus_topk,{acc_ef - acc_topk:+.4f}")
    emit(f"ef_info,randtopk_minus_ef,{acc_rand - acc_ef:+.4f}")
    return {"topk": acc_topk, "randtopk": acc_rand, "ef": acc_ef}


if __name__ == "__main__":
    main()
