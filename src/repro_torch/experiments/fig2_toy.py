"""Paper Figure 2: the toy local-minimum example, the counterpart of
`benchmarks/fig2_toy.py`.

Concept f(x1,x2)=Sign(x1-x2); split model M_b=(w1 x1, w2 x2),
M_t=Tanh(o1+o2); samples (1,0)->+1 and (0.5,1)->-1; init w1=1, w2=-0.1.

With top-1 sparsification o2 is always masked (|w1 x1| > |w2 x2| for both
samples at init), so w2 never trains and SGD converges to the bad local
minimum. RandTopk occasionally selects o2 (prob alpha), trains w2, and
escapes. The flips are Bernoulli draws from a `torch.Generator`.
"""
import torch

from repro_torch.experiments import common

X = torch.tensor([[1.0, 0.0], [0.5, 1.0]])
Y = torch.tensor([1.0, -1.0])


def loss_fn(w, mask):
    o = w * X.to(w.device) * mask              # (2, 2) masked cut activations
    pred = torch.tanh(o.sum(-1))
    return torch.mean((pred - Y.to(w.device)) ** 2)


def flip_mask(w, flip):
    """The top-1 mask of each sample, inverted where `flip` (2, 1) is
    set."""
    o = torch.abs(w * X.to(w.device))
    top = (o >= o.amax(-1, keepdim=True)).to(torch.float32)
    return torch.where(flip, 1.0 - top, top)


def select_mask(w, alpha, generator):
    flip = torch.zeros((X.shape[0], 1), dtype=torch.bool, device=w.device)
    if alpha != 0.0:
        flip = torch.bernoulli(torch.full((X.shape[0], 1), alpha,
                                          device=w.device),
                               generator=generator).bool()
    return flip_mask(w, flip)


def grad(w, mask):
    w = w.detach().requires_grad_(True)
    return torch.autograd.grad(loss_fn(w, mask), w)[0]


def run(alpha: float, steps: int = 4000, lr: float = 0.1, seed: int = 0,
        device=None):
    dev = common.device(device)
    w = torch.tensor([1.0, -0.1], device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    traj = [w.cpu().numpy()]
    for t in range(steps):
        mask = select_mask(w, alpha, gen)
        w = w - lr * grad(w, mask)
        if t % 500 == 0:
            traj.append(w.cpu().numpy())
    final_loss = float(loss_fn(w, torch.ones_like(X, device=dev)))
    return w.cpu().numpy(), final_loss, traj


def checks(w_topk, loss_topk, w_rand, loss_rand):
    """The paper's claim: topk is stuck (w2 untrained, loss high);
    randtopk escapes."""
    stuck = abs(w_topk[1] - (-0.1)) < 0.05 and loss_topk > 0.3
    escaped = w_rand[1] < -0.5 and loss_rand < 0.2
    return stuck, escaped


def main(emit=print, device=None):
    dev = common.device(device)
    w_topk, loss_topk, _ = run(alpha=0.0, device=dev)
    w_rand, loss_rand, _ = run(alpha=0.1, device=dev)
    emit(f"fig2_toy,topk_final_loss,{loss_topk:.4f},w={w_topk.round(3)}")
    emit(f"fig2_toy,randtopk_final_loss,{loss_rand:.4f},w={w_rand.round(3)}")
    stuck, escaped = checks(w_topk, loss_topk, w_rand, loss_rand)
    emit(f"fig2_toy,topk_stuck,{stuck}")
    emit(f"fig2_toy,randtopk_escaped,{escaped}")
    return {"topk_loss": loss_topk, "rand_loss": loss_rand,
            "topk_stuck": stuck, "rand_escaped": escaped}


if __name__ == "__main__":
    main()
