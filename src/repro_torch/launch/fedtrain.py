"""Federated split-training entry point, a thin CLI over
`repro_torch.fedtrain`, on the card unless `--device cpu`.

Spins up N feature-owner training clients against one label-owner server,
every cut activation and cut gradient crossing an in-process byte channel
as `core.wire` frames, and reports the measured wire bytes of both
directions against the compressors' Table-2 accounting.

    python -m repro_torch.launch.fedtrain --clients 2 --method randtopk \
        --k 9 --epochs 3 --schedule adaptive

    # async local steps (Chen et al. 2021): sync every --local-steps
    PYTHONPATH=src python -m repro_torch.launch.fedtrain --device cpu \
        --local-steps 4
"""
from __future__ import annotations

import argparse

from repro_torch.data.synthetic import ManyClassDataset
from repro_torch.fedtrain import AsyncPolicy, ScheduleSpec, run_fedtrain
from repro_torch.split.tabular import SplitSpec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--method", default="randtopk",
                    help="none|topk|randtopk|randtopk_mask|size_reduction|"
                         "quant|randtopk_quant|l1")
    ap.add_argument("--k", type=int, default=9)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--classes", type=int, default=20)
    ap.add_argument("--train-n", type=int, default=2560)
    ap.add_argument("--cut-dim", type=int, default=64)
    ap.add_argument("--schedule", default="fixed",
                    choices=["fixed", "adaptive"],
                    help="adaptive: warmup-dense -> anneal -> plateau drops")
    ap.add_argument("--warmup", type=int, default=0,
                    help="dense warmup sync steps (adaptive schedule)")
    ap.add_argument("--local-steps", type=int, default=1,
                    help=">1 enables async local steps on a stale gradient")
    ap.add_argument("--ef", action="store_true",
                    help="per-client mean-residual error feedback")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' on purpose)")
    args = ap.parse_args(argv)

    ds = ManyClassDataset(n_classes=args.classes, in_dim=32,
                          n_train=args.train_n, n_test=1024, noise=0.3,
                          seed=args.seed)
    spec = SplitSpec(in_dim=32, hidden=128, cut_dim=args.cut_dim,
                     n_classes=args.classes, method=args.method, k=args.k,
                     alpha=args.alpha, quant_bits=args.bits, lr=args.lr)
    schedule = None
    if args.schedule == "adaptive":
        schedule = ScheduleSpec(k=args.k, d=args.cut_dim,
                                warmup_steps=args.warmup,
                                anneal_steps=8, k0=min(args.cut_dim,
                                                       2 * args.k),
                                k_min=max(1, args.k // 2))
    policy = (AsyncPolicy(local_steps=args.local_steps, warmup_sync=8)
              if args.local_steps > 1 else None)

    res = run_fedtrain(spec, ds, n_clients=args.clients, epochs=args.epochs,
                       batch=args.batch, seed=args.seed, schedule=schedule,
                       policy=policy, ef=args.ef, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, device=args.device)

    up, down = res["payload_bytes_up"], res["payload_bytes_down"]
    print(f"trained {args.clients} clients x {res['steps']} steps "
          f"({args.method}, schedule={args.schedule}, "
          f"local_steps={args.local_steps}) in {res['wall_s']:.1f}s")
    for cid, losses in enumerate(res["losses"]):
        if not losses:      # rerun of an already-completed checkpoint dir
            print(f"  client {cid}: nothing left to train")
            continue
        first, last = losses[0][1], losses[-1][1]
        print(f"  client {cid}: loss {first:.3f} -> {last:.3f} "
              f"({len(losses)} sync steps), final_k={res['final_k'][cid]}")
    print(f"wire: {up} B up / {down} B down measured payload "
          f"(+{res['header_bytes']} B framing) vs "
          f"{res['analytic_bytes_up']:.0f} / {res['analytic_bytes_down']:.0f}"
          f" B analytic")
    print(f"test acc {res['mean_test_acc']:.4f}, "
          f"{res['mean_test_acc'] / ((up + down) / 1e6):.3f} acc/MB")
    return res


if __name__ == "__main__":
    main()
