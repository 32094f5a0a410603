"""Two-party split training over the wire through the PyTorch port: the
paper's Figure-1 loop, live.

Two feature-owner clients train bottom models against one label-owner
server. Every step, each client streams its randomized-top-k compressed
cut activation up as framed bytes and receives the compressed cut gradient
back as a `grad` frame, so the dual-direction byte table printed at the
end is measured off a (simulated) socket and matches the paper's Table-2
fwd+bwd analytics. Runs on the card unless `--device cpu` is given.

    PYTHONPATH=src python examples/torch_fedtrain_two_party.py [--device cpu]
"""
import argparse

from repro_torch.data.synthetic import ManyClassDataset
from repro_torch.fedtrain import run_fedtrain
from repro_torch.split.tabular import SplitSpec


def main(device=None, n_clients=2, epochs=3, n_train=2560, n_test=1024):
    ds = ManyClassDataset(n_classes=20, in_dim=32, n_train=n_train,
                          n_test=n_test, noise=0.3, seed=0)
    spec = SplitSpec(in_dim=32, hidden=128, cut_dim=64, n_classes=20,
                     method="randtopk", k=9, lr=2e-3)
    print(f"training {n_clients} clients x {epochs} epochs, randtopk k=9 at "
          f"a d=64 cut ...")
    res = run_fedtrain(spec, ds, n_clients=n_clients, epochs=epochs,
                       batch=128, seed=0, device=device)

    steps = res["steps"]
    print(f"\n{steps} steps/client in {res['wall_s']:.1f}s, "
          f"test acc {res['mean_test_acc']:.4f}\n")
    print(f"{'client':>7} {'loss first->last':>18} {'B/step up':>10} "
          f"{'B/step down':>12}")
    for cid, (losses, cs) in enumerate(zip(res["losses"],
                                           res["client_stats"])):
        up = cs["payload_bytes_up"] / cs["frames_up"]
        down = cs["payload_bytes_down"] / cs["frames_down"]
        print(f"{cid:>7} {losses[0][1]:>8.3f} -> {losses[-1][1]:<7.3f} "
              f"{up:>10.1f} {down:>12.1f}")
    dense = spec.cut_dim * 4 * 128
    print(f"\nuncompressed would be {dense} B/step each way; measured "
          f"payload totals: {res['payload_bytes_up']} B up, "
          f"{res['payload_bytes_down']} B down "
          f"(analytic {res['analytic_bytes_up']:.0f} / "
          f"{res['analytic_bytes_down']:.0f} B)")
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    main(device=ap.parse_args().device)
