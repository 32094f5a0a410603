"""Production-mesh walkthrough through the PyTorch port: count one
architecture's step on the 2-pod 512-position mesh with the RandTopk cut
transfer crossing the pod boundary, and print its roofline terms. Runs on
the `meta` device: no card, nothing allocated.

    PYTHONPATH=src python examples/torch_multipod_dryrun.py [arch] [shape]
"""
import sys

from repro_torch.launch import dryrun


def main(arch="qwen3-8b", shape="train_4k", multi_pod=True, split="randtopk",
         k=64, mesh=None):
    """`mesh`: a `meta` mesh to count on instead of (2, 16, 16)."""
    roof = dryrun.run_combo(arch, shape, multi_pod=multi_pod, split=split,
                            k=k, mesh=mesh)
    row = roof.row()
    print("\nsummary:", {k: row[k] for k in
                         ("arch", "shape", "mesh", "bottleneck")})
    return roof


if __name__ == "__main__":
    main(*sys.argv[1:3])
