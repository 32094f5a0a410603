"""Streaming multi-client serving through the PyTorch port: N feature
owners against one batching server, every cut activation crossing the wire
as framed bytes.

Eight clients, half sending dense (uncompressed) cut activations, half
randomized-top-k payloads, stream a short generation each through
`repro_torch.runtime.engine.run_streaming`. The per-session table is
measured from the actual frame bytes, so the dense/randtopk size ratio
printed here is the paper's compression claim on a (simulated) socket.
Runs on the card unless `--device cpu` is given.

    PYTHONPATH=src python examples/torch_streaming_clients.py [--device cpu]
"""
import argparse

import numpy as np

import repro_torch.configs as configs
from repro_torch.models.config import SplitConfig
from repro_torch.runtime.engine import run_streaming


def main(device=None, n_clients=8, prompt_len=4, gen=12, max_batch=8):
    cfg = configs.get("qwen3-8b", smoke=True).with_(
        split=SplitConfig(cut_layer=1, compressor="randtopk", k=16,
                          alpha=0.1))
    print(f"serving {n_clients} streaming sessions ({n_clients // 2} dense "
          f"+ {n_clients - n_clients // 2} randtopk clients), "
          f"max_batch={max_batch} ...")
    res = run_streaming(cfg, n_clients=n_clients, prompt_len=prompt_len,
                        gen=gen, max_batch=max_batch, max_wait=0.02,
                        compressor_mix=["identity", "randtopk:k=16"],
                        device=device)

    print(f"\n{res['tokens_per_s']:.0f} tok/s over the session mix, "
          f"mean server batch fill "
          f"{np.mean(res['batch_sizes']):.1f}/{max_batch}\n")
    print(f"{'session':>7} {'compressor':>12} {'payload B/tok':>13} "
          f"{'framing B/tok':>13} {'vs dense':>9}")
    dense_bytes = cfg.d_model * 4
    for cid, (name, s) in enumerate(zip(res["compressors"],
                                        res["client_stats"])):
        payload = s["payload_bytes_up"] / s["frames_up"]
        framing = s["header_bytes_up"] / s["frames_up"]
        print(f"{cid:>7} {name:>12} {payload:>13.1f} {framing:>13.1f} "
              f"{100 * payload / dense_bytes:>8.1f}%")
    print("\nsample continuation of session 0:",
          res["tokens"][0, :8].tolist())
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    main(device=ap.parse_args().device)
