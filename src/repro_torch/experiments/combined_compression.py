"""Beyond the paper: sparsification and quantization combined, the
counterpart of `benchmarks/combined_compression.py`.

Claim checked: at matched-or-smaller compressed size, spending the byte
budget on a larger top-k support with low-bit values beats fp32 values on
a small support.
"""
from repro_torch.core import wire
from repro_torch.experiments import common
from repro_torch.experiments.common import EPOCHS, dataset, spec
from repro_torch.split.tabular import train

D = 128

RUNS = [
    ("randtopk_fp32_k3", "randtopk", dict(k=3, alpha=0.1)),
    ("randtopk_fp32_k6", "randtopk", dict(k=6, alpha=0.1)),
    ("randtopk_q8_k7", "randtopk_quant", dict(k=7, alpha=0.1, quant_bits=8)),
    ("randtopk_q4_k12", "randtopk_quant",
     dict(k=12, alpha=0.1, quant_bits=4)),
]


def checks(rows):
    return {
        # 4-bit k=12 (4.79%) must beat fp32 k=6 (5.71%): better accuracy
        # at fewer bytes
        "q4_k12_beats_fp32_k6_at_fewer_bytes":
            rows["randtopk_q4_k12"][0] > rows["randtopk_fp32_k6"][0]
            and rows["randtopk_q4_k12"][1] < rows["randtopk_fp32_k6"][1],
        "q8_k7_beats_fp32_k3":
            rows["randtopk_q8_k7"][0] > rows["randtopk_fp32_k3"][0],
    }


def main(emit=print, device=None):
    dev = common.device(device)
    rows = {}
    for name, method, kw in RUNS:
        r = train(spec(method, **kw), dataset(), epochs=EPOCHS, seed=0,
                  device=dev)
        size = wire.table2_row(method, D, k=kw["k"],
                               bits=kw.get("quant_bits", 0))["fwd"] * 100
        rows[name] = (r["test_acc"], size)
        emit(f"combined,{name},{r['test_acc']:.4f},{size:.2f}")
    out = checks(rows)
    for name, ok in out.items():
        emit(f"combined_check,{name},{ok}")
    return rows, out


if __name__ == "__main__":
    main()
