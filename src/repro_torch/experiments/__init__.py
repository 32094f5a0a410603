"""The paper's experiments through the port: one module per table or
figure, each the counterpart of the reference's script of the same name in
`benchmarks/`, driven by `run` (the counterpart of `benchmarks/run.py`).

    PYTHONPATH=src python -m repro_torch.experiments.run          # the card
    PYTHONPATH=src python -m repro_torch.experiments.run --fast --only table2,fig2
    PYTHONPATH=src python -m repro_torch.experiments.run --device cpu --fast

Every section trains the port's two-party tabular trainer
(`split.tabular`) through the kernels on the card, or on the CPU when
asked for it (`--device cpu`), and prints the reference's
`name,metric,value` lines and `*_check` lines letter for letter. The
accuracies are not the reference's (torch's draws are not JAX's); the
orderings the checks assert are what the port is held to. All data is
synthetic and made from seeds; nothing writes a benchmark file.
"""
