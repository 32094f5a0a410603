"""PyTorch + CUDA port of the split-learning cut-layer system.

A second package beside the JAX reference (`src/repro/`), with the same
subpackage names. It imports `torch` and numpy only — never `jax` and
nothing from `repro`. Each Pallas kernel on a ported path is a CUDA C++
kernel written for Hopper (`csrc/*.cu`, built with `nvcc` at first use and
bound through `ctypes`); each has a plain PyTorch version in its family's
`ref.py` that the CPU tests run and `chip_smoke.py` holds the kernel
against.

Entry points run on the card unless the caller passes `device="cpu"`.
"""
