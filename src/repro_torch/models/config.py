"""Architecture and cut-layer configuration dataclasses (the reference's
field names and defaults; dtypes are named by string and resolved to
torch). The reference's `Runtime` knobs (mesh, remat, chunking, int8 KV)
have no reader in the port's dense decode yet, so there is no `Runtime`."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class SplitConfig:
    """Cut-layer placement + compression."""

    cut_layer: int = 0              # residual-stream boundary after this block
    compressor: str = "randtopk"    # see core.compressors.make_compressor
    k: int = 64                     # non-zeros per token vector
    alpha: float = 0.1              # RandTopk randomness (Eq. 7)
    quant_bits: int = 4
    l1_lam: float = 1e-4
    backend: Optional[str] = None   # kernel backend: None->auto (cuda kernel
                                    # for CUDA tensors), 'torch', 'cuda'


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Dense-family architecture fields (the only family ported so far)."""

    name: str
    family: str                     # dense
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    rope_theta: float = 1e6
    sliding_window: int = 0         # 0 = full causal attention
    param_dtype: str = "float32"
    dtype: str = "float32"
    split: Optional[SplitConfig] = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding tables padded to a multiple of 256, as in the
        reference (pad logits are never the argmax of trained weights)."""
        return (self.vocab + 255) // 256 * 256

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def adtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

