"""Architecture, cut-layer and runtime configuration dataclasses (the
reference's field names and defaults; dtypes are named by string and
resolved to torch). `ArchConfig` holds the fields of the families the port
runs (dense, with or without qk-norm, mixture-of-experts, the zamba2
hybrid of Mamba2 layers and a shared attention block, RWKV6, the vlm's
gated cross-attention layers over image patches, and the audio
encoder-decoder with layer norm);
`Runtime` keeps the knobs the port's forward reads: the scan chunks
of the recurrent families, the label owner's KV cache width, and the
training mesh (`mesh`, `seq_shard`, `dp_only`, with the reference's
defaults and its `axis_names`, `batch_axes` and `has_model_axis`) with
`registry`, the run's registry its collectives count into (the port's
own field). The arena's serving takes its mesh as an argument, as the
reference's does (`runtime.engine.run_streaming(mesh=)`), not from
`Runtime`; the whole-batch serve step (`launch.steps.make_serve_step`)
takes it from `Runtime.mesh`, where `flash_decode` shards its KV cache
over 'model' along the ring's slots."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

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
    transfer_over_pod: bool = True  # under a mesh with a 'pod' axis, the
                                    # payload leaves cross to the next pod


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Architecture fields of the dense, moe, hybrid, ssm, vlm and audio
    families."""

    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    qk_norm: bool = False           # RMS norm of q and k over head_dim
    rope_theta: float = 1e6
    norm: str = "rms"               # rms | layer (every block, the encoder's
                                    # and the final norm)
    # --- MoE ---
    n_experts: int = 0
    topk_experts: int = 0
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    attn_every: int = 0             # zamba2: shared attn block every N layers
    # --- RWKV6 ---
    rwkv: bool = False
    rwkv_lora: int = 64
    # --- VLM ---
    cross_attn_every: int = 0       # a gated cross-attn layer every N layers
    n_image_tokens: int = 0
    # --- audio enc-dec ---
    encdec: bool = False
    n_enc_layers: int = 0
    n_frames: int = 0
    sliding_window: int = 0         # 0 = full causal attention
    param_dtype: str = "float32"
    dtype: str = "float32"
    kv_cache_bits: int = 0          # the label owner's KV arena: 8 -> int8
    #   codes + f32 per-(token, head) scales (attention.init_kv_cache);
    #   0 -> the Runtime default (16: the activation dtype). Clients keep
    #   16-bit caches.
    split: Optional[SplitConfig] = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding tables padded to a multiple of 256, as in the
        reference (pad logits are never the argmax of trained weights)."""
        return (self.vocab + 255) // 256 * 256

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def adtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution knobs threaded through the full-sequence forward."""

    training: bool = True
    remat: bool = True              # recompute each layer in the backward
                                    # (torch.utils.checkpoint per layer; the
                                    # cut boundary stays outside it)
    attn_chunk: int = 1024          # query-chunk length for long sequences
    moe_capacity: float = 1.25      # expert capacity factor (models.moe)
    ssm_chunk: int = 128            # SSD chunk length (models.ssm)
    rwkv_chunk: int = 16            # WKV chunk length (models.rwkv)
    rwkv_mode: str = "chunk"        # chunk (matrix form) | scan (sequential)
    kv_cache_bits: int = 16         # 8 -> int8 KV cache (+ f32 scales)
    mesh: Any = None                # repro_torch.mesh.Mesh: the training mesh
    seq_shard: bool = True          # Megatron sequence parallelism: the
                                    # residual is sharded over 'model' along
                                    # the sequence at layer boundaries
    flash_decode: bool = True       # shard decode KV caches over 'model'
                                    # on the SEQUENCE dim (GQA head counts
                                    # can't split a 16-way axis;
                                    # replication costs 16x memory); read
                                    # by the meshed serve step only
    dp_only: bool = False           # the 'model' axis joins the batch axes;
                                    # no tensor parallelism (and no flash
                                    # decode)
    registry: Any = None            # the run's MetricsRegistry: collective
                                    # bytes under a mesh

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.mesh.axis_names) if self.mesh is not None else ()

    @property
    def batch_axes(self):
        """The mesh axes the batch splits over: ('pod', 'data'), plus
        'model' under `dp_only`, those the mesh has; None without any."""
        names = (("pod", "data", "model") if self.dp_only
                 else ("pod", "data"))
        ax = tuple(a for a in names if a in self.axis_names)
        return ax if ax else None

    @property
    def has_model_axis(self) -> bool:
        return "model" in self.axis_names
