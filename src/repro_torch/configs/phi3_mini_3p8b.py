"""Phi-3-mini-3.8B: dense, 32L d=3072 32H kv=32 (MHA) d_ff=8192 vocab=32064,
RoPE + SwiGLU. [arXiv:2404.14219]"""
from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab=32064, rope_theta=1e4,
    param_dtype="bfloat16", dtype="bfloat16",
)

SMOKE = FULL.with_(
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
    d_ff=512, vocab=512, param_dtype="float32", dtype="float32",
)
