"""Llama-3.2-Vision-90B backbone: 100L total (80 self + 20 gated cross-attn,
one per 5), d=8192 64H kv=8 d_ff=28672 vocab=128256. Vision encoder STUBBED:
the batch carries patch embeddings (B, 1601, d).
[hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=128256, cross_attn_every=5, n_image_tokens=1601,
    rope_theta=5e5, param_dtype="bfloat16", dtype="bfloat16",
)

SMOKE = FULL.with_(
    n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab=512, cross_attn_every=2, n_image_tokens=8,
    param_dtype="float32", dtype="float32",
)
