"""Qwen3-8B: dense GQA with qk-norm, 36L d=4096 32H kv=8 d_ff=12288
vocab=151936. [hf:Qwen/Qwen3-8B]"""
from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12288, vocab=151936, qk_norm=True, rope_theta=1e6,
    param_dtype="bfloat16", dtype="bfloat16",
)

SMOKE = FULL.with_(
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab=512, param_dtype="float32", dtype="float32",
)
