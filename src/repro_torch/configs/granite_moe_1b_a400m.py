"""Granite-MoE-1B-A400M: 24L d=1024 16H kv=8, 32 experts top-8, expert
d_ff=512, vocab 49155. [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155, n_experts=32, topk_experts=8, rope_theta=1e4,
    param_dtype="bfloat16", dtype="bfloat16",
)

SMOKE = FULL.with_(
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=128, vocab=512, n_experts=4, topk_experts=2,
    param_dtype="float32", dtype="float32",
)
