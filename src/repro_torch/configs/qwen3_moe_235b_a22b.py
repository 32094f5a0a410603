"""Qwen3-MoE-235B-A22B: 94L, d=4096, 64H (GQA kv=4, hd=128), 128 experts
top-8, expert d_ff=1536, vocab 151936, qk-norm. [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936, n_experts=128, topk_experts=8,
    qk_norm=True, rope_theta=1e6,
    param_dtype="bfloat16", dtype="bfloat16",
)

SMOKE = FULL.with_(
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=128, vocab=512, n_experts=4, topk_experts=2,
    param_dtype="float32", dtype="float32",
)
