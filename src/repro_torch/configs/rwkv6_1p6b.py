"""RWKV6-1.6B ("Finch"): attention-free, 24L d=2048 d_ff=7168 vocab=65536,
data-dependent per-channel decay. [arXiv:2404.05892]"""
from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=7168, vocab=65536, rwkv=True, rwkv_lora=64,
    param_dtype="bfloat16", dtype="bfloat16",
)

SMOKE = FULL.with_(
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
    d_ff=512, vocab=512, rwkv_lora=16, param_dtype="float32", dtype="float32",
)
