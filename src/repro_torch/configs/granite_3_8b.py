"""Granite-3-8B: dense GQA, 40L d=4096 32H kv=8 d_ff=12800 vocab=49155.
[hf:ibm-granite/granite-3.0-2b-base]"""
from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12800, vocab=49155, rope_theta=1e4,
    param_dtype="bfloat16", dtype="bfloat16",
)

SMOKE = FULL.with_(
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab=512, param_dtype="float32", dtype="float32",
)
