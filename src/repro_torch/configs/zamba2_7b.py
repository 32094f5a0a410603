"""Zamba2-7B: 81 Mamba2 layers (d=3584, state=64) + SHARED attention block
(32H kv=32, d_ff=14336) applied every 6 layers. [arXiv:2411.15242]"""
from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000, ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    attn_every=6, rope_theta=1e4,
    param_dtype="bfloat16", dtype="bfloat16",
)

SMOKE = FULL.with_(
    n_layers=4, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
    d_ff=512, vocab=512, ssm_state=16, ssm_head_dim=32, attn_every=2,
    param_dtype="float32", dtype="float32",
)
