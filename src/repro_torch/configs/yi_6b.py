"""Yi-6B: llama-arch dense GQA, 32L d=4096 32H kv=4 d_ff=11008 vocab=64000.
[arXiv:2403.04652]"""
from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab=64000, rope_theta=5e6,
    param_dtype="bfloat16", dtype="bfloat16",
)

SMOKE = FULL.with_(
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab=512, param_dtype="float32", dtype="float32",
)
