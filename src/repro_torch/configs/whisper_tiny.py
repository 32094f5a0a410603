"""Whisper-tiny backbone: enc-dec, 4+4L d=384 6H kv=6 d_ff=1536 vocab=51865.
Mel/conv frontend STUBBED: the batch carries frame embeddings (B, 1500,
384). LayerNorm per the original. [arXiv:2212.04356]"""
from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
    d_ff=1536, vocab=51865, encdec=True, n_enc_layers=4, n_frames=1500,
    norm="layer", rope_theta=1e4,
    param_dtype="bfloat16", dtype="bfloat16",
)

SMOKE = FULL.with_(
    n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64,
    d_ff=256, vocab=512, n_enc_layers=2, n_frames=16,
    param_dtype="float32", dtype="float32",
)
