"""Architecture registry. Each module exposes FULL (the exact published
config) and SMOKE (a reduced same-family variant for CPU tests): the
dense, moe, hybrid (zamba2), ssm (rwkv6), vlm (llama-3.2-vision) and
audio (whisper) families, the reference's ten configs."""
from __future__ import annotations

import importlib

ARCHS = [
    "qwen3_moe_235b_a22b",
    "zamba2_7b",
    "granite_3_8b",
    "yi_6b",
    "granite_moe_1b_a400m",
    "rwkv6_1p6b",
    "llama_3_2_vision_90b",
    "qwen3_8b",
    "whisper_tiny",
    "phi3_mini_3p8b",
]

_ALIASES = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "zamba2-7b": "zamba2_7b",
    "granite-3-8b": "granite_3_8b",
    "yi-6b": "yi_6b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "qwen3-8b": "qwen3_8b",
    "whisper-tiny": "whisper_tiny",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
}


def get(name: str, *, smoke: bool = False):
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
    if mod_name not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE if smoke else mod.FULL


def all_archs():
    """Every architecture's FULL config, in `ARCHS` order."""
    return [get(a) for a in ARCHS]


def with_layers(cfg, layers=None):
    """`cfg` with its depth cut to `layers` (None: as it is); a vlm's depth
    must be whole groups of `cross_attn_every` layers."""
    if not layers:
        return cfg
    if cfg.family == "vlm" and layers % cfg.cross_attn_every:
        raise ValueError(f"depth {layers}: the vlm's depth must be a "
                         f"multiple of cross_attn_every "
                         f"{cfg.cross_attn_every}")
    return cfg.with_(n_layers=layers)


def cut_for(cfg, cut=0):
    """The cut layer: `cut`, or n_layers // 2 when 0; a vlm cut is rounded
    down to whole groups of `cross_attn_every` layers, at least one (the
    reference's `launch/train.py`)."""
    cut = cut or max(1, cfg.n_layers // 2)
    if cfg.family == "vlm":
        g = cfg.cross_attn_every
        cut = max(g, cut // g * g)
    return cut
