"""Architecture registry. Each module exposes FULL (the exact published
config) and SMOKE (a reduced same-family variant for CPU tests). The
dense, moe, hybrid (zamba2) and ssm (rwkv6) families are ported; the vlm
and audio families are not yet."""
from __future__ import annotations

import importlib

ARCHS = [
    "qwen3_moe_235b_a22b",
    "zamba2_7b",
    "granite_3_8b",
    "yi_6b",
    "granite_moe_1b_a400m",
    "rwkv6_1p6b",
    "qwen3_8b",
    "phi3_mini_3p8b",
]

#: the reference's architectures whose families the port lacks
NOT_PORTED = {
    "llama_3_2_vision_90b": "vlm",
    "whisper_tiny": "audio",
}

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
        family = NOT_PORTED.get(mod_name)
        raise ValueError(
            f"architecture {name!r} is not ported yet"
            + (f" (its {family} family is not)" if family else "")
            + f"; not ported: {sorted(NOT_PORTED)}; ported: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE if smoke else mod.FULL
