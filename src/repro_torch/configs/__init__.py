"""Architecture registry. Each module exposes FULL (the exact published
config) and SMOKE (a reduced same-family variant for CPU tests). Only the
dense family is ported so far."""
from __future__ import annotations

import importlib

ARCHS = ["yi_6b"]

_ALIASES = {"yi-6b": "yi_6b"}


def get(name: str, *, smoke: bool = False):
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
    if mod_name not in ARCHS:
        raise ValueError(f"architecture {name!r} is not ported yet "
                         f"(ported: {ARCHS})")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE if smoke else mod.FULL
