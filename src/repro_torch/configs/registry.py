"""Architecture registry: --arch <id> resolution for the launchers.

Each entry: (family, config module).  Only the archs whose configs are
ported are listed; the rest follow their families' slices in
ROADMAP.md.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

ARCHS: Dict[str, Tuple[str, str]] = {
    # arch id            family    config module
    "two-tower-retrieval": ("recsys",
                            "repro_torch.configs.two_tower_retrieval"),
    "deepfm":            ("recsys", "repro_torch.configs.deepfm"),
}


def get_arch(arch_id: str, smoke: bool = False):
    """Returns (family, config). smoke=True -> reduced config."""
    if arch_id not in ARCHS:
        raise KeyError(f"arch {arch_id!r} is not ported; ported archs: "
                       f"{sorted(ARCHS)}")
    family, module_name = ARCHS[arch_id]
    mod = importlib.import_module(module_name)
    cfg = mod.smoke_config() if smoke else mod.CONFIG
    return family, cfg
