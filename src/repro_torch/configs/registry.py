"""Architecture registry: --arch <id> resolution for the launchers.

Each entry: (family, config module).  Only the archs whose configs are
ported are listed; asking for one of the JAX package's other archs
raises, naming what it waits for (ROADMAP.md).
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

ARCHS: Dict[str, Tuple[str, str]] = {
    # arch id            family    config module
    "gemma3-27b":        ("lm", "repro_torch.configs.gemma3_27b"),
    "gemma3-4b":         ("lm", "repro_torch.configs.gemma3_4b"),
    "stablelm-3b":       ("lm", "repro_torch.configs.stablelm_3b"),
    "qwen3-moe-30b-a3b": ("lm", "repro_torch.configs.qwen3_moe_30b_a3b"),
    "mixtral-8x7b":      ("lm", "repro_torch.configs.mixtral_8x7b"),
    "two-tower-retrieval": ("recsys",
                            "repro_torch.configs.two_tower_retrieval"),
    "deepfm":            ("recsys", "repro_torch.configs.deepfm"),
    "autoint":           ("recsys", "repro_torch.configs.autoint"),
    "bst":               ("recsys", "repro_torch.configs.bst"),
}

# archs of the JAX package not ported yet, and what each waits for
NOT_PORTED: Dict[str, str] = {
    "mace": ("the GNN family (models/gnn/{mace,so3}.py, data/graph.py, "
             "configs/mace.py; ROADMAP.md §1 item 7)"),
}


def get_arch(arch_id: str, smoke: bool = False):
    """Returns (family, config). smoke=True -> reduced config."""
    if arch_id not in ARCHS:
        why = NOT_PORTED.get(arch_id)
        raise KeyError(f"arch {arch_id!r} is not ported"
                       + (f": it waits for {why}" if why else "")
                       + f"; ported archs: {sorted(ARCHS)}")
    family, module_name = ARCHS[arch_id]
    mod = importlib.import_module(module_name)
    cfg = mod.smoke_config() if smoke else mod.CONFIG
    return family, cfg
