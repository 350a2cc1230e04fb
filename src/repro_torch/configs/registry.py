"""Architecture registry: --arch <id> resolution for the launchers.

Each entry: (family, config module), every arch of the JAX package's
registry.  Cells marked ``skip`` in SHAPE_SKIPS are documented
inapplicabilities (DESIGN.md §4).
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES

ARCHS: Dict[str, Tuple[str, str]] = {
    # arch id            family    config module
    "gemma3-27b":        ("lm", "repro_torch.configs.gemma3_27b"),
    "gemma3-4b":         ("lm", "repro_torch.configs.gemma3_4b"),
    "stablelm-3b":       ("lm", "repro_torch.configs.stablelm_3b"),
    "qwen3-moe-30b-a3b": ("lm", "repro_torch.configs.qwen3_moe_30b_a3b"),
    "mixtral-8x7b":      ("lm", "repro_torch.configs.mixtral_8x7b"),
    "mace":              ("gnn", "repro_torch.configs.mace"),
    "autoint":           ("recsys", "repro_torch.configs.autoint"),
    "two-tower-retrieval": ("recsys",
                            "repro_torch.configs.two_tower_retrieval"),
    "deepfm":            ("recsys", "repro_torch.configs.deepfm"),
    "bst":               ("recsys", "repro_torch.configs.bst"),
}

# (arch, shape) cells skipped with documented reasons (DESIGN.md §4).
SHAPE_SKIPS: Dict[Tuple[str, str], str] = {
    ("stablelm-3b", "long_500k"):
        "pure full attention — every layer would hold the full 500k KV; "
        "no sub-quadratic mechanism in the published config",
    ("qwen3-moe-30b-a3b", "long_500k"):
        "pure full attention — same reasoning as stablelm-3b",
}


def get_arch(arch_id: str, smoke: bool = False):
    """Returns (family, config). smoke=True -> reduced config."""
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; archs: {sorted(ARCHS)}")
    family, module_name = ARCHS[arch_id]
    mod = importlib.import_module(module_name)
    cfg = mod.smoke_config() if smoke else mod.CONFIG
    return family, cfg


def shapes_for(arch_id: str):
    family, _ = ARCHS[arch_id]
    return {"lm": LM_SHAPES, "gnn": GNN_SHAPES,
            "recsys": RECSYS_SHAPES}[family]


def all_cells(include_skipped: bool = False):
    """Every (arch, shape) pair in the assignment; 40 total, 38 runnable."""
    for arch in ARCHS:
        for shape in shapes_for(arch):
            skip = SHAPE_SKIPS.get((arch, shape.name))
            if skip and not include_skipped:
                continue
            yield arch, shape, skip
