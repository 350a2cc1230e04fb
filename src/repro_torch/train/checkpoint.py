"""Checkpointing built for fault tolerance, in the JAX package's
on-disk layout:

    <dir>/step_<N>/
        shard_<host>.npz       one file per host (its local arrays)
        manifest.json          paths, shapes, dtypes, crc32 per array
        COMMITTED              written last — a step dir without it
                               is a torn checkpoint and is ignored

Array paths are the JAX package's pytree paths: dict keys in sorted
order, list items as ``[i]``, and a :class:`TrainState` as its two
children ``0`` (params) and ``1`` (optimizer state), joined by ``/``.
So a checkpoint written by the JAX trainer restores into the port, and
one written here restores into the JAX trainer.

Restore is template-based: the caller supplies a tree of the right
structure (from ``init``) and leaves are filled by path, on the
template leaf's device and in its dtype.  float32 and the integer
types are stored as numpy holds them.  bfloat16 has no numpy type
without ``ml_dtypes``, so a bfloat16 leaf is stored as the JAX trainer
stores its ``ml_dtypes`` arrays: the raw 2-byte words (numpy ``|V2``),
with ``"dtype": "bfloat16"`` in the manifest and the crc32 over the same
bytes; restore reinterprets them on the template leaf's device.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.optimizer import TrainState


def _flatten_with_paths(tree, prefix: Tuple[str, ...] = ()
                        ) -> List[Tuple[str, Any]]:
    if isinstance(tree, TrainState):
        return (_flatten_with_paths(tree.params, prefix + ("0",))
                + _flatten_with_paths(tree.opt_state, prefix + ("1",)))
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten_with_paths(v, prefix + (f"[{i}]",))]
    return [("/".join(prefix), tree)]


def _unflatten(template, arrays: Dict[str, Any],
               prefix: Tuple[str, ...] = ()):
    """``template``'s structure with every leaf replaced by
    ``arrays[path]``."""
    if isinstance(template, TrainState):
        return TrainState(_unflatten(template.params, arrays, prefix + ("0",)),
                          _unflatten(template.opt_state, arrays,
                                     prefix + ("1",)))
    if isinstance(template, dict):
        return {k: _unflatten(v, arrays, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, arrays, prefix + (f"[{i}]",))
                              for i, v in enumerate(template))
    return arrays["/".join(prefix)]


_BF16_WORDS = np.dtype("V2")     # a bfloat16 array's bytes on disk


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.detach().view(torch.int16).cpu().numpy().view(
                _BF16_WORDS)
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _dtype_name(arr: np.ndarray) -> str:
    """The manifest's dtype: numpy's name, or the JAX trainer's
    ``bfloat16`` for bfloat16 words."""
    return "bfloat16" if arr.dtype == _BF16_WORDS else str(arr.dtype)


def _to_tensor(arr: np.ndarray, leaf: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor on ``leaf``'s device in its dtype; 2-byte
    words (``|V2``) are bfloat16 bits, reinterpreted on the device."""
    if arr.dtype == _BF16_WORDS:
        words = torch.from_numpy(np.array(arr, order="C").view(np.int16))
        return words.to(leaf.device).view(torch.bfloat16).to(leaf.dtype)
    return torch.from_numpy(np.array(arr, order="C")).to(
        device=leaf.device, dtype=leaf.dtype)     # 0-d stays 0-d


def save(ckpt_dir: str, step: int, tree, host_id: int = 0,
         keep: int = 3) -> str:
    """Atomic checkpoint write; prunes old steps beyond ``keep``."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in _flatten_with_paths(tree)}
    shard_path = os.path.join(tmp_dir, f"shard_{host_id}.npz")
    np.savez(shard_path, **{k.replace("/", "|"): v
                            for k, v in arrays.items()})
    manifest = {
        "step": step,
        "arrays": {k: {"shape": list(v.shape), "dtype": _dtype_name(v),
                       "crc32": zlib.crc32(np.ascontiguousarray(v).tobytes())}
                   for k, v in arrays.items()},
    }
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp_dir, "COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)
    _prune(ckpt_dir, keep)
    return step_dir


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = sorted(list_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "COMMITTED")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _validate(step_dir: str, arrays: Dict[str, np.ndarray]) -> None:
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    for k, meta in manifest["arrays"].items():
        v = arrays[k]
        crc = zlib.crc32(np.ascontiguousarray(v).tobytes())
        if crc != meta["crc32"]:
            raise IOError(f"checkpoint corruption: crc mismatch for {k}")


def restore(ckpt_dir: str, step: int, template, host_id: int = 0,
            validate: bool = True):
    """Fill ``template``'s leaves from the checkpoint (by path)."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(step_dir, f"shard_{host_id}.npz")) as z:
        arrays = {k.replace("|", "/"): z[k] for k in z.files}
    if validate:
        _validate(step_dir, arrays)
    filled = {}
    for key, leaf in _flatten_with_paths(template):
        if key not in arrays:
            raise KeyError(f"checkpoint missing array {key!r}")
        arr = arrays[key]
        want = tuple(leaf.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: ckpt shape {arr.shape} != {want}")
        filled[key] = _to_tensor(arr, leaf)
    return _unflatten(template, filled)


def restore_latest(ckpt_dir: str, template, host_id: int = 0):
    """(tree, step) from the newest *valid* committed checkpoint.

    Falls back to older checkpoints when the newest fails CRC/shape
    validation (a torn or bit-rotted write must not take the job down —
    that is the whole point of keeping ``keep`` > 1).
    Returns (None, -1) when nothing restorable exists.
    """
    for step in reversed(list_steps(ckpt_dir)):
        try:
            return restore(ckpt_dir, step, template, host_id), step
        except Exception:                      # corrupt/torn: try older
            continue
    return None, -1
