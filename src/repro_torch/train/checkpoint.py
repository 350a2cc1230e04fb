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
template leaf's device and in its dtype.

Under a mesh (``launch/mesh.py``) the arrays are still stored whole, as
the JAX package stores them: ``save`` gathers each leaf that its spec
splits from every rank of the split axes and one rank writes.  So a
checkpoint moves to any mesh or to one device: :func:`elastic_restore`
reads the whole arrays and places each rank's block.  float32 and the integer
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


def _to_tensor(arr: np.ndarray, leaf: torch.Tensor,
               device=None) -> torch.Tensor:
    """``arr`` as a tensor on ``device`` (default: ``leaf``'s) in
    ``leaf``'s dtype; 2-byte words (``|V2``) are bfloat16 bits,
    reinterpreted on the device."""
    device = leaf.device if device is None else device
    if arr.dtype == _BF16_WORDS:
        words = torch.from_numpy(np.array(arr, order="C").view(np.int16))
        return words.to(device).view(torch.bfloat16).to(leaf.dtype)
    return torch.from_numpy(np.array(arr, order="C")).to(
        device=device, dtype=leaf.dtype)     # 0-d stays 0-d


def _named_specs(spec_tree, mesh) -> Dict[str, Any]:
    """{path: NamedSpec} of a spec tree shaped like the checkpointed tree
    (a :class:`TrainState` of spec trees, or one spec tree)."""
    from repro_torch.sharding.rules import named
    if isinstance(spec_tree, TrainState):
        spec_tree = TrainState(named(mesh, spec_tree.params),
                               named(mesh, spec_tree.opt_state))
    else:
        spec_tree = named(mesh, spec_tree)
    return dict(_flatten_with_paths(spec_tree))


def _whole(leaf: torch.Tensor, ns) -> torch.Tensor:
    """The whole leaf of which ``leaf`` is this rank's block under the
    NamedSpec ``ns``: gathered over each split dim's axes (a collective
    every rank of those axes makes)."""
    from repro_torch.sharding.collectives import all_gather
    for dim, axes in enumerate(ns.spec):
        if axes is not None:
            leaf = all_gather(leaf.movedim(dim, 0), ns.mesh, axes).movedim(
                0, dim)
    return leaf


def save(ckpt_dir: str, step: int, tree, host_id: int = 0,
         keep: int = 3, mesh=None, specs=None) -> str:
    """Atomic checkpoint write; prunes old steps beyond ``keep``.

    Under a ``mesh`` every rank calls it with its own ``tree`` and the
    tree's ``specs``: each split leaf is gathered whole, rank 0 writes,
    and every rank returns once the step is committed."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    if mesh is not None:
        import torch.distributed as dist
        spec_of = _named_specs(specs, mesh)
        writer = dist.get_rank() == 0
        arrays = {}
        for k, v in _flatten_with_paths(tree):
            whole = _whole(v, spec_of[k])
            if writer:
                arrays[k] = _to_numpy(whole)
        if writer:
            _write(ckpt_dir, step_dir, step, arrays, keep)
        dist.barrier()
        return step_dir
    arrays = {k: _to_numpy(v) for k, v in _flatten_with_paths(tree)}
    _write(ckpt_dir, step_dir, step, arrays, keep, host_id)
    return step_dir


def _write(ckpt_dir: str, step_dir: str, step: int,
           arrays: Dict[str, np.ndarray], keep: int,
           host_id: int = 0) -> None:
    tmp_dir = step_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
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


def _read(ckpt_dir: str, step: int, template, host_id: int,
          validate: bool) -> Dict[str, np.ndarray]:
    """The step's arrays by path, each checked against ``template``'s
    leaf shape."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(step_dir, f"shard_{host_id}.npz")) as z:
        arrays = {k.replace("|", "/"): z[k] for k in z.files}
    if validate:
        _validate(step_dir, arrays)
    for key, leaf in _flatten_with_paths(template):
        if key not in arrays:
            raise KeyError(f"checkpoint missing array {key!r}")
        want = tuple(leaf.shape)
        if tuple(arrays[key].shape) != want:
            raise ValueError(f"{key}: ckpt shape {arrays[key].shape} != "
                             f"{want}")
    return arrays


def restore(ckpt_dir: str, step: int, template, host_id: int = 0,
            validate: bool = True):
    """Fill ``template``'s leaves from the checkpoint (by path)."""
    arrays = _read(ckpt_dir, step, template, host_id, validate)
    return _unflatten(template, {
        key: _to_tensor(arrays[key], leaf)
        for key, leaf in _flatten_with_paths(template)})


def elastic_restore(ckpt_dir: str, step: int, template, spec_tree=None,
                    mesh=None, host_id: int = 0, validate: bool = True):
    """Restore onto a (possibly different) mesh: the arrays are stored
    whole, so moving from a (2, 2) mesh to (1, 4), (4, 1) or one device
    places them anew.  ``template`` has the WHOLE leaves (meta tensors
    do: :func:`repro_torch.sharding.rules.whole_like`); with a ``mesh``
    each leaf is read on the host and its block under ``spec_tree`` (a
    tree shaped like ``template``) is copied to ``mesh.device``, with no
    collective; without one, this is :func:`restore`."""
    if mesh is None:
        return restore(ckpt_dir, step, template, host_id, validate)
    arrays = _read(ckpt_dir, step, template, host_id, validate)
    spec_of = _named_specs(spec_tree, mesh)
    return _unflatten(template, {
        key: spec_of[key].place(_to_tensor(arrays[key], leaf, device="cpu"))
        for key, leaf in _flatten_with_paths(template)})


def restore_latest(ckpt_dir: str, template, host_id: int = 0,
                   spec_tree=None, mesh=None):
    """(tree, step) from the newest *valid* committed checkpoint, through
    :func:`elastic_restore` (``template`` whole under a ``mesh``).

    Falls back to older checkpoints when the newest fails CRC/shape
    validation (a torn or bit-rotted write must not take the job down —
    that is the whole point of keeping ``keep`` > 1).
    Returns (None, -1) when nothing restorable exists.
    """
    for step in reversed(list_steps(ckpt_dir)):
        try:
            return elastic_restore(ckpt_dir, step, template, spec_tree,
                                   mesh, host_id), step
        except Exception:                      # corrupt/torn: try older
            continue
    return None, -1
