"""Partition specs over named mesh axes, and artifact placement.

A spec is a tuple with one entry per dimension of a leaf: an axis name,
a tuple of axis names, or None (not split) — what a JAX
``PartitionSpec`` holds, and ``()`` replicates.  Spec trees are dicts
and lists of specs (a tuple is always a spec, never a container).

From the JAX package's ``sharding/rules.py``: the generic helpers,
the placement of the quantized and retrieval serving artifacts —
O(vocab) and O(corpus) leaves row-sharded over ``model``, everything
else replicated — and the recsys training rules (params, adagrad state,
batch).  ``shard_*_artifact`` and :func:`place` return THIS rank's
tree: each row-sharded leaf is its block, copied to the rank's device
on its own, so no rank holds a whole table on its device.  The LM and
GNN parameter rules, ZeRO-1 and FSDP are still to port (ROADMAP §1
item 8).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, List, Tuple

import torch


def dp_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def _pad_spec(spec: Tuple, ndim: int) -> Tuple:
    """Left-pad a trailing-dims spec with None up to ndim."""
    pad = ndim - len(spec)
    if pad < 0:
        raise ValueError(f"spec {spec} longer than ndim={ndim}")
    return (None,) * pad + tuple(spec)


def _map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists ("a/b/0"
    paths); tuples are leaves (they are specs)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def _zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree, which must have
    the same dict keys and list lengths."""
    if isinstance(tree, dict):
        if not isinstance(specs, dict) or set(tree) != set(specs):
            raise ValueError(f"artifact keys {sorted(tree)} do not match "
                             f"its spec tree {specs}")
        return {k: _zip_map(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        if not isinstance(specs, list) or len(specs) != len(tree):
            raise ValueError(f"{len(tree)} artifact leaves do not match "
                             f"the spec {specs}")
        return [_zip_map(fn, t, s) for t, s in zip(tree, specs)]
    return fn(tree, specs)


def spec_tree(template: Any,
              rules: List[Tuple[str, Callable[[Any], Tuple]]],
              default: Tuple = ()) -> Any:
    """A spec tree for ``template`` (a tree of tensors).

    rules: list of (regex matched against the leaf's full path,
    fn(leaf) -> trailing-dims spec tuple).  First match wins; leading
    dims are padded with None."""
    def assign(path, leaf):
        ndim = leaf.dim()
        for pattern, fn in rules:
            if re.search(pattern, path):
                return _pad_spec(tuple(fn(leaf)), ndim)
        return _pad_spec(tuple(default), ndim)

    return _map_with_path(assign, template)


@dataclasses.dataclass(frozen=True)
class NamedSpec:
    """A spec bound to a mesh (JAX's ``NamedSharding``): ``place`` cuts
    this rank's block of a whole tensor and puts it on the rank's
    device."""

    mesh: Any
    spec: Tuple

    def block(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``t`` (a view; no copy)."""
        for dim, axes in enumerate(self.spec):
            if axes is None:
                continue
            axes = (axes,) if isinstance(axes, str) else tuple(axes)
            n = math.prod(self.mesh.shape[a] for a in axes)
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of size {t.shape[dim]} does "
                                 f"not divide over {axes} = {n}")
            idx = 0
            for a in axes:
                idx = idx * self.mesh.shape[a] + self.mesh.axis_index(a)
            size = t.shape[dim] // n
            t = t.narrow(dim, idx * size, size)
        return t

    def place(self, t) -> torch.Tensor:
        t = torch.as_tensor(t)
        if not any(a is not None for a in self.spec):
            return t.to(self.mesh.device)
        # a copy of the block alone, even on the same device: the whole
        # tensor's storage is not kept alive through a view
        return self.block(t).to(self.mesh.device, copy=True)


def spec_leaves(specs) -> list:
    """A spec tree's specs in the order ``tree_leaves`` gives its tree's
    leaves (dict keys sorted; a tuple is a spec, not a container)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for v in specs for x in spec_leaves(v)]
    return [specs]


def splits(spec: Tuple, mesh) -> bool:
    """Whether a leaf placed by ``spec`` over ``mesh`` is cut into
    blocks: some dim names axes of more than one rank (a spec over an
    axis of size 1 places the whole leaf, as GSPMD does)."""
    for axes in spec:
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if math.prod(mesh.shape[a] for a in axes) > 1:
            return True
    return False


def named(mesh, spec_tree_):
    """Every spec of the tree bound to ``mesh`` (None replicates)."""
    return _map_with_path(
        lambda _, s: NamedSpec(mesh, () if s is None else tuple(s)),
        spec_tree_)


def place(tree, specs, mesh):
    """This rank's ``tree`` (a tree of whole tensors, on any device): each
    leaf's block under its spec, copied to ``mesh.device``."""
    return _zip_map(lambda t, ns: ns.place(t), tree, named(mesh, specs))


def _replicated(specs):
    return _map_with_path(lambda _, s: (), specs)


def _divides(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


# ----------------------------------------------------------------------
# recsys training
# ----------------------------------------------------------------------

def recsys_param_rules(cfg, mesh) -> List:
    """The JAX package's rules, verbatim: every ``emb$`` table of at
    least 16·model rows that divide over ``model`` row-sharded —
    deepfm's dim-1 ``first_order`` tables, the small fields and bst's
    ``pos_emb`` included, whatever their config's ``sharded_rows`` —
    lrf's ``u`` and code tables alike; codebooks and the dense layers
    replicated.  A table these rules split is read through the sharded
    row gather (``core/dpq.py::row_gather``)."""
    model = mesh.shape["model"]

    def table_spec(leaf):
        if leaf.shape[0] >= 16 * model and _divides(leaf.shape[0], model):
            return ("model", None)
        return (None, None)

    return [
        (r"emb$", table_spec),                 # full tables + dpq/mgqe emb
        (r"centroids", lambda l: ()),
        (r"codes$", lambda l: table_spec(l)),
        (r"/u$", table_spec),                  # lrf rows
        (r"pos_emb$", lambda l: ()),
        (r"mlp|tower|w_out|blocks|layers|router", lambda l: ()),
    ]


def recsys_batch_spec(batch_dict_template, multi_pod: bool) -> Any:
    """Every batch leaf split over the data axes along its first dim (one
    axis by its name, as ``PartitionSpec`` normalises a 1-tuple); a 0-d
    leaf replicated."""
    dp = dp_axes(multi_pod)
    dp = dp[0] if len(dp) == 1 else dp
    return _map_with_path(
        lambda _, t: () if t.dim() == 0 else (dp,) + (None,) * (t.dim() - 1),
        batch_dict_template)


def recsys_state_specs(params_template, cfg, mesh):
    """(param specs, adagrad state specs): the state is ``{"step": (),
    "acc": param specs}``, as the JAX package's recsys train cell
    shards it (the accumulators mirror the params)."""
    p_spec = spec_tree(params_template, recsys_param_rules(cfg, mesh))
    return p_spec, {"step": (), "acc": p_spec}


def whole_like(tree, specs, mesh):
    """Meta-device tensors of the whole leaves whose blocks ``tree``
    holds under ``specs`` (each split dim times its axes' ranks): the
    template a checkpoint of whole arrays restores against."""
    def whole(t, spec):
        shape = list(t.shape)
        for dim, axes in enumerate(_pad_spec(tuple(spec), t.dim())):
            if axes is not None:
                axes = (axes,) if isinstance(axes, str) else tuple(axes)
                shape[dim] *= math.prod(mesh.shape[a] for a in axes)
        return torch.empty(shape, dtype=t.dtype, device="meta")
    return _zip_map(whole, tree, specs)


# ----------------------------------------------------------------------
# quantized serving artifacts
# ----------------------------------------------------------------------

def quantized_artifact_specs(cfg, model_axis: str = "model"):
    """Spec tree of a quantized serving artifact, derived from the
    scheme's own artifact spec (``Scheme.artifact_shard_specs``): code
    tables (``rows`` leaves, the only O(vocab) ones) row-sharded over
    ``model_axis``; codebooks and the hot-row block replicated."""
    from repro_torch.core.schemes import get_scheme
    return get_scheme(cfg).artifact_shard_specs(model_axis=model_axis)


def shard_quantized_artifact(artifact, cfg, mesh, model_axis: str = "model"):
    """This rank's artifact: its block of ``V / model_n`` rows of every
    code table, each copied to the rank's device on its own, and the
    rest replicated there.  ``artifact`` may lie on the host or on any
    device.  A vocabulary that does not divide, or a mesh without
    ``model_axis``, keeps every leaf whole (the gather's single-device
    route serves it)."""
    specs = quantized_artifact_specs(cfg, model_axis=model_axis)
    if model_axis not in mesh.shape or cfg.vocab_size % mesh.shape[
            model_axis]:
        specs = _replicated(specs)
    return place(artifact, specs, mesh)


# ----------------------------------------------------------------------
# retrieval index artifacts
# ----------------------------------------------------------------------

def retrieval_artifact_specs(index, artifact, model_axis: str = "model"):
    """Spec dict of a retrieval index artifact (``Index.artifact_shard_
    specs``): the O(corpus) ``rows_leaves`` (flat codes; IVF's bounded
    list tables, spill lists included) row-sharded over ``model_axis``;
    codebooks, the coarse table and the O(nlist) ``list_chain`` —
    which every shard needs whole to expand a probed cell — replicated."""
    return index.artifact_shard_specs(artifact, model_axis=model_axis)


def shard_retrieval_artifact(artifact, index, mesh,
                             model_axis: str = "model"):
    """This rank's index artifact: its block of every rows leaf, copied
    to the rank's device on its own, the rest replicated.  Rows that do
    not divide over ``model_axis`` raise; a mesh without ``model_axis``
    keeps every leaf whole (``sharded_topk``'s single-device route)."""
    specs = retrieval_artifact_specs(index, artifact, model_axis=model_axis)
    if model_axis not in mesh.shape:
        return place(artifact, _replicated(specs), mesh)
    model_n = mesh.shape[model_axis]
    bad = {name: artifact[name].shape[0] for name in index.rows_leaves
           if artifact[name].shape[0] % model_n}
    if bad:
        raise ValueError(f"corpus rows {bad} do not divide over "
                         f"{model_axis}={model_n}")
    return place(artifact, specs, mesh)


__all__ = ["NamedSpec", "dp_axes", "named", "place",
           "quantized_artifact_specs", "recsys_batch_spec",
           "recsys_param_rules", "recsys_state_specs",
           "retrieval_artifact_specs", "shard_quantized_artifact",
           "shard_retrieval_artifact", "spec_leaves", "spec_tree", "splits",
           "whole_like"]
