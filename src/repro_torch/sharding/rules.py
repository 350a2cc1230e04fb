"""Partition specs over named mesh axes, and artifact placement.

A spec is a tuple with one entry per dimension of a leaf: an axis name,
a tuple of axis names, or None (not split) — what a JAX
``PartitionSpec`` holds, and ``()`` replicates.  Spec trees are dicts
and lists of specs (a tuple is always a spec, never a container).

From the JAX package's ``sharding/rules.py``: the generic helpers,
the placement of the quantized and retrieval serving artifacts —
O(vocab) and O(corpus) leaves row-sharded over ``model``, everything
else replicated — and the recsys training rules (params, adagrad state,
batch), and the LM rules: tensor parallelism over ``model``, the
batch over the data axes, ZeRO-1 moments and optional FSDP
(:func:`lm_param_rules`, :func:`lm_state_specs`, :func:`lm_batch_spec`),
and for LM serving the KV cache's placement (:func:`lm_cache_spec`),
the served token table's (:func:`lm_artifact_specs`) and the served
params (:func:`strip_embed_table`); the recsys serving cell's artifact
placement (:func:`recsys_artifact_specs`); and MACE's rules, channels
over ``model`` (:func:`gnn_param_rules`, :func:`gnn_graph_spec`).
``shard_*_artifact`` and :func:`place` return THIS rank's tree: each
split leaf is its block, copied to the rank's device on its own, so no
rank holds a whole table on its device.

Where GSPMD pads a split that does not divide, the port refuses it
(:func:`check_lm_leaf`, as ``launch/cells.py::lm_train_cell`` places
each leaf): a rank holds plain blocks of one size.
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


def map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists ("a/b/0"
    paths); tuples are leaves (they are specs)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree, which must have
    the same dict keys and list lengths."""
    if isinstance(tree, dict):
        if not isinstance(specs, dict) or set(tree) != set(specs):
            raise ValueError(f"artifact keys {sorted(tree)} do not match "
                             f"its spec tree {specs}")
        return {k: zip_map(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        if not isinstance(specs, list) or len(specs) != len(tree):
            raise ValueError(f"{len(tree)} artifact leaves do not match "
                             f"the spec {specs}")
        return [zip_map(fn, t, s) for t, s in zip(tree, specs)]
    return fn(tree, specs)


def leaf_spec(path: str, leaf, rules: List[Tuple[str, Callable]],
              default: Tuple = ()) -> Tuple:
    """The spec of one leaf at ``path`` (a tensor, or anything with its
    ``shape`` and ``dim()``): the first rule whose regex matches the
    path, leading dims padded with None."""
    for pattern, fn in rules:
        if re.search(pattern, path):
            return _pad_spec(tuple(fn(leaf)), leaf.dim())
    return _pad_spec(tuple(default), leaf.dim())


def spec_tree(template: Any,
              rules: List[Tuple[str, Callable[[Any], Tuple]]],
              default: Tuple = ()) -> Any:
    """A spec tree for ``template`` (a tree of tensors).

    rules: list of (regex matched against the leaf's full path,
    fn(leaf) -> trailing-dims spec tuple).  First match wins; leading
    dims are padded with None."""
    return map_with_path(lambda path, leaf: leaf_spec(path, leaf, rules,
                                                       default), template)


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


def split_axes(spec: Tuple, mesh) -> Tuple[str, ...]:
    """The axes of more than one rank that ``spec`` cuts a leaf over, in
    mesh order (a spec over an axis of size 1 places the whole leaf, as
    GSPMD does)."""
    named = set()
    for axes in spec:
        if axes is not None:
            named.update((axes,) if isinstance(axes, str) else axes)
    return tuple(a for a in mesh.shape if a in named and mesh.shape[a] > 1)


def splits(spec: Tuple, mesh) -> bool:
    """Whether a leaf placed by ``spec`` over ``mesh`` is cut into
    blocks: some dim names axes of more than one rank."""
    return bool(split_axes(spec, mesh))


def named(mesh, spec_tree_):
    """Every spec of the tree bound to ``mesh`` (None replicates)."""
    return map_with_path(
        lambda _, s: NamedSpec(mesh, () if s is None else tuple(s)),
        spec_tree_)


def place(tree, specs, mesh):
    """This rank's ``tree`` (a tree of whole tensors, on any device): each
    leaf's block under its spec, copied to ``mesh.device``."""
    return zip_map(lambda t, ns: ns.place(t), tree, named(mesh, specs))


def _replicated(specs):
    return map_with_path(lambda _, s: (), specs)


def _divides(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


# ----------------------------------------------------------------------
# LM training
# ----------------------------------------------------------------------

def lm_param_rules(cfg, mesh) -> List:
    """The JAX package's LM rules, verbatim: attention projections, the
    FFN hidden dim, the experts (or their d_ff when the experts do not
    divide over ``model``), the vocab rows and ``lm_head``'s columns over
    ``model``; under ``cfg.fsdp_params`` the layer weights also over
    ``data`` on one more dim where it divides; ``wk``/``wv`` whole under
    ``attn_kv_repeat`` (the layer expands them to every head) or when
    their columns do not divide; norms, router and centroids
    replicated.  Each rule gives the trailing dims' spec; the layer
    stacks' leading dims (``layers``, ``loc``/``glob``/``rem``) are
    padded with None."""
    model = mesh.shape["model"]
    data = "data"
    fsdp = cfg.fsdp_params

    def maybe_fsdp(spec: Tuple, leaf, fsdp_dim: int) -> Tuple:
        """Add data-axis sharding on dim ``fsdp_dim`` (within trailing
        spec) when FSDP is on and the dim divides."""
        if not fsdp:
            return spec
        spec = list(spec)
        if spec[fsdp_dim] is None and _divides(
                leaf.shape[leaf.dim() - len(spec) + fsdp_dim],
                mesh.shape["data"]):
            spec[fsdp_dim] = data
        return tuple(spec)

    def expert_spec(leaf, transpose: bool):
        # (E, d, f) or (E, f, d): shard E if divisible, else the ff dim
        e = leaf.shape[-3]
        if _divides(e, model):
            return maybe_fsdp(("model", None, None), leaf, 1)
        if transpose:                 # (E, f, d)
            return (None, "model", None)
        return (None, None, "model")  # (E, d, f)

    return [
        # embedding tables: rows over model
        (r"embed/emb$", lambda l: ("model", None)),
        (r"embed/centroids", lambda l: (None, None, None)),
        (r"embed/u$", lambda l: ("model", None)),
        (r"embed/v$", lambda l: (None, None)),
        # attention
        (r"/wq$", lambda l: maybe_fsdp((None, "model"), l, 0)),
        # kv-repeat mode: K/V are expanded to the full head count inside
        # the layer, so wk/wv stay replicated
        (r"/wk$|/wv$", lambda l: maybe_fsdp(
            (None, None) if cfg.attn_kv_repeat
            else ((None, "model") if _divides(l.shape[-1], model)
                  else (None, None)), l, 0)),
        (r"/wo$", lambda l: maybe_fsdp(("model", None), l, 1)),
        # dense FFN
        (r"ffn/w_gate$|ffn/w_up$", lambda l: maybe_fsdp((None, "model"), l,
                                                         0)),
        (r"ffn/w_down$", lambda l: maybe_fsdp(("model", None), l, 1)),
        # MoE
        (r"moe/router$", lambda l: (None, None)),
        (r"moe/w_gate$|moe/w_up$", lambda l: expert_spec(l, False)),
        (r"moe/w_down$", lambda l: expert_spec(l, True)),
        # head / norms
        (r"lm_head$", lambda l: (None, "model")),
        (r"ln|norm", lambda l: ()),
    ]


def zero1_spec(leaf, spec: Tuple, mesh) -> Tuple:
    """A moment's spec under ZeRO-1: its param's ``spec``, plus ``data``
    on the first dim that is free and divides over ``data`` unless the
    param already uses ``data`` (FSDP); a 0-d leaf replicated."""
    if leaf.dim() == 0:
        return ()
    parts = list(spec) + [None] * (leaf.dim() - len(spec))
    used = {a for a in parts if a is not None}
    if "data" in used:
        return tuple(parts)
    for i in range(leaf.dim()):
        if parts[i] is None and _divides(leaf.shape[i], mesh.shape["data"]):
            parts[i] = "data"
            break
    return tuple(parts)


def lm_state_specs(cfg, mesh, params_template, opt_template):
    """(param specs, optimizer-state specs), as the JAX package's
    ``lm_state_specs``: the params by :func:`lm_param_rules`; each
    moment tree (``m``, ``v``, ``acc``, ``mom``) by :func:`zero1_spec`
    of its param's; ``step`` and anything else replicated."""
    p_spec = spec_tree(params_template, lm_param_rules(cfg, mesh))
    o_spec = {}
    for k, v in opt_template.items():
        if k == "step":
            o_spec[k] = ()
        elif k in ("m", "v", "acc", "mom"):
            o_spec[k] = zip_map(lambda t, s: zero1_spec(t, s, mesh), v,
                                 p_spec)
        else:
            o_spec[k] = map_with_path(lambda _, t: (), v)
    return p_spec, o_spec


def lm_batch_spec(multi_pod: bool) -> dict:
    """``tokens`` and ``labels`` split over the data axes by row (one axis
    by its name, as ``PartitionSpec`` normalises a 1-tuple)."""
    dp = dp_axes(multi_pod)
    dp = dp[0] if len(dp) == 1 else dp
    return {"tokens": (dp, None), "labels": (dp, None)}


def check_lm_leaf(cfg, mesh, path: str, leaf, spec: Tuple) -> None:
    """Raise unless ``spec`` gives each rank of ``mesh`` a whole block of
    the leaf at ``path``: each split dim divides over its axes.  The
    message names the leaf, the axis and the sizes.  (GSPMD pads such a
    split; a rank here holds plain blocks.)  A split of ``wq``'s,
    ``wk``'s or ``wv``'s columns inside a head is allowed, training and
    serving alike: the layer gathers their columns over ``model``
    (``models/lm.py``)."""
    spec = _pad_spec(tuple(spec), leaf.dim())
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        n = math.prod(mesh.shape[a] for a in
                      ((axes,) if isinstance(axes, str) else axes))
        if leaf.shape[dim] % n:
            raise ValueError(
                f"{path}: dim {dim} of size {leaf.shape[dim]} does not "
                f"divide over {axes} = {n} (shape {tuple(leaf.shape)})")


# ----------------------------------------------------------------------
# LM serving
# ----------------------------------------------------------------------

def lm_cache_spec(cfg, batch: int, mesh, multi_pod: bool,
                  cache_template) -> dict:
    """The decode cache's specs, as the JAX package's ``lm_cache_spec``:
    the batch over the data axes when it divides, with the kv heads over
    ``model`` when they divide, else the cache's sequence over
    ``model``; a batch that does not divide (the B = 1 long-context
    cell) puts the sequence over the data axes where it divides, and the
    kv heads over ``model`` when they divide.  ``kpos`` (B, S) takes the
    batch or sequence rule alone.

    ``cache_template`` is a cache (``models/lm.py::make_cache``, on any
    device): ``{"pos": ..., stack: (k, v, kpos)}``.  Returns ``{"pos":
    (), stack: [k spec, v spec, kpos spec]}`` (a list: a tuple is a
    spec here)."""
    dp = dp_axes(multi_pod)
    dp_n = math.prod(mesh.shape[a] for a in dp)
    dp = dp[0] if len(dp) == 1 else dp
    kv_ok = _divides(cfg.num_kv_heads, mesh.shape["model"])
    b_ok = _divides(batch, dp_n)

    def assign(leaf, is_kv: bool) -> Tuple:
        ndim = leaf.dim()
        lead = ndim - (4 if is_kv else 2)
        parts = [None] * ndim
        if b_ok:
            parts[lead] = dp
            if is_kv:
                parts[lead + (2 if kv_ok else 1)] = "model"
        else:
            if _divides(leaf.shape[lead + 1], dp_n):
                parts[lead + 1] = dp
            if is_kv and kv_ok:
                parts[lead + 2] = "model"
        return tuple(parts)

    out = {}
    for name, leaves in cache_template.items():
        if name == "pos":
            out[name] = ()
        else:
            out[name] = [assign(t, i < 2) for i, t in enumerate(leaves)]
    return out


# the artifact leaves the JAX package's ``_lm_artifact_sharding`` puts
# over ``model``: the code table, a full-embedding baseline's table, an
# sq artifact's rows
_LM_ARTIFACT_ROWS = ("codes", "emb", "q")


def lm_artifact_specs(artifact) -> dict:
    """The served token table's specs (the JAX package's
    ``launch/cells.py::_lm_artifact_sharding``): its rows leaves over
    ``model``, every other leaf (centroids, a hot block) replicated.
    ``artifact``'s leaves may be tensors or numpy arrays."""
    def spec(t, rows: bool) -> Tuple:
        return ("model",) + (None,) * (len(t.shape) - 1) if rows else ()
    return {k: map_with_path(
        lambda _, t, rows=k in _LM_ARTIFACT_ROWS: spec(t, rows), v)
        for k, v in artifact.items()}


def strip_embed_table(params: dict) -> dict:
    """The served params (the JAX package's ``_strip_embed_table``): the
    token table dropped, its artifact serves the rows (Fig. 1); the
    embedding's other leaves (centroids) stay."""
    out = dict(params)
    out["embed"] = {k: v for k, v in params["embed"].items() if k != "emb"}
    return out


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
    return map_with_path(
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
    return zip_map(whole, tree, specs)


def recsys_artifact_specs(artifacts, mesh) -> Any:
    """The served CTR artifacts' specs, as the JAX package's
    ``recsys_serve_cell`` places them (its ``art_spec``): a leaf whose
    path ends in ``codes``, ``/q``, ``emb`` or ``/u`` split by rows over
    ``model`` when it has at least 16·model rows that divide over it,
    kept whole otherwise; every other leaf (centroids, a per-tier list
    of code tables, whose paths end in an index) replicated.
    ``artifacts``' leaves may be tensors or numpy arrays."""
    model = mesh.shape["model"]

    def spec(path, t):
        if path.endswith(("codes", "/q", "emb", "/u")) and \
                t.shape[0] >= 16 * model and _divides(t.shape[0], model):
            return ("model",) + (None,) * (len(t.shape) - 1)
        return ()
    return map_with_path(spec, artifacts)


# ----------------------------------------------------------------------
# GNN (MACE)
# ----------------------------------------------------------------------

def gnn_param_rules(cfg, mesh) -> List:
    """The JAX package's MACE rules, verbatim: the channels over
    ``model`` when ``d_hidden`` divides over it — ``species_emb``,
    ``feat_proj/w``, ``a_mix`` and ``m1``/``m2``/``m3`` on their output
    C, ``u2``/``u3`` on their C — else whole; the radial and readout
    MLPs replicated (``feat_proj/b`` too: no rule names it)."""
    ch = "model" if _divides(cfg.d_hidden, mesh.shape["model"]) else None
    return [
        (r"species_emb$", lambda l: (None, ch)),
        (r"feat_proj/w$", lambda l: (None, ch)),
        (r"radial/.*w$", lambda l: ()),
        (r"a_mix$|m1$|m2$|m3$", lambda l: (None, ch)),
        (r"u2$|u3$", lambda l: (ch, None)),
        (r"readout", lambda l: ()),
    ]


def gnn_graph_spec(multi_pod: bool) -> dict:
    """The JAX package's ``gnn_graph_spec``: node leaves and the edge
    index's edges over the data axes (one axis by its name, as
    ``PartitionSpec`` normalises a 1-tuple), ``energy`` replicated and
    ``n_graphs`` (a Python int) not placed.  (``launch/cells.py::
    mace_cell`` puts the nodes and edges over every axis instead, as the
    JAX cell does.)"""
    dp = dp_axes(multi_pod)
    dp = dp[0] if len(dp) == 1 else dp
    return {"positions": (dp, None), "species": (dp,),
            "node_feats": (dp, None), "edge_index": (None, dp),
            "graph_id": (dp,), "labels": (dp,), "energy": (), "n_graphs": None}


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


__all__ = ["NamedSpec", "check_lm_leaf", "dp_axes", "gnn_graph_spec",
           "gnn_param_rules", "leaf_spec", "lm_artifact_specs",
           "lm_batch_spec", "lm_cache_spec", "map_with_path", "zip_map",
           "lm_param_rules", "lm_state_specs", "named", "place",
           "quantized_artifact_specs", "recsys_artifact_specs",
           "recsys_batch_spec", "recsys_param_rules", "recsys_state_specs",
           "retrieval_artifact_specs", "shard_quantized_artifact",
           "shard_retrieval_artifact", "spec_leaves", "spec_tree",
           "split_axes", "splits", "strip_embed_table",
           "whole_like", "zero1_spec"]
