"""The cells of the JAX package's ``launch/cells.py``, each written out
as one rank's explicit share on the port's ``Mesh`` (one process a
rank, explicit collectives): the recsys train, serve and retrieval
cells, the LM train, prefill and decode cells and MACE's train cell;
with them the recsys model registry (``RecsysConfig.model`` -> model
class), the LM config options (``LM_CFG_OPTS``), MACE's FLOP model and
shape resolution, and the batch of a sampled subgraph
(``sampled_graph``, the port's own); and the JAX module's dry-run
surface, :class:`Cell` and :func:`build_cell` with every named option,
over those cells: on an ``AbstractMesh`` (``launch/mesh.py``) a cell is
built on the meta device — params, optimizer state, exports and
batches as meta tensors of one rank's shapes, nothing drawn — and its
step traced by ``launch/dryrun.py``.

The recsys and LM train cells hold one convention: each rank
backpropagates its data shard's loss weighted B_local/B_global, the
loss computed redundantly on every rank of ``model``; a gradient that
comes out as a data shard's share is summed over the data axes, one
that a collective's backward already summed (a row block read through
the sharded gather, an FSDP leaf's reduce-scatter) is kept.  The new
cells hold two more: a serving cell's batch is a data shard (the ranks
of a model line serve the same rows, each from its block of the tables
or codes); a MACE rank's nodes and edges are a contiguous block over
every axis, and every rank backpropagates the global loss
(:class:`MaceTrainCell`).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import (GNNConfig, LMConfig, RecsysConfig,
                                      ShapeSpec)
from repro_torch.data.graph import sampled_subgraph_sizes
from repro_torch.models.gnn import so3
from repro_torch.models.recsys.autoint import AutoInt
from repro_torch.models.recsys.bst import BST
from repro_torch.models.recsys.deepfm import DeepFM
from repro_torch.models.recsys.two_tower import TwoTower
from repro_torch.nn.initializers import generator

_RECSYS_MODELS = {"autoint": AutoInt, "deepfm": DeepFM,
                  "two_tower": TwoTower, "bst": BST}


def recsys_model(cfg: RecsysConfig, device="cuda"):
    """The model of ``cfg.model`` on ``device`` (default: the card)."""
    try:
        cls = _RECSYS_MODELS[cfg.model]
    except KeyError:
        raise ValueError(f"unknown recsys model {cfg.model!r}; known: "
                         f"{', '.join(sorted(_RECSYS_MODELS))}") from None
    return cls(cfg, device=device)


def recsys_tables(model, batch) -> list:
    """(path, Embedding, ids) of every table a recsys model's forward
    reads, with the ids it looks up in ``batch``: a field of deepfm or
    autoint at ``("fields", "f<i>")`` (column i of ``sparse_ids``),
    two-tower's ``("user_emb",)`` and ``("item_emb",)``, bst's
    ``("item_emb",)`` over the history and the target (``BST.ids``).
    ``path`` leads to the table's params; ``serve_ctr`` exports the
    subtree ``params[path[0]]``, so ``path[1:]`` leads to its artifact."""
    if model.cfg.model == "two_tower":
        return [(("user_emb",), model.user_emb, batch["user_ids"]),
                (("item_emb",), model.item_emb, batch["item_ids"])]
    if model.cfg.model == "bst":
        return [(("item_emb",), model.item_emb, model.ids(batch))]
    return [(("fields", f"f{i}"), e, batch["sparse_ids"][:, i])
            for i, e in enumerate(model.fields.embs)]


# ======================================================================
# the recsys train cell on a mesh
# ======================================================================

@dataclasses.dataclass
class RecsysTrainCell:
    """One rank's share of a recsys model trained with adagrad on a
    mesh: what the JAX package runs as ``jax.jit(recsys_train_cell(...)
    .fn, in_shardings=...)``, written out as one rank's explicit step.

    ``state`` is this rank's, placed by ``specs`` (a ``TrainState`` of
    the recsys rules' spec trees); ``split`` marks the param leaves the
    placement cuts into row blocks over ``model``."""

    model: Any
    mesh: Any
    state: Any
    specs: Any
    split: List[bool]
    multi_pod: bool = False

    @property
    def data_shards(self) -> int:
        from repro_torch.sharding.gather import data_shards
        return data_shards(self.mesh, "model")

    def local_batch(self, batch: Dict) -> Dict:
        """This rank's data shard of a global batch (every rank draws the
        same stream): each leaf's block under ``recsys_batch_spec``; a
        batch that does not divide over the data axes raises."""
        from repro_torch.sharding.rules import named, recsys_batch_spec
        specs = named(self.mesh, recsys_batch_spec(batch, self.multi_pod))
        return {k: specs[k].block(v) for k, v in batch.items()}

    def grads(self, state, batch: Dict) -> Tuple[Any, Dict]:
        """This rank's share of the global batch's gradients and metrics,
        before any reduction: autograd of ``loss_local · B_local /
        B_global``.  The weight is the point: under the JAX package's
        GSPMD step the cotangent reaching the row gather is that of the
        GLOBAL mean, and the gather's backward sums the data shards'
        cotangents (an all-gather of ``dout``), so a rank that
        backpropagated its local mean would hand each row block
        ``data_shards`` times its true gradient."""
        from repro_torch.train.optimizer import loss_grads
        w = 1.0 / self.data_shards

        def weighted(params, batch):
            loss, metrics = self.model.loss(params, batch, mesh=self.mesh)
            return loss * w, {k: v * w for k, v in metrics.items()}

        return loss_grads(weighted, state.params, batch)

    def reduce(self, grads, metrics: Dict) -> Tuple[Any, Dict]:
        """The global batch's gradients and metrics from this rank's
        shares: a replicated leaf's gradient (and every metric) summed —
        not averaged, the weights already did — over the data axes, in
        one collective; a row block's gradient is already whole (the
        gather's backward gathered ``dout``) and is kept."""
        from repro_torch.core.schemes.base import tree_leaves
        from repro_torch.sharding.collectives import psum
        from repro_torch.sharding.gather import data_axes_of
        axes = data_axes_of(self.mesh, "model")
        reps = [g for g, cut in zip(tree_leaves(grads), self.split)
                if not cut]
        names = list(metrics)
        flat = torch.cat([g.reshape(-1).float() for g in reps]
                         + [metrics[k].reshape(1).float() for k in names])
        flat = psum(flat, self.mesh, axes)
        at = 0
        for g in reps:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        return grads, {k: flat[at + i] for i, k in enumerate(names)}

    def step(self, state, batch: Dict) -> Tuple[Any, Dict]:
        """One adagrad step on this rank's data shard ``batch``: its
        gradient shares, reduced (:meth:`reduce`), clipped by the global
        norm (a row block's squares summed over ``model``) and applied
        leaf by leaf to this rank's blocks; the metrics are the global
        batch's."""
        from repro_torch.launch.train import RECSYS_OPTIMIZER
        from repro_torch.train.optimizer import TrainState, apply_updates
        grads, metrics = self.reduce(*self.grads(state, batch))
        params, opt_state = apply_updates(
            RECSYS_OPTIMIZER, state.params, grads, state.opt_state,
            mesh=self.mesh, specs=self.specs.params)
        return TrainState(params, opt_state), metrics


def recsys_train_cell(cfg: RecsysConfig, mesh, params=None,
                      multi_pod: bool = False) -> RecsysTrainCell:
    """This rank's :class:`RecsysTrainCell` of ``cfg`` on ``mesh``:
    ``params`` (whole, on any device; default: drawn as
    ``launch/train.py::recsys_setup`` draws them, from a generator
    seeded 0 on the rank's device) placed by ``recsys_param_rules``,
    and adagrad's state (``RECSYS_OPTIMIZER``) on the blocks.  Every
    table the rules row-shard is read through the sharded row gather
    (``core/dpq.py::row_gather``)."""
    from repro_torch.launch.train import RECSYS_OPTIMIZER
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.sharding.rules import (place, recsys_state_specs,
                                            spec_leaves, splits)
    from repro_torch.train.optimizer import TrainState
    from repro_torch.train.optimizer import init as opt_init
    model = recsys_model(cfg, device=mesh.device)
    if params is None:
        params = model.init(generator(mesh.device, 0))
    p_spec, o_spec = recsys_state_specs(params, cfg, mesh)
    placed = place(params, p_spec, mesh)
    del params
    split = [splits(sp, mesh) for sp in spec_leaves(p_spec)]
    if len(split) != len(tree_leaves(placed)):
        raise ValueError("the spec tree does not mirror the params")
    state = TrainState(placed, opt_init(RECSYS_OPTIMIZER, placed))
    return RecsysTrainCell(model, mesh, state, TrainState(p_spec, o_spec),
                           split, multi_pod)


# ======================================================================
# the LM train cell on a mesh
# ======================================================================

# the JAX package's named LM options (``_LM_CFG_OPTS``, as
# ``launch/dryrun.py`` passes them)
LM_CFG_OPTS = {
    "moe_shard_map": dict(moe_shard_map=True),
    "remat_group": dict(remat_granularity="group"),
    "split_cache": dict(split_local_global_cache=True),
    "xent_chunk_256": dict(xent_chunk=256),
    "attn_block_2048": dict(attention_block=2048),
    "fsdp": dict(fsdp_params=True),
    "kv_repeat": dict(attn_kv_repeat=True),
}


def lm_cfg_with_opts(cfg: LMConfig, opts) -> LMConfig:
    """``cfg`` with each named option of ``LM_CFG_OPTS`` applied."""
    for o in opts:
        if o not in LM_CFG_OPTS:
            raise ValueError(f"unknown LM opt {o!r}; known: "
                             f"{', '.join(LM_CFG_OPTS)}")
        cfg = dataclasses.replace(cfg, **LM_CFG_OPTS[o])
    return cfg


def _tree_paths(tree, path="") -> list:
    """(path, leaf) of a tree of dicts and lists, in ``tree_leaves``
    order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _tree_paths(tree[k], f"{path}/{k}" if path else k)]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _tree_paths(v, f"{path}/{i}")]
    return [(path, tree)]


@dataclasses.dataclass
class LMTrainCell:
    """One rank's share of an LM trained with adam(w) on a mesh: the JAX
    package's ``lm_train_cell`` (a ``jax.jit`` step under GSPMD),
    written out as one rank's explicit step.

    ``state`` is this rank's: the params placed by ``lm_param_rules``,
    the moments by ZeRO-1 (``specs``, a ``TrainState`` of the spec
    trees).  ``reduced`` marks the param leaves whose gradient is a data
    shard's share, summed over the data axes; the others (FSDP leaves,
    the embedding's row blocks) come out of the backward whole."""

    cfg: LMConfig
    mesh: Any
    state: Any
    specs: Any
    reduced: List[bool]
    optimizer: Any
    microbatches: int = 1

    @property
    def data_axes(self) -> tuple:
        from repro_torch.sharding.gather import data_axes_of
        return data_axes_of(self.mesh, "model")

    @property
    def data_shards(self) -> int:
        from repro_torch.sharding.gather import data_shards
        return data_shards(self.mesh, "model")

    def local_batch(self, batch: Dict) -> Dict:
        """This rank's rows of a global batch (every rank draws the same
        stream): with one microbatch its block under ``lm_batch_spec``;
        with ``m`` that block of each of the global batch's ``m`` row
        blocks, in order (microbatch i is global rows i·B/m onward, as
        the JAX cell splits it).  A batch that does not divide over the
        data axes raises: the JAX cell would split its sequence over them,
        a training branch no registry cell takes (``long_500k``'s B = 1
        is a decode cell's, :class:`LMDecodeCell`)."""
        from repro_torch.sharding.rules import lm_batch_spec, named
        m, n = self.microbatches, self.data_shards
        b = batch["tokens"].shape[0]
        if b % (m * n):
            raise ValueError(
                f"a global batch of {b} rows does not divide into "
                f"{m} microbatch(es) over {n} data shard(s) (mesh "
                f"{self.mesh.shape}); the JAX cell would split its sequence "
                f"over the data axes, which the port's training step does "
                f"not (long_500k's B = 1 is a decode cell's)")
        specs = named(self.mesh, lm_batch_spec("pod" in self.mesh.shape))
        return {k: torch.cat([specs[k].block(v.reshape(
            (m, b // m) + v.shape[1:])[i]) for i in range(m)])
            for k, v in batch.items()}

    def grads(self, state, batch: Dict) -> Tuple[Any, Dict]:
        """This rank's share of the batch's gradients and metrics, before
        any reduction: autograd of ``loss_local · B_local / B_global``
        (the row gather's and the FSDP gathers' backward sum the data
        shards' cotangents, so a rank that backpropagated its local mean
        would hand them ``data_shards`` times their gradient)."""
        from repro_torch.models import lm
        from repro_torch.train.optimizer import loss_grads
        w = 1.0 / self.data_shards

        def weighted(params, batch):
            loss, metrics = lm.loss_fn(params, batch, self.cfg,
                                       mesh=self.mesh)
            return loss * w, {k: v * w for k, v in metrics.items()}

        return loss_grads(weighted, state.params, batch)

    def reduce(self, grads) -> list:
        """The gradient leaves as the moments are placed: each share that
        ``reduced`` marks summed over the data axes (a bfloat16 one in
        float32, rounded once), then each leaf's block under ZeRO-1
        (``optimizer.zero1_cut``)."""
        from repro_torch.core.schemes.base import tree_leaves
        from repro_torch.sharding.collectives import block, psum
        from repro_torch.sharding.rules import spec_leaves
        from repro_torch.train.optimizer import zero1_cut
        out = []
        for g, red, ps, ms in zip(
                tree_leaves(grads), self.reduced,
                spec_leaves(self.specs.params),
                spec_leaves(self.specs.opt_state["m"]), strict=True):
            if red and self.data_shards > 1:
                g = psum(g, self.mesh, self.data_axes)
            cut = zero1_cut(ps, ms, self.mesh)
            out.append(g if cut is None else
                       block(g, self.mesh, cut[1], cut[0]))
        return out

    def accumulate(self, state, batch: Dict) -> Tuple[list, Dict]:
        """The step's gradients on this rank's rows ``batch``
        (:meth:`local_batch`) as the moments are placed, and the global
        batch's metrics: per microbatch, its gradient shares reduced and
        cut to the moments' blocks (:meth:`reduce`), accumulated in
        float32 and divided by the microbatches, as the JAX cell's scan
        does."""
        from repro_torch.sharding.collectives import psum
        m = self.microbatches
        rows = batch["tokens"].shape[0] // m
        acc, sums = None, None
        for i in range(m):
            part = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            grads, metrics = self.grads(state, part)
            blocks = self.reduce(grads)
            del grads
            if m == 1:
                acc, sums = blocks, metrics
                break
            if acc is None:
                acc = [torch.zeros(g.shape, dtype=torch.float32,
                                   device=g.device) for g in blocks]
                sums = {k: torch.zeros_like(v) for k, v in metrics.items()}
            for a, g in zip(acc, blocks):
                a.add_(g)
            sums = {k: sums[k] + v for k, v in metrics.items()}
        if m > 1:
            for a in acc:
                a.div_(m)
        names = list(sums)
        flat = psum(torch.stack([sums[k].float() for k in names]),
                    self.mesh, self.data_axes) / m
        return acc, {k: flat[i] for i, k in enumerate(names)}

    def update(self, state, grads: list) -> Any:
        """The optimizer's step on :meth:`accumulate`'s gradients (which
        it consumes), in place (``apply_updates_zero1``)."""
        from repro_torch.train.optimizer import (TrainState,
                                                 apply_updates_zero1)
        params, opt_state = apply_updates_zero1(
            self.optimizer, state.params, grads, state.opt_state, self.mesh,
            self.specs.params, self.specs.opt_state["m"])
        return TrainState(params, opt_state)

    def step(self, state, batch: Dict) -> Tuple[Any, Dict]:
        """One optimizer step on this rank's rows ``batch``: its
        accumulated gradients (:meth:`accumulate`) and one update
        (:meth:`update`).  The metrics are the global batch's."""
        grads, metrics = self.accumulate(state, batch)
        return self.update(state, grads), metrics


def lm_train_cell(cfg: LMConfig, mesh, microbatches: int = 1, params=None,
                  optimizer=None) -> LMTrainCell:
    """This rank's :class:`LMTrainCell` of ``cfg`` on ``mesh``.

    ``params`` (whole, on any device; default: drawn as
    ``launch/train.py::lm_setup`` draws them, from a generator seeded 0
    on the rank's device, each leaf placed as soon as it is drawn) are
    placed by ``lm_param_rules``, adam's state (zeros) by
    ``lm_state_specs``; ``convert.lm_state_from_numpy`` places a whole
    state (a checkpoint restore places one too).  ``optimizer`` defaults
    to the JAX cell's: adamw at lr 3e-4 with a global-norm clip of 1.0.
    A split that does not divide raises (``rules.check_lm_leaf``); one
    inside a head places, the layer gathering its columns."""
    from repro_torch.models import lm
    from repro_torch.sharding.rules import (NamedSpec, check_lm_leaf,
                                            leaf_spec, lm_param_rules,
                                            lm_state_specs, map_with_path,
                                            split_axes, zip_map)
    from repro_torch.train.optimizer import OptimizerConfig, TrainState
    optimizer = optimizer or OptimizerConfig(kind="adamw", lr=3e-4,
                                             grad_clip=1.0)
    rules = lm_param_rules(cfg, mesh)
    whole: Dict[str, torch.Tensor] = {}

    def place_leaf(path, t):
        spec = leaf_spec(path, t, rules)
        check_lm_leaf(cfg, mesh, path, t, spec)
        whole[path] = torch.empty(t.shape, dtype=t.dtype, device="meta")
        return NamedSpec(mesh, spec).place(t)

    if params is None:
        placed = lm.model_init(generator(mesh.device, 0), cfg,
                               place=place_leaf)
    else:
        placed = map_with_path(place_leaf, params)
    template = map_with_path(lambda path, _: whole[path], placed)
    step = torch.zeros((), dtype=torch.int32)
    p_spec, o_spec = lm_state_specs(cfg, mesh, template, {
        "step": step, "m": template, "v": template})
    def zeros(t, spec):
        return torch.zeros(NamedSpec(mesh, spec).block(t).shape,
                           dtype=torch.float32, device=mesh.device)

    opt_state = {"step": step.to(mesh.device),
                 "m": zip_map(zeros, template, o_spec["m"]),
                 "v": zip_map(zeros, template, o_spec["v"])}
    # a data shard's share, unless FSDP cut it over data or it is a row
    # block the sharded gather read
    reduced = [not ("data" in split_axes(spec, mesh) or (
        re.fullmatch(r"embed/(emb|u)", path) is not None
        and "model" in split_axes(spec, mesh)))
        for path, spec in _tree_paths(p_spec)]
    return LMTrainCell(cfg, mesh, TrainState(placed, opt_state),
                       TrainState(p_spec, o_spec), reduced, optimizer,
                       microbatches)


# ======================================================================
# the LM serving cells on a mesh
# ======================================================================

@dataclasses.dataclass
class ServedLM:
    """The served model on one rank: the params without the token table
    (``rules.strip_embed_table``), placed by ``lm_param_rules``, and the
    token table's serving artifact, placed by ``lm_artifact_specs``
    (this rank's block of the codes)."""

    params: dict
    artifact: dict


def _abstract(mesh) -> bool:
    """Whether ``mesh`` is an ``AbstractMesh`` (no process group)."""
    return getattr(mesh, "abstract", False)


def _first_rank(mesh) -> bool:
    return all(mesh.axis_index(a) == 0 for a in mesh.axis_names)


def _export_once(cfg: LMConfig, mesh, embed: dict) -> dict:
    """The token table's artifact, exported (``dpq_assign``) on the
    mesh's first rank from ``embed`` (its whole training params there;
    ignored elsewhere) and broadcast, so every rank serves the same
    codes; on an abstract mesh its shapes alone
    (``serving_artifact_struct``)."""
    from repro_torch.core import Embedding
    from repro_torch.core.schemes.base import tree_map
    from repro_torch.sharding.collectives import broadcast
    if _abstract(mesh):
        # the JAX cells' ``_lm_artifact_struct``: the embedding config's
        # own dtype, where a bf16 LM's export holds bf16 centroids
        return Embedding(cfg.embedding,
                         device=mesh.device).serving_artifact_struct()
    emb = Embedding(dataclasses.replace(cfg.embedding,
                                        param_dtype=cfg.param_dtype),
                    device=mesh.device)
    if _first_rank(mesh):
        with torch.no_grad():
            art = emb.export(embed)
    else:
        art = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                             device=mesh.device),
                       emb.serving_artifact_struct())
    return tree_map(lambda t: broadcast(t, mesh, mesh.axis_names), art)


def serve_placement(cfg: LMConfig, mesh, params=None, artifact=None,
                    seed: int = 0) -> ServedLM:
    """This rank's :class:`ServedLM` of ``cfg`` on ``mesh``.

    ``params`` (whole, on any device; default: drawn from a generator
    seeded ``seed`` on the rank's device, each leaf placed as soon as it
    is drawn, so no rank holds more than one whole leaf at a time): every
    leaf but the token table placed by ``lm_param_rules`` (a split of
    ``wq``/``wk``/``wv`` inside a head is allowed: the layer gathers it).
    ``artifact`` (whole, numpy or tensors) placed by
    ``lm_artifact_specs``; without one, the token table is exported once
    (:func:`_export_once`) and placed."""
    from repro_torch.models import lm
    from repro_torch.sharding.rules import (NamedSpec, check_lm_leaf,
                                            leaf_spec, lm_artifact_specs,
                                            lm_param_rules, map_with_path,
                                            place, strip_embed_table)
    rules = lm_param_rules(cfg, mesh)
    table = {}

    def place_leaf(path, t):
        if path == "embed/emb":
            # kept whole only where it is exported
            if artifact is None and _first_rank(mesh):
                table["emb"] = t
            return t.new_empty(0)
        spec = leaf_spec(path, t, rules)
        check_lm_leaf(cfg, mesh, path, t, spec)
        return NamedSpec(mesh, spec).place(t)

    if params is None:
        placed = lm.model_init(generator(mesh.device, seed), cfg,
                               place=place_leaf)
    else:
        placed = map_with_path(place_leaf, params)
    placed = strip_embed_table(placed)
    if artifact is None:
        artifact = _export_once(cfg, mesh, {**placed["embed"], **table})
        table.clear()
    else:
        from repro_torch.convert import tensor_from_numpy
        from repro_torch.core.schemes.base import tree_map
        artifact = tree_map(lambda t: t if isinstance(t, torch.Tensor)
                            else tensor_from_numpy(t, "cpu"), artifact)
    return ServedLM(placed, place(artifact, lm_artifact_specs(artifact),
                                  mesh))


def _data_rows(t, mesh) -> torch.Tensor:
    """This rank's rows of a global batch ``t`` (every rank holds the
    same), the batch over the data axes as the JAX cells' token specs
    place it, on the rank's device.  A batch that does not divide is
    refused (``models/lm.py::check_batch``; a decode cell replicates
    it)."""
    from repro_torch.models.lm import check_batch
    from repro_torch.sharding.gather import data_axes_of
    from repro_torch.sharding.rules import NamedSpec
    t = torch.as_tensor(t)
    check_batch(t.shape[0], mesh)
    return NamedSpec(mesh, (data_axes_of(mesh, "model"),)).block(t).to(
        mesh.device)


def _lm_serve_batch(shape: ShapeSpec, batch) -> Tuple[int, str]:
    """(global batch, the note's cut) of ``shape`` with ``batch=``."""
    if batch is None or batch == shape.global_batch:
        return shape.global_batch, ""
    return batch, f"; global batch {shape.global_batch} cut to {batch}"


@dataclasses.dataclass
class LMPrefillCell:
    """One rank's prefill of an LM on a mesh: the JAX package's
    ``lm_prefill_cell`` (prompt -> KV cache and last-token logits on the
    serving path) written out as one rank's step.  ``step`` takes this
    rank's prompts (:meth:`local_tokens`) and returns its block of the
    cache (``lm_cache_spec``) and its rows' logits (B_local, V)."""

    cfg: LMConfig
    mesh: Any
    served: ServedLM
    batch: int                      # global
    seq_len: int
    max_seq: int
    note: str = ""

    def local_tokens(self, tokens) -> torch.Tensor:
        """This rank's prompts of the global (B, S) ``tokens``
        (:func:`_data_rows`)."""
        return _data_rows(tokens, self.mesh)

    def step(self, tokens: torch.Tensor):
        from repro_torch.models import lm
        with torch.no_grad():
            return lm.prefill(self.served.params, tokens, self.cfg,
                              max_seq=self.max_seq,
                              embed_artifact=self.served.artifact,
                              mesh=self.mesh)


@dataclasses.dataclass
class LMDecodeCell:
    """One rank's decode step of an LM on a mesh: the JAX package's
    ``lm_decode_cell`` (one new token against a placed cache) written
    out as one rank's step.  ``step`` takes this rank's block of the
    cache (:meth:`make_cache`, or a prefill's) and its tokens
    (:meth:`local_tokens`), updates the cache in place and returns it
    with its rows' logits (B_local, V)."""

    cfg: LMConfig
    mesh: Any
    served: ServedLM
    batch: int                      # global
    seq_len: int                    # the cache's length
    note: str = ""

    def make_cache(self) -> dict:
        """This rank's block of an empty cache of the cell's shape."""
        from repro_torch.models import lm
        return lm.make_cache(self.cfg, self.batch, self.seq_len,
                             mesh=self.mesh)

    def local_tokens(self, token) -> torch.Tensor:
        """This rank's rows of the global (B,) ``token``
        (:func:`_data_rows`); a batch that does not divide over the data
        axes (``long_500k``) whole on every rank, as the JAX cell
        replicates it."""
        from repro_torch.models.lm import batch_divides
        if batch_divides(self.batch, self.mesh):
            return _data_rows(token, self.mesh)
        return torch.as_tensor(token).to(self.mesh.device)

    def step(self, cache: dict, token: torch.Tensor):
        from repro_torch.models import lm
        with torch.no_grad():
            return lm.decode_step(self.served.params, cache, token,
                                  self.cfg,
                                  embed_artifact=self.served.artifact,
                                  mesh=self.mesh, batch=self.batch,
                                  max_seq=self.seq_len)


def lm_prefill_cell(cfg: LMConfig, shape: ShapeSpec, mesh, batch=None,
                    params=None, artifact=None, max_seq=None, served=None,
                    seed: int = 0) -> LMPrefillCell:
    """This rank's :class:`LMPrefillCell` of ``cfg`` at ``shape`` (a
    ``ShapeSpec`` of ``LM_SHAPES``: its global batch, cut by ``batch=``,
    and prompt length) on ``mesh`` (its data axes are every axis but
    ``model``, ``pod`` included).  The cache holds ``max_seq`` tokens (default: the
    prompt's, as the JAX cell's).  The served model is ``served`` (a
    placed :class:`ServedLM`, e.g. another cell's) or
    :func:`serve_placement` of ``params`` and ``artifact``."""
    b, cut = _lm_serve_batch(shape, batch)
    served = served or serve_placement(cfg, mesh, params, artifact, seed)
    return LMPrefillCell(cfg, mesh, served, b, shape.seq_len,
                         max_seq or shape.seq_len,
                         f"prefill B={b} S={shape.seq_len} (serving "
                         f"path){cut}")


def lm_decode_cell(cfg: LMConfig, shape: ShapeSpec, mesh, batch=None,
                   params=None, artifact=None, served=None,
                   seed: int = 0) -> LMDecodeCell:
    """This rank's :class:`LMDecodeCell` of ``cfg`` at ``shape`` (its
    global batch, cut by ``batch=``, and the cache's length) on
    ``mesh``; the rest as :func:`lm_prefill_cell`."""
    b, cut = _lm_serve_batch(shape, batch)
    served = served or serve_placement(cfg, mesh, params, artifact, seed)
    return LMDecodeCell(cfg, mesh, served, b, shape.seq_len,
                        f"serve_step B={b} KV={shape.seq_len} (one new "
                        f"token){cut}")


# ======================================================================
# the recsys serving and retrieval cells on a mesh
# ======================================================================

def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _all_axes(mesh) -> tuple:
    """Every axis of ``mesh``, the data axes first and ``model`` last, as
    the JAX cells spell ``dp_axes + ("model",)``."""
    from repro_torch.sharding.gather import data_axes_of
    return data_axes_of(mesh, "model") + ("model",)


def _on_rank(t, mesh) -> torch.Tensor:
    return torch.as_tensor(t).to(mesh.device)


def serve_params(cfg: RecsysConfig, params: dict) -> dict:
    """The served CTR params (the JAX cell's ``serve_params``): every
    table an artifact serves (``fields/*/emb``, bst's ``item_emb/emb``)
    stripped; deepfm's first-order tables, the codebooks and the dense
    layers kept."""
    def strip(d):
        return {k: v for k, v in d.items() if k != "emb"}
    if cfg.model == "bst":
        return {**params, "item_emb": strip(params["item_emb"])}
    return {**params, "fields": {f: strip(v)
                                 for f, v in params["fields"].items()}}


def recsys_export(model, params: dict) -> dict:
    """A CTR model's served artifacts from its training params: every
    field's (deepfm, autoint) or bst's item table's (``dpq_assign`` on
    the card); from params on the meta device, their shapes alone
    (``serving_artifact_struct``)."""
    if model.device.type == "meta":
        if model.cfg.model == "bst":
            return model.item_emb.serving_artifact_struct()
        return model.fields.artifact_struct()
    with torch.no_grad():
        if model.cfg.model == "bst":
            return model.item_emb.export(params["item_emb"])
        return model.fields.export(params["fields"])


def _placed_params(cfg: RecsysConfig, params: dict, mesh) -> dict:
    from repro_torch.sharding.rules import place, recsys_param_rules, \
        spec_tree
    return place(params, spec_tree(params, recsys_param_rules(cfg, mesh)),
                 mesh)


@dataclasses.dataclass
class RecsysServeCell:
    """One rank's serve of a recsys model on a mesh: the JAX package's
    ``recsys_serve_cell`` (a ``jax.jit`` of the serving fn under GSPMD)
    written out as one rank's step.  The batch is a data shard: ``step``
    takes this rank's rows (:meth:`local_batch`) and returns their
    logits (B_local,).

    A CTR model serves its quantized artifacts: ``artifacts`` is this
    rank's, placed by ``recsys_artifact_specs`` (a code table of at
    least 16·model rows that divide: its row block), ``params`` the
    served params (:func:`serve_params`) placed by the recsys rules;
    each field reads its block through the per-rank quantized gather
    (``mgqe_decode`` on this rank's codes).  Two-tower scores ``sum(u ·
    v)`` of its training towers (``artifacts`` None), the tables read
    through the row gather."""

    model: Any
    mesh: Any
    params: dict
    artifacts: Any
    note: str = ""

    def local_batch(self, batch: Dict) -> Dict:
        """This rank's data shard of a global batch (every rank holds the
        same; ``label`` dropped) over the mesh's data axes (``pod`` too
        where the mesh has it), on the rank's device."""
        from repro_torch.sharding.rules import named, recsys_batch_spec
        batch = {k: torch.as_tensor(v) for k, v in batch.items()
                 if k != "label"}
        specs = named(self.mesh, recsys_batch_spec(
            batch, "pod" in self.mesh.shape))
        return {k: specs[k].block(v).to(self.mesh.device)
                for k, v in batch.items()}

    def step(self, batch: Dict) -> torch.Tensor:
        with torch.no_grad():
            if self.model.cfg.model == "two_tower":
                u, _ = self.model.user_vec(self.params, batch["user_ids"],
                                           self.mesh)
                v, _ = self.model.item_vec(self.params, batch["item_ids"],
                                           self.mesh)
                return torch.sum(u * v, dim=-1)
            return self.model.serve(self.params, self.artifacts, batch,
                                    mesh=self.mesh)


def recsys_serve_cell(cfg: RecsysConfig, shape: ShapeSpec, mesh,
                      params=None, artifacts=None) -> RecsysServeCell:
    """This rank's :class:`RecsysServeCell` of ``cfg`` at ``shape`` (a
    ``rec_serve`` entry of ``RECSYS_SHAPES``: its batch) on ``mesh``.  ``params`` (whole, on any device; default:
    drawn as ``recsys_train_cell`` draws them) and, for a CTR model,
    ``artifacts`` (whole, numpy or tensors; default: exported here from
    ``params``, the same codes on every rank) are placed as the class
    docstring says."""
    from repro_torch.sharding.rules import place, recsys_artifact_specs
    model = recsys_model(cfg, device=mesh.device)
    if params is None:
        params = model.init(generator(mesh.device, 0))
    if cfg.model == "two_tower":
        return RecsysServeCell(model, mesh, _placed_params(cfg, params,
                                                           mesh), None,
                               f"serve B={shape.batch}")
    if artifacts is None:
        artifacts = recsys_export(model, params)
    placed = _placed_params(cfg, serve_params(cfg, params), mesh)
    del params
    arts = place(artifacts, recsys_artifact_specs(artifacts, mesh), mesh)
    return RecsysServeCell(model, mesh, placed, arts,
                           f"serve B={shape.batch} (quantized artifacts)")


@dataclasses.dataclass
class RecsysRetrievalCell:
    """One rank's retrieval scoring on a mesh: the JAX package's
    ``recsys_retrieval_cell``, one query against ``n_candidates``
    candidates (padded to a multiple of the mesh's ranks), each rank
    scoring its block of them over every axis; ``step`` returns all N
    scores on every rank (the rank's block all-gathered).

    Two-tower: the corpus's PQ codes (N, n_sub) uint8 (n_sub 16 where
    the tower's output divides by 16, else 8) split over every axis
    (:meth:`local_corpus`), the (n_sub, 256, d_out / n_sub) codebooks
    replicated; the user
    tower's vector (its table read through the row gather) scored on
    this rank's block by ``flat_pq.adc_scores`` (``pq_score``).

    A CTR model: ``model.apply`` of the training params (placed by the
    recsys rules) on the candidates, which differ on every rank, model
    included, where the row gather (``sharding/gather.py``) wants ids
    equal on the ranks of a model line.  So a rank all-gathers its
    block's ids over ``model`` first (KBs): the ranks of a model line
    then score their data shard together, each holding its logits (the
    dense layers run on each rank of the line), and the data shards'
    logits are all-gathered."""

    model: Any
    mesh: Any
    params: dict
    n_candidates: int               # global, padded
    note: str = ""

    def local_corpus(self, corpus: Dict) -> Dict:
        """This rank's corpus (whole on every rank, numpy or tensors): its
        block of the codes over every axis, the centroids whole."""
        from repro_torch.sharding.collectives import block
        return {"codes": block(torch.as_tensor(corpus["codes"]), self.mesh,
                               _all_axes(self.mesh)).to(self.mesh.device),
                "centroids": _on_rank(corpus["centroids"], self.mesh)}

    def local_candidates(self, batch: Dict) -> Dict:
        """This rank's block over every axis of the candidates (a CTR
        model's batch of ``n_candidates`` rows, ``label`` dropped)."""
        from repro_torch.sharding.collectives import block
        out = {}
        for k, v in batch.items():
            if k == "label":
                continue
            v = torch.as_tensor(v)
            if v.shape[0] != self.n_candidates:
                raise ValueError(f"{k}: {v.shape[0]} candidates, the cell "
                                 f"scores {self.n_candidates}")
            out[k] = block(v, self.mesh, _all_axes(self.mesh)).to(
                self.mesh.device)
        return out

    def step(self, *args) -> torch.Tensor:
        """Two-tower: ``step(corpus, user_id)`` (this rank's corpus, the
        (1,) user id); a CTR model: ``step(candidates)`` (this rank's
        block).  Returns the (N,) scores."""
        from repro_torch.sharding.collectives import all_gather
        from repro_torch.sharding.gather import data_axes_of
        mesh = self.mesh
        with torch.no_grad():
            if self.model.cfg.model == "two_tower":
                from repro_torch.retrieval.flat_pq import adc_scores
                corpus, user_id = args
                u, _ = self.model.user_vec(self.params,
                                           _on_rank(user_id, mesh), mesh)
                return all_gather(adc_scores(corpus, u[0]), mesh,
                                  _all_axes(mesh))
            (batch,) = args
            line = {k: all_gather(v, mesh, "model") for k, v in batch.items()}
            logits, _ = self.model.apply(self.params, line, mesh=mesh)
            return all_gather(logits, mesh, data_axes_of(mesh, "model"))


def recsys_retrieval_cell(cfg: RecsysConfig, shape: ShapeSpec, mesh,
                          params=None, n_candidates=None
                          ) -> RecsysRetrievalCell:
    """This rank's :class:`RecsysRetrievalCell` of ``cfg`` at ``shape``
    (``retrieval_cand``: its candidates, cut by ``n_candidates=``, padded
    to a multiple of ``mesh.size``) on ``mesh``; ``params`` (whole, on
    any device; default: drawn as ``recsys_train_cell`` draws them)
    placed by the recsys rules."""
    model = recsys_model(cfg, device=mesh.device)
    if params is None:
        params = model.init(generator(mesh.device, 0))
    want = shape.n_candidates if n_candidates is None else n_candidates
    n = _pad_to(want, mesh.size)
    cut = "" if want == shape.n_candidates else \
        f"; {shape.n_candidates} candidates cut to {want}"
    what = ("ADC retrieval" if cfg.model == "two_tower"
            else "candidate scoring")
    return RecsysRetrievalCell(model, mesh, _placed_params(cfg, params, mesh),
                               n, f"{what} 1x{n}{cut}")


# ======================================================================
# GNN (MACE)
# ======================================================================

def mace_model_flops(cfg: GNNConfig, n_nodes: int, n_edges: int,
                     train: bool = True) -> float:
    """Analytic forward MACs x2 (x3 more for train) for the MACE step."""
    paths = so3.coupling_table(cfg.l_max)
    n_paths = len(paths)
    c = cfg.d_hidden
    s_tot = so3.num_sh(cfg.l_max)
    # per layer
    per_l = 0.0
    # radial MLP: E x (rbf*64 + 64*C*P)
    per_l += n_edges * (cfg.n_rbf * 64 + 64 * c * n_paths)
    # edge TP + pairwise CG: paths ~ E/N x C x S1*S2*S3
    path_cost = sum((2 * l1 + 1) * (2 * l2 + 1) * (2 * l3 + 1)
                    for (l1, l2, l3, _) in paths)
    per_l += n_edges * c * path_cost          # edge TP
    per_l += 2 * n_nodes * c * path_cost      # B2, B3
    # channel mixes: 4 x N x C*C*S
    per_l += 4 * n_nodes * c * c * s_tot
    # readout
    per_l += n_nodes * (c * 64 + 64 * cfg.d_readout)
    fl = cfg.num_layers * per_l * 2.0         # MAC -> 2 FLOPs
    return fl * (3.0 if train else 1.0)


def mace_shape(shape: ShapeSpec) -> Tuple[int, int, int, str, int]:
    """(n_nodes, n_edges, d_feat, task, n_graphs) of a ``GNN_SHAPES``
    entry, as the JAX package's ``mace_cell`` resolves it on one device:
    ``graph_mini`` the fanout sample's sizes at d_feat 128, node
    classification; ``graph_batched`` N·B and E·B, energy; else the
    shape's own sizes, node classification."""
    if shape.kind == "graph_mini":
        n_nodes, n_edges = sampled_subgraph_sizes(shape.batch_nodes,
                                                  shape.fanout)
        return n_nodes, n_edges, 128, "node_class", 0
    if shape.kind == "graph_batched":
        return (shape.n_nodes * shape.batch_graphs,
                shape.n_edges * shape.batch_graphs, 0, "energy",
                shape.batch_graphs)
    return shape.n_nodes, shape.n_edges, shape.d_feat, "node_class", 0


# the node and edge leaves of a MACE graph (the edge index is (2, E))
_NODE_LEAVES = ("positions", "species", "node_feats", "labels",
                "label_mask", "graph_id")


def pad_graph(graph: dict, multiple: int, task: str) -> dict:
    """``graph`` (numpy or tensors) with its nodes and edges padded to a
    multiple of ``multiple``, as the JAX cell pads N and E, such that
    the padding changes no result: padded edges are (0, 0) self-loops,
    which the edge mask zeroes; padded nodes sit at the origin with
    species 0, no edge, no label (``label_mask`` 0, made all ones for
    the real nodes where the graph has none) and, for the energy task,
    the graph id ``n_graphs``, which adds to no graph on a mesh
    (``MACE.apply``)."""
    g = {k: v if k == "n_graphs" else torch.as_tensor(v)
         for k, v in graph.items()}
    n = g["positions"].shape[0]
    pn = (-n) % multiple
    pe = (-g["edge_index"].shape[1]) % multiple
    if task == "node_class" and "label_mask" not in g:
        g["label_mask"] = torch.ones((n,), dtype=torch.float32)
    fill = {"graph_id": int(g.get("n_graphs", 0))}
    for k in _NODE_LEAVES:
        if k in g and pn:
            t = g[k]
            g[k] = torch.cat([t, torch.full((pn,) + tuple(t.shape[1:]),
                                            fill.get(k, 0), dtype=t.dtype)])
    if pe:
        ei = g["edge_index"]
        g["edge_index"] = torch.cat(
            [ei, torch.zeros((2, pe), dtype=ei.dtype)], dim=1)
    return g


@dataclasses.dataclass
class MaceTrainCell:
    """One rank's share of MACE trained with adam on a mesh: the JAX
    package's ``mace_cell`` (a ``jax.jit`` step under GSPMD) written out
    as one rank's step.

    The graph's nodes and edges are split in contiguous blocks over
    every axis (:meth:`local_graph`, after :func:`pad_graph`); the params
    are placed by ``gnn_param_rules`` (channels over ``model``) and a
    rank gathers each leaf's channel blocks over ``model`` before use
    (``all_gather_grad``: backward, the cotangent summed over ``model``
    and sliced).  ``MACE.apply(mesh=)`` gathers the node irreps and
    keeps its block of the receiver sums; every rank backpropagates the
    global loss, so a gradient is a rank's share: a channel block's is
    summed over the data axes (its gather summed ``model``), a
    replicated leaf's over every axis.  Adam's moments are whole on
    every rank, as the JAX cell replicates them: a step gathers the
    gradients and params whole, clips and updates them and keeps this
    rank's block of each param."""

    model: Any
    mesh: Any
    state: Any
    specs: Any
    split: List[bool]
    task: str
    n_nodes: int                    # padded, as the JAX cell's
    n_edges: int
    n_graphs: int
    note: str = ""

    def local_graph(self, graph: dict) -> dict:
        """This rank's share of a whole graph (every rank holds the same;
        numpy or tensors), padded by :func:`pad_graph`: its block of the
        nodes and of the edges over every axis on the rank's device, the
        graphs' ``energy`` and ``n_graphs`` whole."""
        from repro_torch.sharding.collectives import block
        # in mesh order, as ``MACE.apply(mesh=)`` gathers the blocks
        axes = tuple(self.mesh.axis_names)
        g = pad_graph(graph, self.mesh.size, self.task)
        out = {}
        for k, v in g.items():
            if k in _NODE_LEAVES:
                v = block(v, self.mesh, axes)
            elif k == "edge_index":
                v = block(v, self.mesh, axes, dim=1)
            out[k] = v if k == "n_graphs" else v.to(self.mesh.device)
        return out

    def whole_params(self, params: dict) -> dict:
        """Every leaf whole: a channel block gathered over the axes its
        spec names (``all_gather_grad``), a replicated leaf as it is."""
        from repro_torch.sharding.collectives import all_gather_grad
        from repro_torch.sharding.rules import split_axes, zip_map

        def whole(t, spec):
            for dim, axes in enumerate(spec):
                if axes is not None and split_axes((axes,), self.mesh):
                    t = all_gather_grad(t, self.mesh, axes, dim=dim)
            return t
        return zip_map(whole, params, self.specs.params)

    def loss(self, params: dict, graph: dict) -> Tuple[Any, Dict]:
        """The global batch's loss and metrics on every rank, from this
        rank's params and share of the graph."""
        fn = (self.model.energy_loss if self.task == "energy"
              else self.model.node_class_loss)
        return fn(self.whole_params(params), graph, mesh=self.mesh)

    def grads(self, state, graph: dict) -> Tuple[Any, Dict]:
        """This rank's shares of the gradients (a channel block's already
        summed over ``model``) and the global metrics."""
        from repro_torch.train.optimizer import loss_grads
        return loss_grads(self.loss, state.params, graph)

    def reduce(self, grads) -> Any:
        """The whole gradients from this rank's shares: every leaf summed
        over the data axes and a replicated one over ``model`` too, in
        one flat collective each."""
        from repro_torch.core.schemes.base import tree_leaves
        from repro_torch.sharding.collectives import psum
        from repro_torch.sharding.gather import data_axes_of
        leaves = tree_leaves(grads)
        for part, axes in ((leaves, data_axes_of(self.mesh, "model")),
                           ([g for g, cut in zip(leaves, self.split)
                             if not cut], ("model",))):
            if not part:
                continue
            flat = psum(torch.cat([g.reshape(-1) for g in part]), self.mesh,
                        axes)
            at = 0
            for g in part:
                g.copy_(flat[at:at + g.numel()].view_as(g))
                at += g.numel()
        return grads

    def step(self, state, graph: dict) -> Tuple[Any, Dict]:
        """One adam step (``GNN_OPTIMIZER``) on this rank's share
        ``graph`` (:meth:`local_graph`): the reduced gradients and the
        params made whole (each channel block gathered over ``model``),
        clipped by the global norm and applied to the whole moments,
        this rank's block of each updated param kept; the metrics are
        the whole graph's."""
        from repro_torch.core.schemes.base import tree_leaves
        from repro_torch.launch.train import GNN_OPTIMIZER
        from repro_torch.sharding.rules import NamedSpec, spec_leaves
        from repro_torch.train.optimizer import TrainState, apply_updates
        grads, metrics = self.grads(state, graph)
        grads = self.reduce(grads)
        with torch.no_grad():
            whole_g = self.whole_params(grads)
            whole_p = self.whole_params(state.params)
            whole_p, opt_state = apply_updates(GNN_OPTIMIZER, whole_p,
                                               whole_g, state.opt_state)
            for p, w, spec in zip(tree_leaves(state.params),
                                  tree_leaves(whole_p),
                                  spec_leaves(self.specs.params),
                                  strict=True):
                if w is not p:
                    p.copy_(NamedSpec(self.mesh, spec).block(w))
        return TrainState(state.params, opt_state), metrics


# one (E, C, 9) float32 edge tensor of ogb_products at CONFIG's C = 128,
# and the radial weights w_r (E, C·15)
_OGB_EDGE_BYTES = 61_859_140 * 128 * 9 * 4
_OGB_WR_BYTES = 61_859_140 * 128 * 15 * 4


def mace_cell(cfg: GNNConfig, shape: ShapeSpec, mesh,
              params=None) -> MaceTrainCell:
    """This rank's :class:`MaceTrainCell` of ``cfg`` at ``shape`` (a
    ``GNN_SHAPES`` entry, resolved by :func:`mace_shape`, N and E padded
    to multiples of ``mesh.size``) on ``mesh``: ``params`` (whole, on
    any device; default: drawn as ``launch/train.py::gnn_setup`` draws
    them, a feature projection where the shape has features) placed by
    ``gnn_param_rules``, adam's zeros whole.  ``ogb_products``
    is refused: one (E, C, 9) float32 edge tensor is 285 GB and its
    radial weights 475 GB, and neither package has an edge-chunked
    forward.  On an abstract mesh it is built (shapes alone, as the JAX
    package's dry run builds it)."""
    from repro_torch.models.gnn.mace import MACE
    from repro_torch.launch.train import GNN_OPTIMIZER
    from repro_torch.core.schemes.base import tree_leaves, tree_map
    from repro_torch.sharding.rules import (gnn_param_rules, map_with_path,
                                            place, spec_leaves, spec_tree,
                                            splits)
    from repro_torch.train.optimizer import TrainState
    from repro_torch.train.optimizer import init as opt_init
    if shape.name == "ogb_products" and not _abstract(mesh):
        raise ValueError(
            f"ogb_products ({shape.n_nodes:,} nodes, {shape.n_edges:,} "
            f"edges) does not run: one (E, C, 9) float32 edge tensor is "
            f"{_OGB_EDGE_BYTES / 1e9:.0f} GB and w_r (E, C·15) "
            f"{_OGB_WR_BYTES / 1e9:.0f} GB, and neither package has an "
            f"edge-chunked forward (ROADMAP.md §1 item 8)")
    n, e, d_feat, task, n_graphs = mace_shape(shape)
    n, e = _pad_to(n, mesh.size), _pad_to(e, mesh.size)
    model = MACE(cfg, device=mesh.device)
    if params is None:
        params = model.init(generator(mesh.device, 0), n_feat=d_feat or None)
    p_spec = spec_tree(params, gnn_param_rules(cfg, mesh))
    placed = place(params, p_spec, mesh)
    split = [splits(sp, mesh) for sp in spec_leaves(p_spec)]
    if len(split) != len(tree_leaves(placed)):
        raise ValueError("the spec tree does not mirror the params")
    # the moments whole on every rank, as the JAX cell's
    state = TrainState(placed, opt_init(GNN_OPTIMIZER, tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device=mesh.device),
        params)))
    del params
    o_spec = {"step": (), **{k: map_with_path(lambda _, s: (), p_spec)
                             for k in state.opt_state if k != "step"}}
    return MaceTrainCell(model, mesh, state, TrainState(p_spec, o_spec),
                         split, task, n, e, n_graphs,
                         f"{task} train_step N={n} E={e}")


def sampled_graph(g: dict, sub: dict) -> dict:
    """The node-classification batch of a ``NeighborSampler`` sample
    ``sub`` over the graph ``g`` (numpy, as ``random_graph`` gives it):
    the sampled nodes' positions, species, features and labels, the
    sample's local edges, and a ``label_mask`` of 1 on its seeds (the
    first ``n_seeds`` local ids) and 0 elsewhere."""
    ids = sub["node_ids"]
    mask = np.zeros(len(ids), np.float32)
    mask[:sub["n_seeds"]] = 1.0
    return {"positions": g["positions"][ids], "species": g["species"][ids],
            "node_feats": g["node_feats"][ids], "labels": g["labels"][ids],
            "label_mask": mask, "edge_index": sub["edge_index"]}


# ======================================================================
# the dry run's surface: Cell and build_cell
# ======================================================================

@dataclasses.dataclass
class Cell:
    """One rank's cell as :func:`build_cell` returns it, the JAX package's
    ``Cell``: ``fn(*args)`` is the rank's step on ``args`` (this rank's
    state and inputs; on an ``AbstractMesh`` meta tensors of their
    shapes), ``specs`` each argument's spec tree (the JAX cell's
    ``in_shardings``), ``model_flops`` the useful FLOPs of the whole
    step over every rank, ``donate`` the arguments the step consumes,
    ``cell`` the per-rank cell object it is built over."""

    arch: str
    shape: str
    fn: Callable
    args: Tuple
    specs: Tuple
    model_flops: float
    donate: Tuple[int, ...] = ()
    note: str = ""
    cell: Any = None


def _meta_batch(struct: Dict, specs: Dict, mesh) -> Dict:
    """This rank's block of each (shape, dtype) leaf of a global batch
    ``struct`` under ``specs``, as empty tensors on the rank's device."""
    from repro_torch.sharding.rules import NamedSpec
    out = {}
    for k, (shape, dtype) in struct.items():
        whole = torch.empty(shape, dtype=dtype, device="meta")
        local = NamedSpec(mesh, tuple(specs[k])).block(whole).shape
        out[k] = torch.empty(local, dtype=dtype, device=mesh.device)
    return out


def recsys_dense_params(cfg: RecsysConfig) -> int:
    """Rough dense (non-embedding) parameter count for MODEL_FLOPS, the
    JAX package's ``_recsys_dense_params``."""
    if cfg.model == "autoint":
        d_out = cfg.n_attn_heads * cfg.d_attn
        per = 4 * cfg.embed_dim * d_out + 3 * d_out * d_out * \
            max(cfg.n_attn_layers - 1, 0)
        return per + cfg.n_sparse * d_out
    if cfg.model == "deepfm":
        dims = (cfg.n_sparse * cfg.embed_dim,) + tuple(cfg.mlp_dims) + (1,)
        return sum(a * b for a, b in zip(dims, dims[1:]))
    if cfg.model == "bst":
        d = cfg.embed_dim
        blk = cfg.n_blocks * (4 * d * d + 8 * d * d)
        s = cfg.seq_len + 1
        dims = (s * d,) + tuple(cfg.tower_mlp) + (1,)
        return blk + sum(a * b for a, b in zip(dims, dims[1:]))
    if cfg.model == "two_tower":
        dims = (cfg.embed_dim,) + tuple(cfg.tower_mlp)
        return 2 * sum(a * b for a, b in zip(dims, dims[1:]))
    raise ValueError(f"unknown recsys model {cfg.model!r}")


def recsys_batch_struct(cfg: RecsysConfig, b: int) -> Dict:
    """A recsys batch of ``b`` rows as {leaf: (shape, dtype)}, the JAX
    cells' ``_recsys_batch_struct`` (int32 ids, float32 labels)."""
    i32, f32 = torch.int32, torch.float32
    if cfg.model == "two_tower":
        return {"user_ids": ((b,), i32), "item_ids": ((b,), i32),
                "item_logq": ((b,), f32)}
    if cfg.model == "bst":
        return {"hist_ids": ((b, cfg.seq_len), i32),
                "target_id": ((b,), i32), "label": ((b,), f32)}
    return {"sparse_ids": ((b, cfg.n_sparse), i32), "label": ((b,), f32)}


def _data_spec(struct: Dict, multi_pod: bool) -> Dict:
    """``recsys_batch_spec`` of a batch given as {leaf: (shape, dtype)}."""
    from repro_torch.sharding.rules import recsys_batch_spec
    return recsys_batch_spec({k: torch.empty(shape, dtype=dtype,
                                             device="meta")
                              for k, (shape, dtype) in struct.items()},
                             multi_pod)


def _all_axes_spec(struct: Dict, mesh) -> Dict:
    return {k: (_all_axes(mesh),) + (None,) * (len(v[0]) - 1)
            for k, v in struct.items()}


def _recsys_cell(arch: str, cfg: RecsysConfig, shape: ShapeSpec, mesh,
                 multi_pod: bool, n_candidates=None, params=None,
                 artifact=None) -> Cell:
    dense = recsys_dense_params(cfg)
    if shape.kind == "rec_train":
        tc = recsys_train_cell(cfg, mesh, params, multi_pod=multi_pod)
        struct = recsys_batch_struct(cfg, shape.batch)
        spec = _data_spec(struct, multi_pod)
        batch = _meta_batch(struct, spec, mesh)
        return Cell(arch, shape.name, tc.step, (tc.state, batch),
                    (tc.specs, spec), 6.0 * dense * shape.batch, (0,),
                    f"train_step B={shape.batch}", tc)
    if shape.kind == "rec_serve":
        sc = recsys_serve_cell(cfg, shape, mesh, params, artifact)
        struct = recsys_batch_struct(cfg, shape.batch)
        struct.pop("label", None)
        struct.pop("item_logq", None)
        spec = _data_spec(struct, multi_pod)
        batch = _meta_batch(struct, spec, mesh)
        if sc.artifacts is None:
            def fn(params, batch):
                return dataclasses.replace(sc, params=params).step(batch)
            args = (sc.params, batch)
        else:
            def fn(params, artifacts, batch):
                return dataclasses.replace(sc, params=params,
                                           artifacts=artifacts).step(batch)
            args = (sc.params, sc.artifacts, batch)
        return Cell(arch, shape.name, fn, args, (None,) * (len(args) - 1)
                    + (spec,), 2.0 * dense * shape.batch, (), sc.note, sc)
    rc = recsys_retrieval_cell(cfg, shape, mesh, params,
                               n_candidates=n_candidates)
    n = rc.n_candidates
    if cfg.model == "two_tower":
        d_out = cfg.tower_mlp[-1]
        n_sub = 16 if d_out % 16 == 0 else 8
        struct = {"codes": ((n, n_sub), torch.uint8),
                  "centroids": ((n_sub, 256, d_out // n_sub), torch.float32)}
        spec = {"codes": (_all_axes(mesh), None), "centroids": ()}
        corpus = _meta_batch(struct, spec, mesh)
        user = torch.empty((1,), dtype=torch.int32, device=mesh.device)

        def fn(params, corpus, user_id):
            return dataclasses.replace(rc, params=params).step(corpus,
                                                               user_id)
        flops = 2.0 * dense / 2 + 2.0 * n * n_sub
        return Cell(arch, shape.name, fn, (rc.params, corpus, user),
                    (None, spec, ()), flops, (), rc.note, rc)
    struct = recsys_batch_struct(cfg, n)
    struct.pop("label")
    spec = _all_axes_spec(struct, mesh)
    batch = _meta_batch(struct, spec, mesh)

    def fn(params, batch):
        return dataclasses.replace(rc, params=params).step(batch)
    return Cell(arch, shape.name, fn, (rc.params, batch), (None, spec),
                2.0 * dense * n, (), rc.note, rc)


def _lm_cell(arch: str, cfg: LMConfig, shape: ShapeSpec, mesh,
             multi_pod: bool, microbatches: int, batch=None, params=None,
             artifact=None) -> Cell:
    from repro_torch.models import lm
    from repro_torch.roofline import (lm_forward_model_flops,
                                      lm_train_model_flops)
    from repro_torch.sharding.rules import lm_batch_spec
    b = shape.global_batch if batch is None else batch
    n_active = cfg.active_param_count()
    s = shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        tc = lm_train_cell(cfg, mesh, microbatches, params=params)
        lm.check_batch(b, mesh)
        if b % (microbatches * tc.data_shards):
            raise ValueError(f"batch {b} not divisible into "
                             f"{microbatches} microbatches over "
                             f"{tc.data_shards} data shard(s)")
        spec = lm_batch_spec(multi_pod)
        data = _meta_batch({"tokens": ((b, s), i32),
                            "labels": ((b, s), i32)}, spec, mesh)
        return Cell(arch, shape.name, tc.step, (tc.state, data),
                    (tc.specs, spec), lm_train_model_flops(n_active, b * s),
                    (0,), f"train_step B={b} S={s}", tc)
    dp = _all_axes(mesh)[:-1]
    dp = dp[0] if len(dp) == 1 else dp
    if shape.kind == "prefill":
        pc = lm_prefill_cell(cfg, shape, mesh, batch=b, params=params,
                             artifact=artifact)
        lm.check_batch(b, mesh)
        spec = (dp, None)
        tokens = _meta_batch({"tokens": ((b, s), i32)}, {"tokens": spec},
                             mesh)["tokens"]

        def fn(params, artifact, tokens):
            with torch.no_grad():
                return lm.prefill(params, tokens, cfg, max_seq=pc.max_seq,
                                  embed_artifact=artifact, mesh=mesh)
        return Cell(arch, shape.name, fn,
                    (pc.served.params, pc.served.artifact, tokens),
                    (None, None, spec), lm_forward_model_flops(n_active, b * s),
                    (), pc.note, pc)
    dc = lm_decode_cell(cfg, shape, mesh, batch=b, params=params,
                        artifact=artifact)
    cache = dc.make_cache()
    spec = (dp,) if lm.batch_divides(b, mesh) else ()
    token = _meta_batch({"token": ((b,), i32)}, {"token": spec},
                        mesh)["token"]

    def fn(params, artifact, cache, token):
        with torch.no_grad():
            return lm.decode_step(params, cache, token, cfg,
                                  embed_artifact=artifact, mesh=mesh,
                                  batch=b, max_seq=s)
    return Cell(arch, shape.name, fn,
                (dc.served.params, dc.served.artifact, cache, token),
                (None, None, None, spec), lm_forward_model_flops(n_active, b),
                (2,), dc.note, dc)


def _mace_cell(arch: str, cfg: GNNConfig, shape: ShapeSpec, mesh,
               params=None) -> Cell:
    mc = mace_cell(cfg, shape, mesh, params)
    _, _, d_feat, task, _ = mace_shape(shape)
    n, e = mc.n_nodes, mc.n_edges
    f32, i32 = torch.float32, torch.int32
    struct = {"positions": ((n, 3), f32), "species": ((n,), i32),
              "edge_index": ((2, e), i32)}
    if d_feat:
        struct["node_feats"] = ((n, d_feat), f32)
    if task == "node_class":
        struct["labels"] = ((n,), i32)
        struct["label_mask"] = ((n,), f32)
    else:
        struct["graph_id"] = ((n,), i32)
        struct["energy"] = ((mc.n_graphs,), f32)
    axes = tuple(mesh.axis_names)
    spec = {k: ((None, axes) if k == "edge_index" else
                () if k == "energy" else (axes,) + (None,) * (len(v[0]) - 1))
            for k, v in struct.items()}
    graph = _meta_batch(struct, spec, mesh)

    def fn(state, graph):
        if task == "energy":
            graph = dict(graph, n_graphs=mc.n_graphs)
        return mc.step(state, graph)
    return Cell(arch, shape.name, fn, (mc.state, graph), (mc.specs, spec),
                mace_model_flops(cfg, n, e, train=True), (0,), mc.note, mc)


def build_cell(arch: str, shape: ShapeSpec, mesh, multi_pod: bool = False,
               opts: Tuple[str, ...] = (), cfg=None, batch=None,
               n_candidates=None, params=None, artifact=None) -> Cell:
    """This rank's :class:`Cell` of ``arch`` at ``shape`` on ``mesh`` (a
    ``Mesh``, or an ``AbstractMesh`` for a dry run), with the JAX
    package's named options: ``microbatch<N>``; for an LM ``embed_full``
    (a plain full-table embedding in place of MGQE),
    ``embed_sharded_rows`` and every one of ``LM_CFG_OPTS``; for a
    recsys model ``sharded_embedding``.  An unknown option raises,
    naming the family.  ``cfg`` replaces the registry's config (a cut
    one), ``batch`` an LM cell's global batch and ``n_candidates`` a
    retrieval cell's candidates; ``params`` (whole) and ``artifact`` (a
    served model's) go to the cell's constructor, which draws them when
    None.  ``multi_pod`` must agree with the
    mesh's ``pod`` axis: the cells take their data axes from the mesh."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.types import EmbeddingConfig
    family, base = get_arch(arch)
    cfg = base if cfg is None else cfg
    if multi_pod != ("pod" in mesh.shape):
        raise ValueError(f"multi_pod={multi_pod} on mesh {mesh.shape}: the "
                         f"pod axis decides the data axes")
    microbatches = 1
    for o in opts:
        if o.startswith("microbatch") and o[len("microbatch"):].isdigit():
            microbatches = int(o[len("microbatch"):])
        elif o == "embed_full" and family == "lm":
            cfg = dataclasses.replace(
                cfg, embedding=EmbeddingConfig(vocab_size=cfg.vocab_size,
                                               dim=cfg.d_model))
        elif o == "embed_sharded_rows" and family == "lm":
            cfg = dataclasses.replace(
                cfg, embedding=dataclasses.replace(cfg.embedding,
                                                   sharded_rows=True))
        elif family == "lm" and o in LM_CFG_OPTS:
            cfg = dataclasses.replace(cfg, **LM_CFG_OPTS[o])
        elif o == "sharded_embedding" and family == "recsys":
            cfg = dataclasses.replace(cfg, sharded_embedding=True)
        else:
            raise ValueError(f"unknown opt {o!r} for family {family}")
    if family == "lm":
        cell = _lm_cell(arch, cfg, shape, mesh, multi_pod, microbatches,
                        batch, params, artifact)
    elif family == "gnn":
        cell = _mace_cell(arch, cfg, shape, mesh, params)
    elif family == "recsys":
        cell = _recsys_cell(arch, cfg, shape, mesh, multi_pod, n_candidates,
                            params, artifact)
    else:
        raise ValueError(f"unknown family {family!r}")
    if opts:
        cell.note += f" +opts[{','.join(opts)}]"
    return cell
