"""Scheme plugin protocol + registry.

A *scheme* is one embedding-compression technique — the paper's
DPQ/MGQE or a baseline they are compared against.  Each scheme is ONE
class registered under its ``EmbeddingConfig.kind`` string:

    @register_scheme("dpq")
    class DifferentiableProductQuantization(QuantizedScheme):
        ...

Every integration layer (``Embedding`` in core/api.py, the
``ServingEngine``) resolves schemes through this registry instead of
``cfg.kind ==`` chains.

The single source of truth for a scheme's serving artifact is
:meth:`Scheme.artifact_spec`: a tree (dicts and lists) of
:class:`ArtifactLeaf` carrying shape, torch dtype, row placement and the
*logical* (packed) bit count per leaf.  ``serving_artifact_struct()``
(meta-device tensors) and ``serving_size_bits()`` (the paper's
§1.1/§3.5 accounting, float widths taken from the leaf dtype) are
derived from it on the base class, so they cannot drift.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Type

import torch


def log2ceil(k: int) -> int:
    """Bits to address k code slots (min 1)."""
    return max(1, math.ceil(math.log2(k)))


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """``param_dtype`` string -> torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown param_dtype {name!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


# ``QuantizedScheme.decode`` block_b sentinel: pin the decode kernel's
# row tile to ``cfg.decode_block_b`` (the engine pads every flush to a
# multiple of it).  ``block_b=None`` defers to the autotune cache.
PIN_TO_CONFIG: Any = "pin-to-config"


@dataclasses.dataclass(frozen=True)
class ArtifactLeaf:
    """One leaf of a serving artifact, fully described.

    ``rows=True`` marks O(vocab) leaves (row-sharded over a mesh's
    model axis, ``artifact_shard_specs``); everything else is
    replicated.
    ``logical_bits`` overrides the storage-derived bit count for the
    size accounting — code tables are *stored* at uint8/int32
    granularity but *accounted* at their packed width (``log2ceil(K)``
    bits per code, paper §1.1).
    """

    shape: Tuple[int, ...]
    dtype: torch.dtype
    rows: bool = False
    logical_bits: Optional[int] = None

    @property
    def storage_bits(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize * 8

    @property
    def size_bits(self) -> int:
        return self.storage_bits if self.logical_bits is None \
            else self.logical_bits


def tree_leaves(tree) -> list:
    """Leaves of a tree of dicts/lists/tuples, in key order for dicts."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` applied to every leaf, keeping the dict/list structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _hot_ids(n: int, artifact: dict) -> torch.Tensor:
    """Ids ``0..n-1`` (int32) on the artifact's device."""
    device = tree_leaves(artifact)[0].device
    return torch.arange(n, dtype=torch.int32, device=device)


class Scheme:
    """Protocol every embedding scheme implements.

    Required overrides: ``init`` / ``apply`` / ``export`` / ``serve`` /
    ``cold_artifact_spec`` / ``training_param_count`` (plus the
    ``validate`` classmethod where the default doesn't fit).
    ``artifact_spec``, ``serving_artifact_struct``, ``serving_size_bits``
    and ``attach_hot_rows`` are derived — do not override them.
    """

    kind: str = "?"                    # set by @register_scheme
    # whether ``quantized_gather`` can row-shard the codes over a mesh
    supports_sharded_codes: bool = False

    def __init__(self, cfg):
        self.cfg = cfg

    # ------------------------------------------------------- class hooks
    @classmethod
    def validate(cls, cfg) -> None:
        """Kind-specific config validation (EmbeddingConfig.__post_init__
        calls this through the registry)."""

    @classmethod
    def variants(cls) -> Tuple[str, ...]:
        """Sub-variant labels for enumeration (the sharded gather's
        support list).  "-" means the scheme has no variants."""
        return ("-",)

    # --------------------------------------------------------- required
    def init(self, gen: torch.Generator, dtype: torch.dtype) -> dict:
        raise NotImplementedError

    def apply(self, params: dict, ids: torch.Tensor, mesh=None):
        """Training-path forward: ids (...,) -> (rows (..., d), aux
        loss scalar).  Under a ``mesh`` (``launch/mesh.py``) the params
        are this rank's (``sharding/rules.py``), the ids its data shard
        of the global ids, and every table is read as its placement
        left it (``core/dpq.py::row_gather``)."""
        raise NotImplementedError

    def export(self, params: dict) -> dict:
        raise NotImplementedError

    def serve(self, artifact: dict, ids: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def cold_artifact_spec(self):
        """Tree of :class:`ArtifactLeaf` matching the scheme's own
        ``export()`` leaf-for-leaf.  "Cold" because the optional
        hot-row cache leaf is composed on top by :meth:`artifact_spec`."""
        raise NotImplementedError

    def training_param_count(self) -> int:
        raise NotImplementedError

    # ------------------------------------------------- hot-row cache
    @property
    def hot_dtype(self) -> torch.dtype:
        """dtype of ``serve()``'s output rows (the hot block's dtype)."""
        return torch_dtype(self.cfg.param_dtype)

    def precompute_hot_rows(self, artifact: dict) -> torch.Tensor:
        """Decode-ahead block for the power-law head: the
        ``cfg.hot_rows`` hottest ids — ids ``< hot_rows``, valid because
        ids are frequency-sorted by convention — decoded through
        ``serve`` into a dense ``(hot_rows, dim)`` block on the
        artifact's device.  Derived from ``serve``, so every registered
        scheme supports the cache unedited."""
        return self.serve(artifact, _hot_ids(self.cfg.hot_rows, artifact))

    def attach_hot_rows(self, artifact: dict) -> dict:
        """The artifact with the ``hot`` leaf attached when the config
        asks for one (``Embedding.export`` calls this; ``artifact_spec``
        charges the leaf)."""
        if not self.cfg.hot_rows:
            return artifact
        return dict(artifact, hot=self.precompute_hot_rows(artifact))

    # ---------------------------------------------------------- derived
    def artifact_spec(self):
        """Full artifact spec: the cold spec plus, when ``cfg.hot_rows``
        > 0, the dense ``hot`` leaf the size accounting charges."""
        spec = self.cold_artifact_spec()
        if self.cfg.hot_rows:
            spec = dict(spec, hot=ArtifactLeaf(
                (self.cfg.hot_rows, self.cfg.dim), self.hot_dtype))
        return spec

    @property
    def variant_label(self) -> str:
        """Active variant for reporting ("" when the scheme has none)."""
        return ""

    def artifact_leaves(self) -> List[ArtifactLeaf]:
        return tree_leaves(self.artifact_spec())

    def serving_artifact_struct(self):
        """The artifact's structure as meta-device tensors (shape and
        dtype, no storage) — what ``export`` must produce."""
        return tree_map(
            lambda leaf: torch.empty(leaf.shape, dtype=leaf.dtype,
                                     device="meta"),
            self.artifact_spec())

    def artifact_shard_specs(self, model_axis: str = "model"):
        """Spec tree (``sharding/rules.py``): ``rows`` leaves row-sharded
        over ``model_axis``, everything else replicated ``()``."""
        if not self.supports_sharded_codes:
            raise ValueError(
                f"no quantized artifact for kind={self.kind!r}")
        return tree_map(
            lambda leaf: (model_axis,) + (None,) * (len(leaf.shape) - 1)
            if leaf.rows else (),
            self.artifact_spec())

    def serving_size_bits(self) -> int:
        """Paper §1.1/§3.5 serving-size accounting, summed over the
        artifact spec (packed code widths, dtype-true float widths)."""
        return sum(leaf.size_bits for leaf in self.artifact_leaves())


class QuantizedScheme(Scheme):
    """Base for codes+codebooks schemes (dpq, mgqe, rq, mpe).

    Serving decodes through a dispatched decode op: ``mgqe_decode``
    (dpq, mgqe), ``rq_decode_stages`` (rq) or ``packed_decode`` (mpe).
    The code tables may be row-sharded over a mesh's model axis; then
    ``serve`` goes through the sharded quantized gather."""

    supports_sharded_codes = True

    @property
    def code_dtype(self) -> torch.dtype:
        return torch.uint8 if self.cfg.num_centroids <= 256 else torch.int32

    def serve(self, artifact: dict, ids: torch.Tensor, mesh=None,
              model_axis: str = "model") -> torch.Tensor:
        """Rows of ``ids``.  With ``cfg.sharded_codes`` and a ``mesh``,
        ``artifact`` is this rank's (``shard_quantized_artifact``) and
        the rows come through ``quantized_gather`` (every rank passes
        the same ids and gets the same rows); otherwise one device
        decodes, as the JAX package does with no ambient mesh."""
        if self.cfg.sharded_codes and mesh is not None:
            from repro_torch.sharding.quantized import quantized_gather
            return quantized_gather(artifact, ids, self.cfg,
                                    model_axis=model_axis, mesh=mesh)
        return self.decode(artifact, ids)

    def precompute_hot_rows(self, artifact: dict) -> torch.Tensor:
        """Pinned to the single-device ``decode``: export happens before
        any placement, so the block is decoded where the codes are."""
        return self.decode(artifact, _hot_ids(self.cfg.hot_rows, artifact))

    def resolve_block_b(self, block_b) -> Optional[int]:
        """Map the ``decode`` block_b argument to a concrete value:
        :data:`PIN_TO_CONFIG` -> ``cfg.decode_block_b``; anything else
        (None = autotune cache, or an explicit int) passes through."""
        return self.cfg.decode_block_b if block_b is PIN_TO_CONFIG \
            else block_b

    def decode(self, artifact: dict, ids: torch.Tensor,
               tier_ids: Optional[torch.Tensor] = None,
               block_b=PIN_TO_CONFIG) -> torch.Tensor:
        """Decode ``ids`` against the artifact's code tables.
        ``tier_ids`` defaults to ``ids``; any frequency-rank-dependent
        blending keys on it.  ``block_b``: see :meth:`resolve_block_b`."""
        raise NotImplementedError


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------

_REGISTRY: Dict[str, Type[Scheme]] = {}


def register_scheme(kind: str):
    """Class decorator: register a Scheme under its kind string."""
    def deco(cls: Type[Scheme]) -> Type[Scheme]:
        prev = _REGISTRY.get(kind)
        if prev is not None and prev is not cls:
            raise ValueError(
                f"scheme kind {kind!r} already registered to {prev}")
        cls.kind = kind
        _REGISTRY[kind] = cls
        return cls
    return deco


def registered_kinds() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def scheme_class(kind: str) -> Type[Scheme]:
    try:
        return _REGISTRY[kind]
    except KeyError:
        raise KeyError(
            f"unknown embedding kind {kind!r}; registered schemes: "
            f"{', '.join(registered_kinds()) or '(none)'}") from None


def get_scheme(cfg) -> Scheme:
    """Resolve a config to its scheme instance."""
    return scheme_class(cfg.kind)(cfg)
