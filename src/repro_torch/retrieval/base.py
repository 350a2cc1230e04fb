"""Retrieval index protocol + registry.

An *index* is one way of organizing a PQ-coded corpus for batched
top-k retrieval: the exact flat scan (``flat_pq.py``) or the IVF
coarse partition (``ivf_pq.py``).  Each index is ONE class registered
under its ``IndexConfig.kind`` string:

    @register_index("ivf_pq")
    class IVFPQ(Index):
        ...

Every integration layer resolves indexes through this registry instead
of branching on kind strings — :class:`repro_torch.models.recsys.
two_tower.TwoTower` builds and queries through it and the
:class:`repro_torch.launch.engine.RetrievalEngine` serves through it.

The lifecycle is two-phase:

  * ``build(gen, vectors)`` — offline: corpus vectors -> artifact dict
    (codes + codebooks + whatever partition metadata the kind needs);
  * ``search(artifact, queries, k)`` — online: a BATCH of queries
    (B, d) -> ``(scores (B, k), ids (B, k))`` in one pass, through the
    dispatched ``pq_score`` kernel family.

Top-k ordering contract (all kinds, all backends): entries sorted by
(score desc, id asc); slots with fewer than ``k`` valid candidates
carry ``score = -inf, id = INVALID_ID`` (``retrieval/topk.py``).

A distributed corpus (``retrieval/sharded.py``) row-shards the
``rows_leaves`` over a mesh's ``model`` axis (``artifact_shard_specs``)
and merges every shard's ``local_topk``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Type

import torch

from repro_torch.core.types import KERNEL_BACKENDS


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Declarative description of one retrieval index, field for field
    the JAX package's.

    ``num_subspaces``/``num_centroids``/``iters`` parameterize the PQ
    codec (shared by every kind); ``nlist``/``nprobe``/``coarse_iters``/
    ``ivf_residual`` only matter to IVF kinds.  ``block_n`` is the
    candidate-block size of the scoring kernels: None (here the
    default) resolves through the autotune cache to each kernel's own
    default, since a CUDA block is not the TPU's; ``kernel_backend``
    pins the dispatch backend (None/auto = from the tensors' device).

    The scale knobs bound BUILD memory: ``train_sample`` fits the PQ
    codebooks on a row sample instead of the full corpus,
    ``encode_block`` runs the encoding over fixed-size row blocks;
    ``list_cap_quantile`` and ``host_staged`` belong to IVF.
    """

    kind: str = "flat_pq"
    num_subspaces: int = 8
    num_centroids: int = 256
    iters: int = 10
    nlist: int = 64
    nprobe: int = 8
    coarse_iters: int = 10
    ivf_residual: bool = False
    block_n: Optional[int] = None
    kernel_backend: Optional[str] = None
    # ---- streaming-build / at-scale knobs ----
    train_sample: int = 0       # rows to fit codebooks on; 0 = full corpus
    encode_block: int = 0       # rows per encode block; 0 = one shot
    list_cap_quantile: float = 0.95  # IVF list cap at this count quantile
    host_staged: bool = False   # serve list tables from host memory

    def __post_init__(self):
        if self.train_sample < 0 or self.encode_block < 0:
            raise ValueError(
                f"train_sample/encode_block must be >= 0, got "
                f"{self.train_sample}/{self.encode_block}")
        if not 0.0 < self.list_cap_quantile <= 1.0:
            raise ValueError(
                f"list_cap_quantile must be in (0, 1], got "
                f"{self.list_cap_quantile}")
        if self.kernel_backend not in (None,) + KERNEL_BACKENDS:
            raise ValueError(
                f"unknown kernel backend {self.kernel_backend!r}; "
                f"expected None or one of {KERNEL_BACKENDS}")
        cls = index_class(self.kind)   # raises on unknown kinds
        cls.validate(self)


def suggest_nlist(n: int, nprobe: int = 1) -> int:
    """Default IVF partition count for an ``n``-row corpus: nlist ≈ √N,
    clamped to [nprobe, n] (at least ``nprobe``, at most one cell per
    row)."""
    nlist = int(round(math.sqrt(max(n, 1))))
    return max(1, min(n, max(nprobe, nlist)))


class Index:
    """Protocol every retrieval index implements.

    Required overrides: ``build`` / ``search`` (plus the ``validate``
    / ``probe_config`` classmethods where the defaults don't fit).
    ``rows_leaves`` names the artifact keys whose leading dim is
    O(corpus).
    """

    kind: str = "?"                    # set by @register_index
    # artifact dict keys whose dim 0 is the corpus
    rows_leaves: Tuple[str, ...] = ()

    def __init__(self, cfg: IndexConfig):
        self.cfg = cfg

    # ------------------------------------------------------- class hooks
    @classmethod
    def validate(cls, cfg: IndexConfig) -> None:
        """Kind-specific config validation (IndexConfig.__post_init__
        calls this through the registry)."""

    @classmethod
    def probe_config(cls) -> IndexConfig:
        """A tiny IndexConfig for capability probing / conformance
        (build -> search must run in milliseconds)."""
        return IndexConfig(kind=cls.kind, num_subspaces=4,
                           num_centroids=8, iters=2, nlist=4, nprobe=2,
                           coarse_iters=2)

    def describe(self) -> str:
        """The kind's knobs for a build line ("" when it has none)."""
        return ""

    # --------------------------------------------------------- required
    def build(self, gen: torch.Generator, vectors: torch.Tensor) -> Dict:
        """Offline: corpus vectors (N, d) -> serving artifact dict."""
        raise NotImplementedError

    def search(self, artifact: Dict, queries: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched top-k: queries (B, d) -> (scores (B, k), ids (B, k))."""
        raise NotImplementedError

    # ---------------------------------------------------- host-staged
    # kinds that can keep their O(corpus) leaves in host memory and
    # stage only the rows a flush probes set this to True and implement
    # search_host_staged
    supports_host_staged: bool = False

    def host_leaves(self) -> Tuple[str, ...]:
        """Artifact keys that stay host-resident under host-staged
        serving — by default the O(corpus) row tables."""
        return self.rows_leaves

    def search_host_staged(self, artifact: Dict, queries: torch.Tensor,
                           k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Like ``search`` but the ``host_leaves()`` entries of
        ``artifact`` lie in host memory; implementations stage only the
        probed rows to the device, bit-identical to ``search``."""
        raise NotImplementedError(
            f"index kind {self.kind!r} has no host-staged serve path")

    # ------------------------------------------------------ distributed
    @property
    def supports_sharded(self) -> bool:
        return bool(self.rows_leaves)

    def artifact_shard_specs(self, artifact: Dict,
                             model_axis: str = "model") -> Dict:
        """Spec dict (``sharding/rules.py``): ``rows_leaves`` row-sharded
        over ``model_axis``, everything else replicated ``()``."""
        if not self.supports_sharded:
            raise ValueError(
                f"index kind {self.kind!r} cannot be distributed")
        return {name: (model_axis,) + (None,) * (leaf.dim() - 1)
                if name in self.rows_leaves else ()
                for name, leaf in artifact.items()}

    def local_topk(self, artifact: Dict, queries: torch.Tensor, k: int, *,
                   shard: int, num_shards: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Per-shard top-k over the LOCAL artifact rows (shard ``shard``
        of ``num_shards`` along the model axis) -> ``(scores, tiebreak,
        ids)``, each (B, k).  Ids must be GLOBAL and the tiebreak
        shard-invariant, so the partials merge (``merge_topk``) into the
        single-device search exactly."""
        raise NotImplementedError(
            f"index kind {self.kind!r} has no per-shard top-k")


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------

_REGISTRY: Dict[str, Type[Index]] = {}


def register_index(kind: str):
    """Class decorator: register an Index under its kind string."""
    def deco(cls: Type[Index]) -> Type[Index]:
        prev = _REGISTRY.get(kind)
        if prev is not None and prev is not cls:
            raise ValueError(
                f"index kind {kind!r} already registered to {prev}")
        cls.kind = kind
        _REGISTRY[kind] = cls
        return cls
    return deco


def registered_index_kinds() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def index_class(kind: str) -> Type[Index]:
    try:
        return _REGISTRY[kind]
    except KeyError:
        raise KeyError(
            f"unknown index kind {kind!r}; registered indexes: "
            f"{', '.join(registered_index_kinds()) or '(none)'}") from None


def get_index(cfg: IndexConfig) -> Index:
    """Resolve a config to its index instance."""
    return index_class(cfg.kind)(cfg)
