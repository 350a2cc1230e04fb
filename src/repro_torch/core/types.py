"""Configuration types for the embedding subsystem.

Every embedding scheme is described by a single frozen
:class:`EmbeddingConfig`, with the same fields and validation as the
JAX package's, so one set of numbers configures both.

Valid ``kind`` strings are whatever the scheme registry
(``repro_torch.core.schemes``) currently holds.  The registry is
imported lazily inside ``__post_init__`` (and the size-accounting
delegates) so this module stays importable without the scheme package.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# Kernel backends (mirrors repro_torch.kernels.dispatch.BACKENDS;
# duplicated so config types stay importable without the kernels).
KERNEL_BACKENDS = ("auto", "cuda", "torch")

# MGQE capacity-allocation variants (paper §2.2).
MGQE_VARIANTS = ("shared_k", "private_k", "private_d")


@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    """Declarative description of one embedding table.

    Attributes mirror the paper's notation: ``num_subspaces`` is D,
    ``num_centroids`` is K, ``tier_num_centroids`` is K-tilde,
    ``tier_num_subspaces`` is D-tilde.  ``tier_boundaries`` are item-id
    thresholds under the convention that ids are frequency-sorted
    (id 0 = most popular); tier of id x = number of boundaries <= x.
    """

    vocab_size: int
    dim: int
    kind: str = "full"

    # --- DPQ / MGQE ---
    num_subspaces: int = 8          # D
    num_centroids: int = 256        # K
    beta: float = 0.25              # commitment-loss weight (VQ-VAE style)
    mgqe_variant: str = "shared_k"  # paper's default: shared centroids, variable K
    tier_boundaries: Tuple[int, ...] = ()       # len m-1, ascending ids
    tier_num_centroids: Tuple[int, ...] = ()    # len m, non-increasing
    tier_num_subspaces: Tuple[int, ...] = ()    # len m, non-increasing (private_d)

    # --- mixed-precision packed codes (mpe) ---
    # per-tier code bitwidth (len m, non-increasing, each in {8, 4, 2});
    # tier i stores K_i = 2**tier_bits[i] centroids per subspace and its
    # codes bit-packed at tier_bits[i] bits per code (DESIGN.md §13)
    tier_bits: Tuple[int, ...] = ()

    # --- residual quantization (rq) ---
    num_levels: int = 4             # M sequential full-width codebooks

    # --- low-rank factorization baseline ---
    rank: int = 16

    # --- scalar quantization baseline ---
    sq_bits: int = 8

    # --- hashing-trick baseline ---
    hash_buckets: int = 0

    # parameter dtype for the dense tables ("float32" | "bfloat16")
    param_dtype: str = "float32"

    # the JAX package's switch for its model-parallel row gather; in the
    # port a table's placement under a mesh decides how it is read
    # (core/dpq.py::row_gather), so the flag is kept for parity only
    sharded_rows: bool = False

    # serving code tables row-sharded over a mesh's model axis: serve
    # goes through sharding/quantized.py when given a mesh
    sharded_codes: bool = False

    # hot-row decode-ahead cache: the ``hot_rows`` hottest ids decoded
    # ahead into a dense block at export.  The size accounting counts
    # it; exporting with it raises until the hot-row slice in
    # ROADMAP.md.  0 disables the cache.
    hot_rows: int = 0

    # kernel backend for the export and serving ops: "auto" defers to
    # the REPRO_TORCH_KERNEL_BACKEND env var when set, else follows the
    # tensors' device (CUDA kernel on the card, plain PyTorch on the
    # CPU).  A concrete value here pins the backend regardless of the
    # env var.
    kernel_backend: str = "auto"

    # threads a block of the decode kernels; the serving engine pads
    # every flush to a multiple of it.
    decode_block_b: int = 256

    def __post_init__(self):
        from repro_torch.core.schemes import registered_kinds, scheme_class
        try:
            scheme = scheme_class(self.kind)
        except KeyError:
            raise ValueError(
                f"unknown embedding kind {self.kind!r}; registered "
                f"schemes: {', '.join(registered_kinds())}") from None
        if self.kernel_backend not in KERNEL_BACKENDS:
            raise ValueError(
                f"unknown kernel backend {self.kernel_backend!r}; "
                f"expected one of {KERNEL_BACKENDS}")
        if not 0 <= self.hot_rows <= self.vocab_size:
            raise ValueError(
                f"hot_rows must lie in [0, vocab_size], got "
                f"{self.hot_rows} for vocab_size={self.vocab_size}")
        scheme.validate(self)

    # ------------------------------------------------------------------
    @property
    def num_tiers(self) -> int:
        return len(self.tier_boundaries) + 1

    @property
    def subspace_dim(self) -> int:
        return self.dim // self.num_subspaces

    def tier_sizes(self) -> Tuple[int, ...]:
        """Number of vocabulary rows in each tier."""
        edges = (0,) + tuple(self.tier_boundaries) + (self.vocab_size,)
        return tuple(edges[i + 1] - edges[i] for i in range(len(edges) - 1))

    # ------------------------------------------------------------------
    # Size accounting (paper §1.1/§3.5) — delegated to the scheme,
    # which derives it from its artifact spec (core/schemes/base.py).
    # ------------------------------------------------------------------
    def serving_size_bits(self) -> int:
        from repro_torch.core.schemes import get_scheme
        return get_scheme(self).serving_size_bits()

    def training_param_count(self) -> int:
        """Dense parameters alive during training (full table included)."""
        from repro_torch.core.schemes import get_scheme
        return get_scheme(self).training_param_count()
