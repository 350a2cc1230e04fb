"""Config dataclasses for the LM, GNN and recsys families + input-shape
specs.

Each architecture file in this package exports ``CONFIG`` (full scale)
and ``smoke_config()`` (reduced, runs on the CPU).  Field for field the
same as the JAX package's, so one set of numbers configures both.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.types import EmbeddingConfig


# ----------------------------------------------------------------------
# LM family
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # attention pattern ------------------------------------------------
    sliding_window: Optional[int] = None   # window for local/SWA layers
    local_global_pattern: int = 0          # gemma3: 5 locals per global; 0 = uniform
    rope_theta: float = 10_000.0           # uniform / local-layer theta
    rope_theta_global: float = 1_000_000.0  # global-layer theta (pattern models)

    # MoE (nn/moe.py; moe_shard_map waits for the distributed layer) --
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    moe_shard_map: bool = False

    # embedding compression (the paper's technique) ----------------------
    embedding: Optional[EmbeddingConfig] = None  # None -> plain full table
    embed_kind: str = "mgqe"               # used when building default cfg

    # numerics / training ------------------------------------------------
    # GQA KV-head replication: repeat K/V up to num_heads inside
    # layer_forward (the JAX package's answer to TP meshes wider than
    # num_kv_heads; on one card it only costs memory)
    attn_kv_repeat: bool = False

    act: str = "gelu"
    dtype: str = "bfloat16"                # activation dtype
    param_dtype: str = "float32"           # bf16 for the >=27B archs
    fsdp_params: bool = False              # shard stacked weights over data
    remat: bool = True
    remat_granularity: str = "layer"
    remat_block: int = 0                   # 0 = auto (~sqrt(L))
    # KV chunk of the JAX package's chunked attention; the port's chunked
    # route is the flash_attention kernel, whose tiles are its own
    attention_block: int = 1024
    attention_impl: str = "auto"           # auto | dense | chunked
    xent_chunk: int = 512                  # seq chunk for vocab softmax
    # serving
    split_local_global_cache: bool = False  # beyond-paper memory opt

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_pattern(self) -> bool:
        return self.local_global_pattern > 0

    def param_count(self) -> int:
        """Approximate dense parameter count N (for MODEL_FLOPS = 6ND)."""
        hd = self.resolved_head_dim
        attn = self.d_model * hd * (self.num_heads * 2 + self.num_kv_heads * 2)
        if self.is_moe:
            ffn = 3 * self.d_model * self.d_ff * self.num_experts \
                + self.d_model * self.num_experts
        else:
            ffn = 3 * self.d_model * self.d_ff
        per_layer = attn + ffn + 2 * self.d_model
        emb = self.vocab_size * self.d_model
        head = self.vocab_size * self.d_model
        return self.num_layers * per_layer + emb + head

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.param_count()
        hd = self.resolved_head_dim
        attn = self.d_model * hd * (self.num_heads * 2 + self.num_kv_heads * 2)
        ffn = 3 * self.d_model * self.d_ff * self.num_experts_per_tok \
            + self.d_model * self.num_experts
        per_layer = attn + ffn + 2 * self.d_model
        return (self.num_layers * per_layer
                + 2 * self.vocab_size * self.d_model)


# ----------------------------------------------------------------------
# GNN (MACE)
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    num_layers: int = 2
    d_hidden: int = 128
    l_max: int = 2
    correlation_order: int = 3
    n_rbf: int = 8
    r_cut: float = 5.0
    num_species: int = 100
    d_readout: int = 16
    dtype: str = "float32"


# ----------------------------------------------------------------------
# RecSys family
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    model: str                      # autoint | deepfm | two_tower | bst
    n_sparse: int = 39
    embed_dim: int = 16
    field_vocab_sizes: Tuple[int, ...] = ()   # len n_sparse
    # embedding compression spec applied to *large* fields
    embed_kind: str = "mgqe"
    mgqe_min_vocab: int = 10_000    # fields smaller than this stay full
    # kernel backend for the export and serving ops (auto | cuda |
    # torch); $REPRO_TORCH_KERNEL_BACKEND overrides "auto"
    kernel_backend: str = "auto"
    # sets the large fields' ``sharded_rows`` (kept for parity: in the
    # port the recsys rules' placement decides, sharding/rules.py)
    sharded_embedding: bool = False
    num_subspaces: int = 8
    num_centroids: int = 256
    tier_head_fraction: float = 0.1
    tier_tail_centroids: int = 64
    # autoint
    n_attn_layers: int = 3
    n_attn_heads: int = 2
    d_attn: int = 32
    # deepfm / bst / two-tower MLPs
    mlp_dims: Tuple[int, ...] = (400, 400, 400)
    # two-tower
    tower_mlp: Tuple[int, ...] = (1024, 512, 256)
    n_items: int = 10_000_000       # retrieval corpus size
    n_users: int = 50_000_000
    # bst
    seq_len: int = 20
    n_blocks: int = 1
    bst_heads: int = 8
    dtype: str = "float32"


# ----------------------------------------------------------------------
# Input-shape specs
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode | graph_full | graph_mini
                         # | rec_train | rec_serve | rec_retrieval
    # LM
    seq_len: int = 0
    global_batch: int = 0
    # GNN
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_graphs: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    # recsys
    batch: int = 0
    n_candidates: int = 0


LM_SHAPES = (
    ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
    ShapeSpec("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    ShapeSpec("decode_32k", "decode", seq_len=32768, global_batch=128),
    ShapeSpec("long_500k", "decode", seq_len=524288, global_batch=1),
)

GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "graph_full", n_nodes=2708, n_edges=10556,
              d_feat=1433),
    ShapeSpec("minibatch_lg", "graph_mini", n_nodes=232965,
              n_edges=114615892, batch_nodes=1024, fanout=(15, 10)),
    ShapeSpec("ogb_products", "graph_full", n_nodes=2449029,
              n_edges=61859140, d_feat=100),
    ShapeSpec("molecule", "graph_batched", n_nodes=30, n_edges=64,
              batch_graphs=128),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "rec_train", batch=65536),
    ShapeSpec("serve_p99", "rec_serve", batch=512),
    ShapeSpec("serve_bulk", "rec_serve", batch=262144),
    ShapeSpec("retrieval_cand", "rec_retrieval", batch=1,
              n_candidates=1_000_000),
)
