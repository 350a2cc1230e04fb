"""Decoder-only LM family: the dense archs (stablelm-3b, gemma3-4b,
gemma3-27b) and the mixture-of-experts archs (mixtral-8x7b,
qwen3-moe-30b-a3b).

The JAX package's ``models/lm.py``, for training and serving:

* Layers are **stacked**: each parameter of a layer group is one tensor
  with the layers on its leading dims (the JAX package's layout, so
  params carry across leaf for leaf).  Where JAX drives a stack with
  ``lax.scan``, a Python loop walks it here; sliding window and RoPE
  theta are per-layer scalars, so local and global layers share one
  layer function.
* gemma3's 5:1 local:global pattern keeps its "pattern" layout —
  groups of (p locals + 1 global), ``loc`` (G, p, ...), ``glob``
  (G, ...) and the remainder ``rem`` — which is what makes the **split
  KV cache** possible: local layers keep a window-sized ring buffer,
  global layers a full-length cache.
* The token-embedding table goes through ``repro_torch.core``:
  ``embed_artifact`` (codes + centroids) is the paper's serving path.
* Full-sequence attention takes ``attention_impl``: ``dense`` up to
  1,024 tokens under ``auto``, else ``chunked`` — on the card the
  flash_attention kernel.
* An MoE config's layers hold ``moe`` (``nn/moe.py``) in place of
  ``ffn``; its FFN returns the router's aux loss, summed over layers.
* Training: ``forward`` rematerialises as JAX's does (``remat``, at the
  granularity of a layer, a pattern group or ``remat_block`` layers; a
  ``torch.utils.checkpoint`` where JAX has ``jax.checkpoint``), and
  ``loss_fn`` takes the vocab softmax in sequence chunks, each
  recomputed in the backward, so the (B, S, V) logits never exist.
  Attention's backward is ``attend``'s recompute through the plain
  version.
* On a mesh (``mesh=``, ``launch/mesh.py``) ``forward`` and ``loss_fn``
  run one rank's share of the step on the params as
  ``sharding/rules.py::lm_param_rules`` place them, with explicit
  collectives (``sharding/collectives.py``): the token rows through the
  model-parallel row gather; ``wq``/``wk``/``wv``, ``w_gate``/``w_up``
  column-parallel and ``wo``/``w_down`` row-parallel over ``model``
  (this rank's heads, or K/V expanded to every head and this rank's
  taken where ``wk``/``wv`` stay whole); norms replicated; the MoE
  block's grouped dispatch (``moe_shard_map``) on this rank's slice of
  the sequence under the expert strategy, else the global
  formulation; the vocab softmax over ``lm_head``'s column block; and
  under FSDP each layer's weights gathered over ``data`` as the layer
  runs (again in the remat recompute).  Without a mesh nothing
  changes, bit for bit.
* Served on a mesh (``prefill``, ``make_cache``, ``decode_step`` with
  ``mesh=``; ``launch/cells.py::lm_prefill_cell``/``lm_decode_cell``)
  each rank holds its block of the KV cache as
  ``sharding/rules.py::lm_cache_spec`` places it: its batch rows with
  its kv heads, or — where the kv heads do not divide over ``model`` —
  every kv head over its block of the cache's slots, whose attention
  the ranks merge (``nn/attention.py::decode_attention_split``).  The
  token rows come from this rank's block of the served codes; the
  decode layer is tensor-parallel as training's; the last token's
  logits are gathered over ``model``.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.core import Embedding
from repro_torch.core.schemes.base import torch_dtype
from repro_torch.nn import attention as attn
from repro_torch.nn import initializers as init
from repro_torch.nn import moe as moe_lib
from repro_torch.nn.mlp import glu_ffn
from repro_torch.nn.norm import rms_norm
from repro_torch.nn.rope import apply_rope
from repro_torch.sharding import collectives as coll


# ----------------------------------------------------------------------
# layer plan: per-layer (window, theta)
# ----------------------------------------------------------------------

def layer_windows(cfg: LMConfig, max_seq: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(windows (L,) int32, thetas (L,) float32) for the uniform layout.

    Pattern models: layer i is global iff (i % (p+1)) == p.
    Uniform SWA models: every layer windowed.
    """
    n = cfg.num_layers
    if cfg.is_pattern:
        p = cfg.local_global_pattern
        is_global = (torch.arange(n) % (p + 1)) == p
        win = torch.where(is_global, attn.FULL_WINDOW,
                          int(cfg.sliding_window))
        theta = torch.where(is_global, cfg.rope_theta_global, cfg.rope_theta)
        return win.to(torch.int32), theta.to(torch.float32)
    w = attn.FULL_WINDOW if cfg.sliding_window is None else cfg.sliding_window
    return (torch.full((n,), w, dtype=torch.int32),
            torch.full((n,), cfg.rope_theta, dtype=torch.float32))


def cache_len_for_layer(cfg: LMConfig, window: int, max_seq: int) -> int:
    """Slots a layer's decode cache needs."""
    if window >= max_seq:
        return max_seq
    return window


# ----------------------------------------------------------------------
# parameters: shapes, init
# ----------------------------------------------------------------------

def _layer_spec(cfg: LMConfig) -> dict:
    """One layer's leaves as (shape, init stddev); stddev 0 is zeros.
    An MoE layer holds ``moe`` in place of ``ffn``."""
    hd, d, f = cfg.resolved_head_dim, cfg.d_model, cfg.d_ff
    s = d ** -0.5
    spec = {
        "wq": ((d, cfg.num_heads * hd), s),
        "wk": ((d, cfg.num_kv_heads * hd), s),
        "wv": ((d, cfg.num_kv_heads * hd), s),
        "wo": ((cfg.num_heads * hd, d), (cfg.num_heads * hd) ** -0.5),
        "ln1": {"scale": ((d,), 0.0)},
        "ln2": {"scale": ((d,), 0.0)},
    }
    if cfg.is_moe:
        spec["moe"] = moe_lib.moe_spec(d, f, cfg.num_experts)
    else:
        spec["ffn"] = {"w_gate": ((d, f), s), "w_up": ((d, f), s),
                       "w_down": ((f, d), f ** -0.5)}
    return spec


def _stacks(cfg: LMConfig) -> Dict[str, Tuple[int, ...]]:
    """Leading dims of each layer stack: ``layers`` (L,), or the
    pattern layout's ``loc`` (G, p), ``glob`` (G,) and ``rem`` (r,)."""
    if not cfg.is_pattern:
        return {"layers": (cfg.num_layers,)}
    p = cfg.local_global_pattern
    g, r = divmod(cfg.num_layers, p + 1)
    out = {"loc": (g, p), "glob": (g,)}
    if r:
        out["rem"] = (r,)
    return out


def param_spec(cfg: LMConfig) -> dict:
    """Every non-embedding leaf as (shape, init stddev), in the JAX
    package's layout."""
    layer = _layer_spec(cfg)

    def stacked(lead, tree):
        if isinstance(tree, dict):
            return {k: stacked(lead, v) for k, v in tree.items()}
        shape, std = tree
        return (lead + shape, std)

    spec = {"final_norm": {"scale": ((cfg.d_model,), 0.0)},
            "lm_head": ((cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5)}
    for name, lead in _stacks(cfg).items():
        spec[name] = stacked(lead, layer)
    return spec


def model_init(gen: torch.Generator, cfg: LMConfig, dtype=None,
               place=None) -> dict:
    """Params on the generator's device, ``dtype`` defaulting to
    ``cfg.param_dtype`` (each table drawn and scaled in place).
    ``place(path, leaf)``, when given, replaces each leaf as soon as it
    is drawn ("lm_head", "layers/ffn/w_up", "embed/emb"; e.g. by this
    rank's block of it), so no more than one whole leaf exists at a
    time; the draws are the same."""
    dtype = dtype or torch_dtype(cfg.param_dtype)
    spec = param_spec(cfg)
    emb = Embedding(cfg.embedding, device=gen.device)
    place = place or (lambda path, t: t)

    def build(tree, path):
        if isinstance(tree, dict):
            return {k: build(v, f"{path}/{k}" if path else k)
                    for k, v in tree.items()}
        shape, std = tree
        if std == 0.0:
            return place(path, torch.zeros(shape, dtype=dtype,
                                           device=gen.device))
        return place(path, init.normal(gen, shape, std, dtype))

    def placed(tree, path):
        if isinstance(tree, dict):
            return {k: placed(v, f"{path}/{k}") for k, v in tree.items()}
        if isinstance(tree, list):
            return [placed(v, f"{path}/{i}") for i, v in enumerate(tree)]
        return place(path, tree)

    params = {"embed": placed(emb.init(gen, dtype=dtype), "embed")}
    params.update(build(spec, ""))
    return params


def _index(tree, *idx):
    """One layer's params: every leaf of a stack indexed at ``idx``."""
    if isinstance(tree, dict):
        return {k: _index(v, *idx) for k, v in tree.items()}
    return tree[idx]


def _unstack(tree, lead: Tuple[int, ...]) -> List[dict]:
    """A stack's layers' params in row-major order of its leading dims
    ``lead``, every leaf unbound once: the backward stacks each leaf's
    layer gradients in one copy, where indexing layer by layer would
    add a zero-padded gradient of the whole stack for every layer."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, lead) for k, v in tree.items()}
        return [{k: sub[i] for k, sub in subs.items()}
                for i in range(math.prod(lead))]
    return tree.reshape((-1,) + tuple(tree.shape[len(lead):])).unbind(0)


# ----------------------------------------------------------------------
# single layer
# ----------------------------------------------------------------------

def _qkv(p, x, cfg: LMConfig, mesh=None):
    """(q, k, v, kv_of): q of this rank's heads; k and v either the kv
    heads of exactly those heads (``kv_of`` None: one device, or
    ``wk``/``wv`` split on whole heads) or every kv head, ``kv_of`` then
    the index of each of this rank's query heads' kv head."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    kv = cfg.num_kv_heads
    if mesh is None or mesh.shape["model"] == 1:
        q = (x @ p["wq"].to(x.dtype)).reshape(b, s, cfg.num_heads, hd)
        k = (x @ p["wk"].to(x.dtype)).reshape(b, s, kv, hd)
        v = (x @ p["wv"].to(x.dtype)).reshape(b, s, kv, hd)
        return q, k, v, None
    # column-parallel: this rank's heads, its kv heads with them
    model_n = mesh.shape["model"]
    heads = cfg.num_heads // model_n
    x = coll.copy_to(x, mesh, "model")
    if _heads_cut(cfg, mesh):
        # wq's columns split inside a head: every rank's gathered, q holds
        # every head; so do k and v (the kv heads cannot divide either)
        q = coll.all_gather_grad(x @ p["wq"].to(x.dtype), mesh, "model",
                                 dim=-1).reshape(b, s, cfg.num_heads, hd)
    else:
        q = (x @ p["wq"].to(x.dtype)).reshape(b, s, heads, hd)
    if p["wk"].shape[-1] != kv * hd:
        k = x @ p["wk"].to(x.dtype)
        v = x @ p["wv"].to(x.dtype)
        if kv % model_n == 0:
            return q, k.reshape(b, s, -1, hd), v.reshape(b, s, -1, hd), None
        # columns split inside a head (sharding/rules.py's check_lm_leaf
        # lets it through): every rank's columns gathered, k's and v's in
        # one collective
        cols = k.shape[-1]
        kv_all = coll.all_gather_grad(torch.cat([k, v], -1), mesh, "model",
                                      dim=-1).reshape(b, s, model_n, 2, cols)
        k = kv_all[:, :, :, 0].reshape(b, s, kv * hd)
        v = kv_all[:, :, :, 1].reshape(b, s, kv * hd)
        if _heads_cut(cfg, mesh):
            return q, k.reshape(b, s, kv, hd), v.reshape(b, s, kv, hd), None
    else:
        # wk/wv whole (attn_kv_repeat, or columns that do not split); the
        # weights' gradient is summed over the model axis
        k = x @ coll.copy_to(p["wk"], mesh, "model").to(x.dtype)
        v = x @ coll.copy_to(p["wv"], mesh, "model").to(x.dtype)
        if _heads_cut(cfg, mesh):
            return q, k.reshape(b, s, kv, hd), v.reshape(b, s, kv, hd), None
    first = coll.axis_index(mesh, "model") * heads
    kv_of = torch.arange(first, first + heads, device=x.device) // (
        cfg.num_heads // kv)
    return q, k.reshape(b, s, kv, hd), v.reshape(b, s, kv, hd), kv_of


def _heads_cut(cfg: LMConfig, mesh) -> bool:
    """Whether ``lm_param_rules`` splits ``wq``'s columns inside a head
    (the heads do not divide over ``model``): a rank's layer then holds
    every head of q and keeps its column block of the attention's output
    for its rows of ``wo``."""
    return mesh is not None and cfg.num_heads % mesh.shape["model"] != 0


def _seq_over_model(cfg: LMConfig, mesh) -> bool:
    """Whether ``lm_cache_spec`` puts the cache's sequence over ``model``
    (the kv heads do not divide over it)."""
    return mesh is not None and cfg.num_kv_heads % mesh.shape["model"] != 0


def _cached_heads(k, v, cfg: LMConfig, mesh, kv_of):
    """The kv heads this rank's cache keeps of a layer's (k, v): its
    block of them where ``lm_cache_spec`` puts them over ``model``, else
    every one (the sequence is split instead)."""
    if mesh is None or kv_of is None or _seq_over_model(cfg, mesh):
        return k, v
    return (coll.block(k, mesh, "model", 2).contiguous(),
            coll.block(v, mesh, "model", 2).contiguous())


def _ffn_block(p, x, cfg: LMConfig, mesh=None):
    if cfg.is_moe:
        kw = dict(top_k=cfg.num_experts_per_tok,
                  capacity_factor=cfg.moe_capacity_factor)
        # the grouped dispatch for full sequences (train/prefill), as
        # JAX's shard_map; decode (S == 1) keeps the global formulation
        if cfg.moe_shard_map and x.shape[1] > 1:
            if mesh is None:
                raise ValueError(
                    f"{cfg.name}: moe_shard_map dispatches token groups "
                    f"over a mesh: pass mesh= to forward/loss_fn (or set "
                    f"moe_shard_map=False for the single-device moe_ffn)")
            if not moe_lib.expert_parallel(cfg.num_experts,
                                           mesh.shape["model"]):
                return moe_lib.moe_ffn_sharded(p["moe"], x, mesh=mesh, **kw)
            # the expert strategy's groups: this rank's slice of the
            # sequence, the outputs gathered back over the model axis
            out, aux = moe_lib.moe_ffn_sharded(
                p["moe"], coll.scatter_to(x, mesh, "model", 1), mesh=mesh,
                **kw)
            return coll.gather_from(out, mesh, "model", 1), aux
        return moe_lib.moe_ffn(p["moe"], x, mesh=mesh, **kw)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if mesh is None:
        return glu_ffn(p["ffn"], x, act=cfg.act), zero
    # column-parallel w_gate/w_up, row-parallel w_down
    out = glu_ffn(p["ffn"], coll.copy_to(x, mesh, "model"), act=cfg.act)
    return coll.reduce_from(out, mesh, "model"), zero


def _fsdp_gather(p: dict, dims: dict, mesh) -> dict:
    """One layer's params with each leaf that FSDP splits over ``data``
    (``dims``: its name -> the split dim, nested as ``p``) gathered
    whole over ``data``; backward, a reduce-scatter."""
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out[k] = _fsdp_gather(v, dims.get(k, {}), mesh)
        elif k in dims:
            out[k] = coll.all_gather_grad(v, mesh, "data", dim=dims[k])
        else:
            out[k] = v
    return out


def layer_forward(p: dict, x: torch.Tensor, positions: torch.Tensor,
                  window, theta, cfg: LMConfig, collect_kv: bool = False,
                  mesh=None, fsdp_dims: Optional[dict] = None):
    """Full-sequence layer (train / prefill).  With a ``mesh``, one rank's
    share over its placed params (the module docstring); ``fsdp_dims``
    names the leaves FSDP splits over ``data`` (:func:`mesh_plan`).

    Returns (y, aux) or (y, aux, (k, v)) when collect_kv.
    """
    if fsdp_dims:
        p = _fsdp_gather(p, fsdp_dims, mesh)
    h = rms_norm(p["ln1"], x)
    q, k, v, kv_of = _qkv(p, h, cfg, mesh)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    if collect_kv and mesh is not None:
        cached = _cached_heads(k, v, cfg, mesh, kv_of)
    if kv_of is not None:                 # each query head's kv head
        k, v = k[:, :, kv_of], v[:, :, kv_of]
    if cfg.attn_kv_repeat and k.shape[2] < q.shape[2]:
        g = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    s = x.shape[1]
    impl = cfg.attention_impl
    if impl == "auto":
        # dense materializes (Sq, Skv) f32 scores per head — only safe
        # for short sequences; chunked is the flash_attention kernel
        impl = "dense" if s <= 1024 else "chunked"
    if impl == "dense":
        o = attn.dense_attention(q, k, v, positions, positions, window)
    else:
        o = attn.chunked_attention(q, k, v, positions, positions, window,
                                   block=cfg.attention_block)
    o = o.reshape(x.shape[0], s, -1)
    if _heads_cut(cfg, mesh):             # this rank's columns of o
        o = coll.block(o, mesh, "model", -1)
    o = o @ p["wo"].to(x.dtype)
    if mesh is not None:                  # row-parallel
        o = coll.reduce_from(o, mesh, "model")
    x = x + o
    h2 = rms_norm(p["ln2"], x)
    f, aux = _ffn_block(p, h2, cfg, mesh)
    y = x + f
    if collect_kv:
        return y, aux, (k, v) if mesh is None else cached
    return y, aux


def layer_decode(p: dict, x: torch.Tensor, pos: int, window, theta,
                 k_cache, v_cache, kpos_cache, cfg: LMConfig, mesh=None,
                 fsdp_dims: Optional[dict] = None, seq_axes=None,
                 cache_len: Optional[int] = None):
    """One-token layer step.  x: (B, 1, d).  Returns (y, caches); the
    caches are updated in place.

    With a ``mesh``, one rank's share over its placed params and its
    block of the caches (``lm_cache_spec``): column-parallel q/k/v,
    row-parallel ``wo`` and FFN.  ``seq_axes`` are the axes the cache's
    sequence is split over (default: ``model`` where the kv heads do not
    divide over it, else none; :func:`decode_step` reads them off the
    cache's specs) and ``cache_len`` its whole slots: the blocks'
    attention is merged over them (``attention.decode_attention_split``;
    a ``kpos`` split with the K/V takes the position from ``pos``).
    Where this rank's cache holds every kv head but its q only its own
    heads, the query heads are gathered over ``model`` first and this
    rank's kept after."""
    if fsdp_dims:
        p = _fsdp_gather(p, fsdp_dims, mesh)
    h = rms_norm(p["ln1"], x)
    q, k, v, kv_of = _qkv(p, h, cfg, mesh)
    pos_arr = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos_arr, theta)
    k = apply_rope(k, pos_arr, theta)     # rotate BEFORE caching
    k, v = _cached_heads(k, v, cfg, mesh, kv_of)
    if seq_axes is None:
        seq_axes = ("model",) if _seq_over_model(cfg, mesh) else ()
    k_cache, v_cache, kpos_cache = attn.cache_update(
        k_cache, v_cache, kpos_cache, k, v, pos, mesh=mesh,
        axis=seq_axes or "model", cache_len=cache_len)
    # every kv head cached here, this rank's query heads alone in q
    all_heads = mesh is not None and _seq_over_model(cfg, mesh)
    if all_heads and not _heads_cut(cfg, mesh):
        q = coll.all_gather(q, mesh, "model", dim=2)
    if seq_axes:
        whole_kpos = kpos_cache.shape[-1] != k_cache.shape[1]
        o = attn.decode_attention_split(
            q, k_cache, v_cache, kpos_cache, window, mesh, seq_axes,
            qpos=None if whole_kpos else pos)
    else:
        o = attn.decode_attention(q, k_cache, v_cache, kpos_cache, window)
    o = o.reshape(x.shape[0], 1, -1)
    if all_heads:                         # this rank's heads' columns
        o = coll.block(o, mesh, "model", -1)
    o = o @ p["wo"].to(x.dtype)
    if mesh is not None:                  # row-parallel
        o = coll.reduce_from(o, mesh, "model")
    x = x + o
    h2 = rms_norm(p["ln2"], x)
    f, _ = _ffn_block(p, h2, cfg, mesh)
    return x + f, k_cache, v_cache, kpos_cache


# ----------------------------------------------------------------------
# forward trunk (train / prefill)
# ----------------------------------------------------------------------

def _layer_plan(cfg: LMConfig, s: int):
    """The layers in order: (stack name, index, window, theta)."""
    if not cfg.is_pattern:
        windows, thetas = layer_windows(cfg, s)
        return [("layers", (i,), w, t) for i, (w, t) in
                enumerate(zip(windows.tolist(), thetas.tolist()))]
    stacks = _stacks(cfg)
    w_loc, w_glob = int(cfg.sliding_window), attn.FULL_WINDOW
    plan = []
    for gi in range(stacks["glob"][0]):
        plan += [("loc", (gi, li), w_loc, cfg.rope_theta)
                 for li in range(cfg.local_global_pattern)]
        plan.append(("glob", (gi,), w_glob, cfg.rope_theta_global))
    plan += [("rem", (ri,), w_loc, cfg.rope_theta)
             for ri in range(stacks.get("rem", (0,))[0])]
    return plan


def _remat_segments(cfg: LMConfig, plan: list, collect_kv: bool
                    ) -> List[Tuple[list, bool]]:
    """The layer plan cut into (layers, checkpointed) runs, as the JAX
    package's ``forward`` places ``jax.checkpoint``: none without
    ``remat`` or with ``collect_kv`` (prefill); one per layer at
    granularity ``layer``; at ``group``, one per (p locals + 1 global)
    group of the pattern layout (its remainder layers unwrapped) or one
    per ``remat_block`` layers of the uniform layout (0: round(√L),
    lowered until it divides L)."""
    if not cfg.remat or collect_kv:
        return [(plan, False)]
    if cfg.remat_granularity != "group":
        return [([entry], True) for entry in plan]
    if cfg.is_pattern:
        size = cfg.local_global_pattern + 1
        n_grouped = (cfg.num_layers // size) * size
        segments = [(plan[i:i + size], True)
                    for i in range(0, n_grouped, size)]
        if n_grouped < len(plan):
            segments.append((plan[n_grouped:], False))
        return segments
    blk = cfg.remat_block or max(1, int(round(cfg.num_layers ** 0.5)))
    while cfg.num_layers % blk:
        blk -= 1
    return [(plan[i:i + blk], True) for i in range(0, len(plan), blk)]


def _meta(tree):
    """``param_spec``-style (shape, std) leaves as meta tensors."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree[0], device="meta")


@functools.lru_cache(maxsize=16)
def mesh_plan(cfg: LMConfig, mesh) -> Tuple[dict, dict]:
    """(FSDP dims, local shapes) of ``cfg``'s params on ``mesh`` under
    ``lm_param_rules``: for one layer, each leaf that FSDP splits over
    ``data`` -> its split dim (nested as the layer's params); for every
    leaf but the embedding's, its path -> the shape of a rank's block.
    Cached per (config, mesh): a decode step reads it every call; the
    results are not to be changed."""
    from repro_torch.sharding.rules import lm_param_rules, spec_tree
    rules = lm_param_rules(cfg, mesh)
    layer = spec_tree({"layers": _meta(_layer_spec(cfg))}, rules)["layers"]

    def fsdp(tree):
        if isinstance(tree, dict):
            out = {k: fsdp(v) for k, v in tree.items()}
            return {k: v for k, v in out.items() if v != {}}
        if mesh.shape["data"] == 1 or "data" not in tree:
            return {}
        return tree.index("data")

    def local(path, t, spec):
        shape = list(t.shape)
        for dim, axes in enumerate(spec):
            for a in (() if axes is None else
                      (axes,) if isinstance(axes, str) else axes):
                shape[dim] //= mesh.shape[a]
        shapes[path] = tuple(shape)

    template = _meta(param_spec(cfg))
    specs = spec_tree(template, rules)
    shapes: Dict[str, tuple] = {}

    def walk(t, sp, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], sp[k], f"{path}/{k}" if path else k)
        else:
            local(path, t, sp)
    walk(template, specs, "")
    return fsdp(layer), shapes


def _check_placed(params: dict, shapes: dict, mesh) -> None:
    """Raise unless every non-embedding leaf is this rank's block."""
    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}" if path else k)
        elif tuple(t.shape) != shapes[path]:
            raise ValueError(
                f"{path}: {tuple(t.shape)} is not a rank's block "
                f"{shapes[path]} under lm_param_rules on mesh {mesh.shape} "
                f"(place the params with lm_train_cell)")
    walk({k: v for k, v in params.items() if k != "embed"}, "")


def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig,
            collect_kv: bool = False,
            embed_artifact: Optional[dict] = None, mesh=None):
    """tokens (B, S) -> (hidden (B, S, d), aux, kv_stacks | None).

    kv_stacks (when collect_kv): per stack, (k, v) with the stack's
    leading dims, the layout of the decode cache; used by prefill.

    embed_artifact: serving-time quantized embedding (codes+centroids);
    when given, the full table in params is never touched (paper Fig 1).

    Under autograd with ``cfg.remat``, each segment of
    :func:`_remat_segments` keeps only its input and recomputes its
    layers in the backward.

    With a ``mesh``, ``params`` are this rank's blocks, ``tokens`` its
    data shard and the hidden states come out replicated over ``model``
    (the module docstring).  ``embed_artifact`` is then this rank's
    (``sharding/rules.py::lm_artifact_specs``: its block of the codes),
    read through the sharded gather's per-rank form; each layer's K/V
    come out as ``lm_cache_spec`` places the cache's kv heads (this
    rank's block of them, or every one where the sequence is split
    instead, :func:`prefill` cutting it).
    """
    dtype = torch_dtype(cfg.dtype)
    emb = Embedding(cfg.embedding, device=tokens.device)
    fsdp_dims = None
    if mesh is not None:
        if collect_kv:
            _check_servable(cfg)
        fsdp_dims, shapes = mesh_plan(cfg, mesh)
        _check_placed(params, shapes, mesh)
    if embed_artifact is not None:
        x = emb.serve(embed_artifact, tokens, mesh=mesh,
                      per_rank=mesh is not None)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    else:
        x, aux = emb.apply(params["embed"], tokens, mesh=mesh)
        aux = aux.to(torch.float32)
    # the scale rounded to the activation dtype first, as JAX does
    x = x.to(dtype) * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
    s = tokens.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)

    stacks = _stacks(cfg)
    layers = {name: _unstack(params[name], lead)
              for name, lead in stacks.items()}
    kvs: Dict[str, list] = {name: [] for name in stacks}

    def run(entries, x, aux):
        for name, idx, window, theta in entries:
            flat = 0
            for i, n in zip(idx, stacks[name]):
                flat = flat * n + i
            out = layer_forward(layers[name][flat], x, positions, window,
                                theta, cfg, collect_kv=collect_kv,
                                mesh=mesh, fsdp_dims=fsdp_dims)
            x, aux = out[0], aux + out[1]
            if collect_kv:
                kvs[name].append(out[2])
        return x, aux

    remat = torch.is_grad_enabled()
    for entries, ckpt in _remat_segments(cfg, _layer_plan(cfg, s),
                                         collect_kv):
        if ckpt and remat:
            x, aux = checkpoint(run, entries, x, aux, use_reentrant=False)
        else:
            x, aux = run(entries, x, aux)

    kv_out = None
    if collect_kv:
        kv_out = {}
        for name, lead in _stacks(cfg).items():
            k = torch.stack([kv[0] for kv in kvs[name]])
            v = torch.stack([kv[1] for kv in kvs[name]])
            kv_out[name] = (k.reshape(lead + k.shape[1:]),
                            v.reshape(lead + v.shape[1:]))
    x = rms_norm(params["final_norm"], x)
    return x, aux, kv_out


# ----------------------------------------------------------------------
# loss (chunked vocab softmax with remat)
# ----------------------------------------------------------------------

def chunked_xent(h: torch.Tensor, labels: torch.Tensor,
                 w_head: torch.Tensor, chunk: int, mesh=None
                 ) -> torch.Tensor:
    """Mean cross-entropy of ``h`` (B, S, d) against ``labels`` (B, S)
    under the head ``w_head`` (d, V), ``chunk`` positions at a time.

    Each chunk is one checkpoint: its (B, chunk, V) float32 logits exist
    only while it runs, forward or backward.  The logits are float32
    products of the head cast to the activations' dtype (JAX's
    ``preferred_element_type``); the gold logit is a row gather of
    ``w_head.T``, not a pick from the logits.

    With a ``mesh`` whose ``model`` axis splits the head's columns,
    ``w_head`` is this rank's block (d, V/model_n) and the softmax is
    vocab-parallel: each rank's float32 logits, the logsumexp combined
    over ``model`` (an all-reduce max, then a psum of the exponentials),
    the gold logit from the rank that owns the label's column (masked,
    then a psum).  The mean is over this rank's (B, S)."""
    b, s, d = h.shape
    chunk = min(chunk, s)
    n_chunks = s // chunk
    if s % chunk:
        raise ValueError(f"seq len {s} not a multiple of chunk {chunk}")
    w32 = w_head.to(h.dtype).to(torch.float32)
    w_rows = w_head.T                                    # (V, d)
    model_n = 1 if mesh is None else mesh.shape["model"]

    def one(h_i, y_i):
        logits = h_i.to(torch.float32) @ w32             # (b, c, V) f32
        logz = torch.logsumexp(logits, dim=-1)
        w_y = w_rows[y_i.long()]                         # (b, c, d)
        gold = torch.sum(h_i * w_y.to(h_i.dtype),
                         dim=-1).to(torch.float32)
        return torch.sum(logz - gold)

    def one_parallel(h_i, y_i):
        h_i = coll.copy_to(h_i, mesh, "model")
        logits = h_i.to(torch.float32) @ w32             # (b, c, V/m) f32
        top = coll.pmax(logits.amax(-1), mesh, "model")
        sumexp = coll.reduce_from(
            torch.exp(logits - top[..., None]).sum(-1), mesh, "model")
        logz = torch.log(sumexp) + top
        cols = w_rows.shape[0]
        own = y_i.long() - coll.axis_index(mesh, "model") * cols
        mine = (own >= 0) & (own < cols)
        w_y = w_rows[own.clamp(0, cols - 1)]             # (b, c, d)
        gold = torch.sum(h_i * w_y.to(h_i.dtype), dim=-1).to(torch.float32)
        gold = coll.reduce_from(gold * mine.to(torch.float32), mesh,
                                "model")
        return torch.sum(logz - gold)

    if model_n > 1:
        one = one_parallel

    remat = torch.is_grad_enabled()
    losses = []
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        h_i, y_i = h[:, sl], labels[:, sl]
        losses.append(checkpoint(one, h_i, y_i, use_reentrant=False)
                      if remat else one(h_i, y_i))
    return torch.sum(torch.stack(losses)) / (b * s)


def loss_fn(params: dict, batch: dict, cfg: LMConfig, mesh=None
            ) -> Tuple[torch.Tensor, dict]:
    """(xent + 0.01 * aux, {"loss", "xent", "aux"}) of ``batch``'s
    ``tokens`` against its ``labels``; with a ``mesh``, this rank's data
    shard's, replicated over ``model`` (``launch/cells.py::LMTrainCell``
    weights and sums the shards)."""
    h, aux, _ = forward(params, batch["tokens"], cfg, mesh=mesh)
    xent = chunked_xent(h, batch["labels"], params["lm_head"],
                        cfg.xent_chunk, mesh=mesh)
    loss = xent + 0.01 * aux
    return loss, {"loss": loss, "xent": xent, "aux": aux}


# ----------------------------------------------------------------------
# serving: prefill + decode
# ----------------------------------------------------------------------

def _check_servable(cfg: LMConfig) -> None:
    """Raise for a config that does not serve on a mesh:
    ``attn_kv_repeat``'s prefill caches every query head (the JAX
    package's too), a cache ``make_cache`` does not make."""
    if cfg.attn_kv_repeat:
        raise ValueError(
            f"{cfg.name}: attn_kv_repeat's prefill caches K/V expanded to "
            f"every query head, not the num_kv_heads that make_cache and "
            f"lm_cache_spec lay out; serve it without attn_kv_repeat")


def check_batch(batch: int, mesh) -> None:
    """Raise unless a global ``batch`` of prompts or training rows divides
    over the data axes of ``mesh``.  The JAX cells put such a batch's
    sequence over the data axes instead; the port's prefill and training
    step have no sequence-parallel form (no registry cell needs one).  A
    decode batch that does not divide (``long_500k``, B = 1) is served:
    its tokens replicated, its cache's sequence split (:func:`decode_step`)."""
    from repro_torch.sharding.gather import data_shards
    n = data_shards(mesh, "model")
    if batch % n:
        raise ValueError(
            f"a batch of {batch} prompts or training rows does not divide "
            f"over {n} data shard(s) (mesh {mesh.shape}): the JAX cells "
            f"split its sequence over the data axes, which the port's "
            f"prefill and training step do not (a decode batch may: "
            f"decode_step)")


def _cache_specs(cfg: LMConfig, batch: int, mesh, template) -> dict:
    """``lm_cache_spec`` of a cache of global ``batch`` rows on ``mesh``."""
    from repro_torch.sharding.rules import lm_cache_spec
    return lm_cache_spec(cfg, batch, mesh, "pod" in mesh.shape, template)


def batch_divides(batch: int, mesh) -> bool:
    """Whether a global ``batch`` divides over the data axes of ``mesh``
    (else a decode's tokens are replicated, its cache's sequence split)."""
    from repro_torch.sharding.gather import data_shards
    return batch % data_shards(mesh, "model") == 0


def _logits(x: torch.Tensor, w_head: torch.Tensor, mesh) -> torch.Tensor:
    """float32 logits (B, V) of ``x`` (B, d): with a ``mesh``, from this
    rank's column block of ``lm_head``, gathered over ``model``."""
    out = (x @ w_head.to(x.dtype)).float()
    if mesh is not None:
        out = coll.all_gather(out, mesh, "model", dim=-1)
    return out


def prefill(params: dict, tokens: torch.Tensor, cfg: LMConfig,
            max_seq: Optional[int] = None,
            embed_artifact: Optional[dict] = None, mesh=None):
    """Returns (cache, last-token logits (B, V) float32).

    max_seq: decode context budget the cache must hold (>= prompt
    length).  Defaults to the prompt length, i.e. a cache with no
    headroom — callers that decode further must size it explicitly.

    With a ``mesh``: ``params`` and ``embed_artifact`` this rank's,
    ``tokens`` its data shard (B_local, S); the cache comes back as this
    rank's block under ``sharding/rules.py::lm_cache_spec`` and the
    logits as (B_local, V), gathered over ``model``.
    """
    h, _, kvs = forward(params, tokens, cfg, collect_kv=True,
                        embed_artifact=embed_artifact, mesh=mesh)
    s = tokens.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    max_seq = max_seq or s
    seq_block = None
    if _seq_over_model(cfg, mesh):
        seq_block = (mesh.axis_index("model"), mesh.shape["model"])

    def to_cache(name, cache_len):
        k, v = kvs.pop(name)
        return attn.cache_from_prefill(k, v, positions, cache_len,
                                       seq_block=seq_block)

    cache = {"pos": s}
    if cfg.is_pattern and cfg.split_local_global_cache:
        w = cfg.sliding_window
        for name, clen in (("loc", w), ("glob", max_seq), ("rem", w)):
            if name in kvs:
                cache[name] = to_cache(name, min(clen, max_seq))
    elif cfg.is_pattern:
        for name in ("loc", "glob", "rem"):
            if name in kvs:
                cache[name] = to_cache(name, max_seq)
    else:
        clen = cache_len_for_layer(
            cfg, cfg.sliding_window or (1 << 30), max_seq)
        cache["layers"] = to_cache("layers", clen)

    return cache, _logits(h[:, -1], params["lm_head"], mesh)


def make_cache(cfg: LMConfig, batch: int, max_seq: int, dtype=None,
               device="cuda", mesh=None) -> dict:
    """An empty decode cache: per stack (k, v, kpos), kpos all -1; on the
    card unless the caller passes ``device="cpu"``.  With a ``mesh``,
    ``batch`` is global and the cache is this rank's block under
    ``sharding/rules.py::lm_cache_spec``, on ``mesh.device``."""
    dtype = dtype or torch_dtype(cfg.dtype)
    if mesh is not None:
        from repro_torch.sharding.rules import NamedSpec
        whole = _cache_template(cfg, batch, max_seq)
        specs = _cache_specs(cfg, batch, mesh, whole)
        out = {"pos": 0}
        for name, leaves in whole.items():
            if name == "pos":
                continue
            k, v, kp = (NamedSpec(mesh, sp).block(t).shape
                        for t, sp in zip(leaves, specs[name]))
            out[name] = (torch.zeros(k, dtype=dtype, device=mesh.device),
                         torch.zeros(v, dtype=dtype, device=mesh.device),
                         torch.full(kp, -1, dtype=torch.int32,
                                    device=mesh.device))
        return out
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads

    def zeros(lead, clen):
        k = torch.zeros(lead + (batch, clen, kv, hd), dtype=dtype,
                        device=device)
        kp = torch.full(lead + (batch, clen), -1, dtype=torch.int32,
                        device=device)
        return k, torch.zeros_like(k), kp

    cache = {"pos": 0}
    if cfg.is_pattern:
        w = (min(cfg.sliding_window, max_seq)
             if cfg.split_local_global_cache else max_seq)
        for name, lead in _stacks(cfg).items():
            cache[name] = zeros(lead, max_seq if name == "glob" else w)
    else:
        clen = cache_len_for_layer(
            cfg, cfg.sliding_window or (1 << 30), max_seq)
        cache["layers"] = zeros((cfg.num_layers,), clen)
    return cache


def _cache_template(cfg: LMConfig, batch: int, max_seq: int) -> dict:
    """:func:`make_cache`'s layout as empty meta tensors (shapes alone:
    nothing is filled, so a dry run's count sees no work)."""
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads

    def leaves(lead, clen):
        k = torch.empty(lead + (batch, clen, kv, hd), device="meta")
        return k, torch.empty_like(k), torch.empty(lead + (batch, clen),
                                                   device="meta")

    out = {"pos": 0}
    if cfg.is_pattern:
        w = (min(cfg.sliding_window, max_seq)
             if cfg.split_local_global_cache else max_seq)
        for name, lead in _stacks(cfg).items():
            out[name] = leaves(lead, max_seq if name == "glob" else w)
    else:
        out["layers"] = leaves((cfg.num_layers,), cache_len_for_layer(
            cfg, cfg.sliding_window or (1 << 30), max_seq))
    return out


def check_cache(cache: dict, cfg: LMConfig, mesh, batch: int,
                max_seq: Optional[int] = None) -> dict:
    """Raise unless every leaf of ``cache`` is this rank's block under
    ``lm_cache_spec`` of a cache of global ``batch`` rows; return those
    specs.  The whole cache is ``make_cache``'s of ``max_seq`` slots, or
    (``max_seq`` None, a batch that divides over the data axes) of each
    stack's length read from its kpos, which no spec of a dividing batch
    splits."""
    from repro_torch.sharding.rules import NamedSpec
    if max_seq is not None:
        whole = _cache_template(cfg, batch, max_seq)
    elif not batch_divides(batch, mesh):
        raise ValueError(f"a cache of {batch} rows on mesh {mesh.shape} "
                         f"splits its sequence: pass max_seq")
    else:
        hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
        whole = {"pos": 0}
        for name, leaves in cache.items():
            if name == "pos":
                continue
            kp = leaves[2]
            shape = tuple(kp.shape[:-2]) + (batch, kp.shape[-1])
            whole[name] = (torch.empty(shape + (kv, hd), device="meta"),
                           torch.empty(shape + (kv, hd), device="meta"),
                           torch.empty(shape, device="meta"))
    specs = _cache_specs(cfg, batch, mesh, whole)
    for name in whole:
        if name == "pos":
            continue
        for i, (t, w, sp) in enumerate(zip(cache[name], whole[name],
                                           specs[name])):
            want = tuple(NamedSpec(mesh, sp).block(w).shape)
            if tuple(t.shape) != want:
                raise ValueError(
                    f"cache {name}/{i}: {tuple(t.shape)} is not this rank's "
                    f"block {want} under lm_cache_spec {sp} on mesh "
                    f"{mesh.shape} (make_cache(mesh=) or prefill(mesh=) "
                    f"makes one)")
    return {name: (specs[name], whole[name][2].shape[-1])
            for name in whole if name != "pos"}


def _seq_axes(spec: tuple) -> tuple:
    """The axes a cache stack's k spec splits its sequence over."""
    axes = spec[-3]
    return () if axes is None else (axes,) if isinstance(axes, str) \
        else tuple(axes)


def decode_step(params: dict, cache: dict, token: torch.Tensor,
                cfg: LMConfig, embed_artifact: Optional[dict] = None,
                mesh=None, batch: Optional[int] = None,
                max_seq: Optional[int] = None):
    """One decode step.  token (B,) int32 -> (new_cache, logits (B, V)).

    The caches are updated in place: ``new_cache`` holds the same
    tensors as ``cache`` and the next position.  embed_artifact:
    serving-time embedding (codes + centroids for DPQ/MGQE) — the
    paper's Figure-1 serving path; the training table when None.

    With a ``mesh``: this rank's params, artifact and cache block
    (checked: :func:`check_cache`) of a cache of global ``batch`` rows
    and ``max_seq`` slots, ``token`` its data shard (B_local,) (the
    default ``batch``: B_local times the data shards); the
    tensor-parallel layer of :func:`layer_decode`, the MoE block in the
    global formulation (``nn/moe.py::moe_ffn(mesh=)``), the logits
    (B_local, V) gathered over ``model``.  A ``batch`` that does not
    divide over the data axes (``long_500k``) comes replicated, ``token``
    the whole batch on every rank, and needs ``max_seq``: the cache's
    sequence is split over the data axes, each layer's attention merged
    over them.
    """
    dtype = torch_dtype(cfg.dtype)
    emb = Embedding(cfg.embedding, device=token.device)
    fsdp_dims, layout = None, {}
    if mesh is not None:
        from repro_torch.sharding.gather import data_shards
        _check_servable(cfg)
        fsdp_dims, shapes = mesh_plan(cfg, mesh)
        _check_placed(params, shapes, mesh)
        batch = batch or token.shape[0] * data_shards(mesh, "model")
        layout = check_cache(cache, cfg, mesh, batch, max_seq)
    if embed_artifact is not None:
        x = emb.serve(embed_artifact, token, mesh=mesh,
                      per_rank=mesh is not None)
    else:
        x, _ = emb.apply(params["embed"], token, mesh=mesh)
    # multiplied in f32, then cast, as JAX does
    x = (x[:, None, :] * cfg.d_model ** 0.5).to(dtype)      # (B, 1, d)
    pos = int(cache["pos"])
    new_cache = dict(cache, pos=pos + 1)

    if cfg.is_pattern:
        plan = _layer_plan(cfg, 1 << 30)
    else:
        windows, thetas = layer_windows(cfg, 1 << 30)
        # clamp windows to this cache's whole length
        clen = layout["layers"][1] if layout else \
            cache["layers"][2].shape[-1]
        windows = torch.minimum(windows, torch.tensor(clen, dtype=torch.int32))
        plan = [("layers", (i,), w, t) for i, (w, t) in
                enumerate(zip(windows.tolist(), thetas.tolist()))]
    for name, idx, window, theta in plan:
        k, v, kp = cache[name]
        kw = {}
        if layout:
            specs, whole_len = layout[name]
            kw = {"seq_axes": _seq_axes(specs[0]), "cache_len": whole_len}
        x, _, _, _ = layer_decode(_index(params[name], *idx), x, pos, window,
                                  theta, k[idx], v[idx], kp[idx], cfg,
                                  mesh=mesh, fsdp_dims=fsdp_dims, **kw)

    x = rms_norm(params["final_norm"], x)
    return new_cache, _logits(x[:, 0], params["lm_head"], mesh)


__all__ = ["batch_divides", "cache_len_for_layer", "check_batch",
           "check_cache",
           "chunked_xent",
           "decode_step", "forward",
           "layer_decode", "layer_forward", "layer_windows", "loss_fn",
           "make_cache", "mesh_plan", "model_init", "param_spec", "prefill"]
