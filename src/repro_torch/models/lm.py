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
"""
from __future__ import annotations

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


def model_init(gen: torch.Generator, cfg: LMConfig, dtype=None) -> dict:
    """Params on the generator's device, ``dtype`` defaulting to
    ``cfg.param_dtype`` (each table drawn and scaled in place)."""
    dtype = dtype or torch_dtype(cfg.param_dtype)
    spec = param_spec(cfg)
    emb = Embedding(cfg.embedding, device=gen.device)

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        shape, std = tree
        if std == 0.0:
            return torch.zeros(shape, dtype=dtype, device=gen.device)
        return init.normal(gen, shape, std, dtype)

    params = {"embed": emb.init(gen, dtype=dtype)}
    params.update(build(spec))
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

def _qkv(p, x, cfg: LMConfig):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, cfg.num_heads, hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(b, s, cfg.num_kv_heads, hd)
    return q, k, v


def _ffn_block(p, x, cfg: LMConfig):
    if cfg.is_moe:
        # JAX takes its shard_map grouped dispatch for full sequences
        # (train/prefill); decode (S == 1) keeps the global formulation
        if cfg.moe_shard_map and x.shape[1] > 1:
            raise NotImplementedError(
                f"{cfg.name}: moe_shard_map (the expert-sharded dispatch) "
                f"waits for the distributed layer, ROADMAP.md §1 item 8; "
                f"the port runs the single-device moe_ffn")
        return moe_lib.moe_ffn(p["moe"], x, top_k=cfg.num_experts_per_tok,
                               capacity_factor=cfg.moe_capacity_factor)
    return (glu_ffn(p["ffn"], x, act=cfg.act),
            torch.zeros((), dtype=torch.float32, device=x.device))


def layer_forward(p: dict, x: torch.Tensor, positions: torch.Tensor,
                  window, theta, cfg: LMConfig, collect_kv: bool = False):
    """Full-sequence layer (train / prefill).

    Returns (y, aux) or (y, aux, (k, v)) when collect_kv.
    """
    h = rms_norm(p["ln1"], x)
    q, k, v = _qkv(p, h, cfg)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    if cfg.attn_kv_repeat and cfg.num_kv_heads < cfg.num_heads:
        g = cfg.num_heads // cfg.num_kv_heads
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
    x = x + (o.reshape(x.shape[0], s, -1) @ p["wo"].to(x.dtype))
    h2 = rms_norm(p["ln2"], x)
    f, aux = _ffn_block(p, h2, cfg)
    y = x + f
    if collect_kv:
        return y, aux, (k, v)
    return y, aux


def layer_decode(p: dict, x: torch.Tensor, pos: int, window, theta,
                 k_cache, v_cache, kpos_cache, cfg: LMConfig):
    """One-token layer step.  x: (B, 1, d).  Returns (y, caches); the
    caches are updated in place."""
    h = rms_norm(p["ln1"], x)
    q, k, v = _qkv(p, h, cfg)
    pos_arr = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos_arr, theta)
    k = apply_rope(k, pos_arr, theta)     # rotate BEFORE caching
    k_cache, v_cache, kpos_cache = attn.cache_update(
        k_cache, v_cache, kpos_cache, k, v, pos)
    o = attn.decode_attention(q, k_cache, v_cache, kpos_cache, window)
    x = x + (o.reshape(x.shape[0], 1, -1) @ p["wo"].to(x.dtype))
    h2 = rms_norm(p["ln2"], x)
    f, _ = _ffn_block(p, h2, cfg)
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


def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig,
            collect_kv: bool = False,
            embed_artifact: Optional[dict] = None):
    """tokens (B, S) -> (hidden (B, S, d), aux, kv_stacks | None).

    kv_stacks (when collect_kv): per stack, (k, v) with the stack's
    leading dims, the layout of the decode cache; used by prefill.

    embed_artifact: serving-time quantized embedding (codes+centroids);
    when given, the full table in params is never touched (paper Fig 1).

    Under autograd with ``cfg.remat``, each segment of
    :func:`_remat_segments` keeps only its input and recomputes its
    layers in the backward.
    """
    dtype = torch_dtype(cfg.dtype)
    emb = Embedding(cfg.embedding, device=tokens.device)
    if embed_artifact is not None:
        x = emb.serve(embed_artifact, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    else:
        x, aux = emb.apply(params["embed"], tokens)
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
                                theta, cfg, collect_kv=collect_kv)
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
                 w_head: torch.Tensor, chunk: int) -> torch.Tensor:
    """Mean cross-entropy of ``h`` (B, S, d) against ``labels`` (B, S)
    under the head ``w_head`` (d, V), ``chunk`` positions at a time.

    Each chunk is one checkpoint: its (B, chunk, V) float32 logits exist
    only while it runs, forward or backward.  The logits are float32
    products of the head cast to the activations' dtype (JAX's
    ``preferred_element_type``); the gold logit is a row gather of
    ``w_head.T``, not a pick from the logits."""
    b, s, d = h.shape
    chunk = min(chunk, s)
    n_chunks = s // chunk
    if s % chunk:
        raise ValueError(f"seq len {s} not a multiple of chunk {chunk}")
    w32 = w_head.to(h.dtype).to(torch.float32)
    w_rows = w_head.T                                    # (V, d)

    def one(h_i, y_i):
        logits = h_i.to(torch.float32) @ w32             # (b, c, V) f32
        logz = torch.logsumexp(logits, dim=-1)
        w_y = w_rows[y_i.long()]                         # (b, c, d)
        gold = torch.sum(h_i * w_y.to(h_i.dtype),
                         dim=-1).to(torch.float32)
        return torch.sum(logz - gold)

    remat = torch.is_grad_enabled()
    losses = []
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        h_i, y_i = h[:, sl], labels[:, sl]
        losses.append(checkpoint(one, h_i, y_i, use_reentrant=False)
                      if remat else one(h_i, y_i))
    return torch.sum(torch.stack(losses)) / (b * s)


def loss_fn(params: dict, batch: dict, cfg: LMConfig
            ) -> Tuple[torch.Tensor, dict]:
    """(xent + 0.01 * aux, {"loss", "xent", "aux"}) of ``batch``'s
    ``tokens`` against its ``labels``."""
    h, aux, _ = forward(params, batch["tokens"], cfg)
    xent = chunked_xent(h, batch["labels"], params["lm_head"],
                        cfg.xent_chunk)
    loss = xent + 0.01 * aux
    return loss, {"loss": loss, "xent": xent, "aux": aux}


# ----------------------------------------------------------------------
# serving: prefill + decode
# ----------------------------------------------------------------------

def prefill(params: dict, tokens: torch.Tensor, cfg: LMConfig,
            max_seq: Optional[int] = None,
            embed_artifact: Optional[dict] = None):
    """Returns (cache, last-token logits (B, V) float32).

    max_seq: decode context budget the cache must hold (>= prompt
    length).  Defaults to the prompt length, i.e. a cache with no
    headroom — callers that decode further must size it explicitly.
    """
    h, _, kvs = forward(params, tokens, cfg, collect_kv=True,
                        embed_artifact=embed_artifact)
    s = tokens.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    max_seq = max_seq or s

    def to_cache(name, cache_len):
        k, v = kvs[name]
        return attn.cache_from_prefill(k, v, positions, cache_len)

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

    logits = (h[:, -1] @ params["lm_head"].to(h.dtype)).float()
    return cache, logits


def make_cache(cfg: LMConfig, batch: int, max_seq: int, dtype=None,
               device="cuda") -> dict:
    """An empty decode cache: per stack (k, v, kpos), kpos all -1; on the
    card unless the caller passes ``device="cpu"``."""
    dtype = dtype or torch_dtype(cfg.dtype)
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


def decode_step(params: dict, cache: dict, token: torch.Tensor,
                cfg: LMConfig, embed_artifact: Optional[dict] = None):
    """One decode step.  token (B,) int32 -> (new_cache, logits (B, V)).

    The caches are updated in place: ``new_cache`` holds the same
    tensors as ``cache`` and the next position.  embed_artifact:
    serving-time embedding (codes + centroids for DPQ/MGQE) — the
    paper's Figure-1 serving path; the training table when None.
    """
    dtype = torch_dtype(cfg.dtype)
    emb = Embedding(cfg.embedding, device=token.device)
    if embed_artifact is not None:
        x = emb.serve(embed_artifact, token)
    else:
        x, _ = emb.apply(params["embed"], token)
    # multiplied in f32, then cast, as JAX does
    x = (x[:, None, :] * cfg.d_model ** 0.5).to(dtype)      # (B, 1, d)
    pos = int(cache["pos"])
    new_cache = dict(cache, pos=pos + 1)

    if cfg.is_pattern:
        plan = _layer_plan(cfg, 1 << 30)
    else:
        windows, thetas = layer_windows(cfg, 1 << 30)
        # clamp windows to this cache's actual length
        clen = cache["layers"][0].shape[2]
        windows = torch.minimum(windows, torch.tensor(clen, dtype=torch.int32))
        plan = [("layers", (i,), w, t) for i, (w, t) in
                enumerate(zip(windows.tolist(), thetas.tolist()))]
    for name, idx, window, theta in plan:
        k, v, kp = cache[name]
        x, _, _, _ = layer_decode(_index(params[name], *idx), x, pos, window,
                                  theta, k[idx], v[idx], kp[idx], cfg)

    x = rms_norm(params["final_norm"], x)
    logits = (x[:, 0] @ params["lm_head"].to(x.dtype)).float()
    return new_cache, logits


__all__ = ["cache_len_for_layer", "chunked_xent", "decode_step", "forward",
           "layer_decode", "layer_forward", "layer_windows", "loss_fn",
           "make_cache", "model_init", "param_spec", "prefill"]
