"""Top-k routed mixture-of-experts FFN (GShard-style capacity dispatch).

The JAX package's ``nn/moe.py``, single-device: ``moe_ffn`` scatters
each token's top-k choices into a global (E, C, d) dispatch buffer,
runs the experts as batched GEMMs and gathers the outputs back,
weighted by the renormalised gate.  The expert-sharded
``moe_ffn_sharded`` (grouped dispatch with all-to-all over a mesh)
waits for the distributed layer (ROADMAP.md §1 item 8);
``models/lm.py`` refuses ``LMConfig.moe_shard_map``.

Router aux loss: the Switch Transformer load-balancing loss
(sum over experts of fraction_tokens_e * mean_router_prob_e, times E).

Every step follows JAX's: router logits and softmax in float32; the
top k taken from a stable descending sort (``jax.lax.top_k`` puts the
lower index first among equal probabilities, ``torch.topk`` does not);
each (token, choice) placed in its expert by an exclusive cumsum in
token-major order, overflow sent to slot ``cap - 1`` with weight 0;
the dispatch a scatter-*add* (a dropped choice adds zeros to a slot a
kept one may hold).  The experts are plain ``torch.bmm``: in the JAX
package they are ``einsum`` outside any Pallas kernel.  Two steps take
another layout on the card for speed and give the same numbers: the
cumsum runs over the one-hot laid out (E, T*k), and the scatter-add is
``index_add_`` over the flattened (E*cap, d) buffer (atomic adds, exact
here: every slot sums at most one nonzero row).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.nn import initializers as init


def moe_spec(d_model: int, d_ff: int, num_experts: int) -> dict:
    """The layer's leaves as (shape, init stddev), JAX's layout."""
    s_in, s_ff = d_model ** -0.5, d_ff ** -0.5
    return {
        "router": ((d_model, num_experts), s_in),
        "w_gate": ((num_experts, d_model, d_ff), s_in),
        "w_up": ((num_experts, d_model, d_ff), s_in),
        "w_down": ((num_experts, d_ff, d_model), s_ff),
    }


def moe_init(gen: torch.Generator, d_model: int, d_ff: int,
             num_experts: int, dtype=torch.float32) -> dict:
    """Router (d, E), w_gate and w_up (E, d, f), w_down (E, f, d), drawn
    from ``gen`` on its device in ``dtype``."""
    return {name: init.normal(gen, shape, std, dtype) for name, (shape, std)
            in moe_spec(d_model, d_ff, num_experts).items()}


def capacity(num_tokens: int, num_experts: int, top_k: int,
             factor: float) -> int:
    c = int(math.ceil(num_tokens * top_k * factor / num_experts))
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def route(xt: torch.Tensor, router: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt (T, d) -> (gate weights (T, k) f32 renormalised, expert ids
    (T, k) int64, router probabilities (T, E) f32)."""
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_i = gate_w[:, :top_k], gate_i[:, :top_k]
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    return gate_w, gate_i, probs


def _dispatch_combine(xt: torch.Tensor, router: torch.Tensor, top_k: int,
                      cap: int, expert_fn):
    """Route xt (T, d), scatter into (E, cap, d), run
    ``expert_fn(buf) -> (E, cap, d)``, gather-combine.

    Returns (out (T, d), aux_loss)."""
    t, d = xt.shape
    num_experts = router.shape[-1]
    gate_w, gate_i, probs = route(xt, router, top_k)
    # one-hots by comparison (F.one_hot checks its input on the host)
    experts = torch.arange(num_experts, device=xt.device)

    # Switch load-balance loss
    me = probs.mean(0)                                            # (E,)
    ce = (gate_i[..., None] == experts).float().sum(1).mean(0)    # (E,)
    aux = (me * ce).sum() * num_experts

    # position of each (token, choice) within its expert's capacity: the
    # one-hot laid out (E, T*k), so the cumsum runs along the innermost
    # dim (along dim 0 of (T*k, E) the card scans each column serially)
    flat_e = gate_i.reshape(-1)                                   # (T*k,)
    onehot = (flat_e[None, :] == experts[:, None]).to(torch.int32)  # (E, T*k)
    pos_in_e = torch.cumsum(onehot, 1, dtype=torch.int32) - onehot  # exclusive
    pos = (pos_in_e * onehot).sum(0)                              # (T*k,)
    keep = pos < cap                                              # drop overflow
    slot = torch.where(keep, pos, cap - 1).long()

    # dispatch: dropped choices scatter zeros.  An add, never a store: a
    # slot holds at most one kept row, and adding zeros to it in any
    # order leaves it exact
    xt_rep = torch.repeat_interleave(xt, top_k, dim=0)            # (T*k, d)
    w_scatter = keep.to(xt.dtype)[:, None]
    buf = torch.zeros((num_experts * cap, d), dtype=xt.dtype,
                      device=xt.device)
    buf.index_add_(0, flat_e * cap + slot, xt_rep * w_scatter)
    buf = buf.reshape(num_experts, cap, d)

    out_buf = expert_fn(buf)                                      # (E, C, d)

    # combine: gather each (token, choice)'s output, weight, sum over k
    gathered = out_buf[flat_e, slot]                              # (T*k, d)
    gathered = gathered * (gate_w.reshape(-1)[:, None].to(gathered.dtype)
                           * w_scatter)
    out = gathered.reshape(t, top_k, d).sum(1)
    return out, aux


def _expert_swiglu(buf, w_gate, w_up, w_down):
    gate = torch.bmm(buf, w_gate.to(buf.dtype))
    up = torch.bmm(buf, w_up.to(buf.dtype))
    hidden = F.silu(gate) * up
    return torch.bmm(hidden, w_down.to(buf.dtype))


def moe_ffn(params: dict, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar float32)."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    num_experts = params["router"].shape[-1]
    cap = capacity(t, num_experts, top_k, capacity_factor)
    out, aux = _dispatch_combine(
        xt, params["router"], top_k, cap,
        lambda buf: _expert_swiglu(buf, params["w_gate"], params["w_up"],
                                   params["w_down"]))
    return out.reshape(b, s, d), aux


__all__ = ["capacity", "moe_ffn", "moe_init", "moe_spec", "route"]
