"""Top-k routed mixture-of-experts FFN (GShard-style capacity dispatch).

The JAX package's ``nn/moe.py``, with its two formulations:

* ``moe_ffn`` — the mesh-agnostic one: each token's top-k choices are
  scattered into a GLOBAL (E, C, d) dispatch buffer, the experts run as
  batched GEMMs and the outputs are gathered back, weighted by the
  renormalised gate.  Under a mesh (``mesh=``) a rank holds its data
  shard of the tokens and its placed experts (``sharding/rules.py``):
  the tokens are gathered over the data axes and dispatched globally
  (the same function as one device's), and the experts run on each
  rank's block — E over ``model`` (the dispatch buffer's rows cut and
  the outputs gathered back) or their d_ff (one psum of the partial
  outputs).
* ``moe_ffn_sharded`` — the grouped dispatch (the real GShard scheme):
  every token group dispatches its OWN tokens into a local (E, C_local,
  d) buffer (group-wise capacity), then
    - "expert" strategy (E % model_n == 0): all_to_all over the model
      axis routes expert rows to their owning rank, the expert GEMMs are
      local, the reverse all_to_all returns the outputs;
    - "ffn" strategy (otherwise): experts replicated, d_ff split over
      model; one psum of the (E, C_local, d) partial outputs.
  Its aux loss is the mean over the groups.

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
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.gather import data_axes_of


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


def slots(flat_e: torch.Tensor, num_experts: int, cap: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot (T*k,) int64, keep (T*k,) bool) of each (token, choice) of
    the expert ids ``flat_e`` (token-major): its position within its
    expert's capacity by an exclusive cumsum, overflow (``keep`` False)
    sent to slot ``cap - 1``."""
    experts = torch.arange(num_experts, device=flat_e.device)
    # the one-hot laid out (E, T*k), so the cumsum runs along the
    # innermost dim (along dim 0 of (T*k, E) the card scans each column
    # serially)
    onehot = (flat_e[None, :] == experts[:, None]).to(torch.int32)  # (E, T*k)
    pos_in_e = torch.cumsum(onehot, 1, dtype=torch.int32) - onehot  # exclusive
    pos = (pos_in_e * onehot).sum(0)                              # (T*k,)
    keep = pos < cap                                              # drop overflow
    return torch.where(keep, pos, cap - 1).long(), keep


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

    flat_e = gate_i.reshape(-1)                                   # (T*k,)
    slot, keep = slots(flat_e, num_experts, cap)

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


def expert_parallel(num_experts: int, model_n: int) -> bool:
    """Whether ``num_experts`` split over a model axis of ``model_n``
    ranks (the rules' ``expert_spec``; else their d_ff does)."""
    return num_experts % model_n == 0 and num_experts >= model_n


def _placed_experts(params: dict, mesh, model_axis: str, local_e: int):
    """Check that the experts are the block the rules place on this rank
    (E/model_n experts, or all E with their d_ff split)."""
    got = params["w_gate"].shape[0]
    if got != local_e:
        raise ValueError(
            f"the rank holds {got} experts; the placement over "
            f"{model_axis}={mesh.shape[model_axis]} gives it {local_e}")


def moe_ffn(params: dict, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25, mesh=None,
            model_axis: str = "model"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar float32).

    With a ``mesh``, ``x`` is this rank's data shard (replicated over
    ``model_axis``) and ``params`` its placed block: the global
    formulation of the module docstring, the output this rank's rows."""
    if mesh is None:
        b, s, d = x.shape
        t = b * s
        xt = x.reshape(t, d)
        num_experts = params["router"].shape[-1]
        cap = capacity(t, num_experts, top_k, capacity_factor)
        out, aux = _dispatch_combine(
            xt, params["router"], top_k, cap,
            lambda buf: _expert_swiglu(buf, params["w_gate"],
                                       params["w_up"], params["w_down"]))
        return out.reshape(b, s, d), aux
    data_axes = data_axes_of(mesh, model_axis)
    model_n = mesh.shape[model_axis]
    num_experts = params["router"].shape[-1]
    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    if model_n == 1:
        def expert_fn(buf):
            return _expert_swiglu(buf, wg, wu, wd)
    elif expert_parallel(num_experts, model_n):
        _placed_experts(params, mesh, model_axis, num_experts // model_n)

        def expert_fn(buf):                 # this rank's experts' rows
            out = _expert_swiglu(coll.scatter_to(buf, mesh, model_axis, 0),
                                 wg, wu, wd)
            return coll.gather_from(out, mesh, model_axis, 0)
    else:
        _placed_experts(params, mesh, model_axis, num_experts)

        def expert_fn(buf):                 # partial over this rank's d_ff
            out = _expert_swiglu(coll.copy_to(buf, mesh, model_axis),
                                 wg, wu, wd)
            return coll.reduce_from(out, mesh, model_axis)
    xg = coll.all_gather_grad(x, mesh, data_axes)      # (B_global, S, d)
    b, s, d = xg.shape
    cap = capacity(b * s, num_experts, top_k, capacity_factor)
    out, aux = _dispatch_combine(xg.reshape(b * s, d), params["router"],
                                 top_k, cap, expert_fn)
    return coll.block(out.reshape(b, s, d), mesh, data_axes, 0), aux


def moe_ffn_sharded(params: dict, x: torch.Tensor, *, top_k: int,
                    capacity_factor: float = 1.25, mesh,
                    model_axis: str = "model"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grouped dispatch of the module docstring on this rank's shard.

    ``x`` is this rank's token group: under the expert strategy
    (:func:`expert_parallel`) its data shard of the batch and its
    ``model_axis`` slice of the sequence, (B/data_n, S/model_n, d);
    under the ffn strategy its data shard, whole over the sequence and
    replicated over ``model_axis``.  ``params`` are the rank's placed
    block (E/model_n experts, or every expert at d_ff/model_n).  The
    group dispatches its own tokens at ``capacity(t_local, ...)``.
    Returns (this group's output, the aux loss averaged over the
    groups, on every rank)."""
    if mesh is None:
        raise ValueError("moe_ffn_sharded takes its token groups from a "
                         "mesh: pass mesh= (moe_ffn is the single-device "
                         "formulation)")
    data_axes = data_axes_of(mesh, model_axis)
    model_n = mesh.shape[model_axis]
    num_experts = params["router"].shape[-1]
    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    router = params["router"]
    if expert_parallel(num_experts, model_n):
        _placed_experts(params, mesh, model_axis, num_experts // model_n)
        # each rank routes different tokens: the router's gradient is
        # summed over the model axis
        router = coll.copy_to(router, mesh, model_axis)
        aux_axes = data_axes + (model_axis,)

        def expert_fn(buf):                  # (E, cap, d) of this group
            # expert rows to their owning rank: (E/m, cap*m, d)
            buf = coll.all_to_all(buf, mesh, model_axis, 0, 1)
            out = _expert_swiglu(buf, wg, wu, wd)
            return coll.all_to_all(out, mesh, model_axis, 1, 0)
    else:
        _placed_experts(params, mesh, model_axis, num_experts)
        # every rank of the model axis routes the same tokens: the mean
        # over the model axis is of equal values
        aux_axes = data_axes

        def expert_fn(buf):                  # partial over this rank's d_ff
            out = _expert_swiglu(coll.copy_to(buf, mesh, model_axis),
                                 wg, wu, wd)
            return coll.reduce_from(out, mesh, model_axis)
    bl, sl, d = x.shape
    cap = capacity(bl * sl, num_experts, top_k, capacity_factor)
    out, aux = _dispatch_combine(x.reshape(bl * sl, d), router, top_k, cap,
                                 expert_fn)
    return out.reshape(bl, sl, d), coll.pmean(aux, mesh, aux_axes,
                                              model_axis)


def moe_ffn_grouped(params: dict, x: torch.Tensor, *, top_k: int,
                    capacity_factor: float = 1.25, data_n: int,
                    model_n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """What :func:`moe_ffn_sharded` computes on a (data_n, model_n) mesh,
    on one device with the whole params and the global x (B, S, d): the
    same token groups (under the expert strategy each (data, model)
    block of batch and sequence, else each data block), each dispatched
    at its own capacity, the aux the groups' mean.  The plain version
    the mesh is held to."""
    b, s, d = x.shape
    num_experts = params["router"].shape[-1]
    seq_n = model_n if expert_parallel(num_experts, model_n) else 1
    bl, sl = b // data_n, s // seq_n
    rows, auxs = [], []
    for di in range(data_n):
        row = []
        for mi in range(seq_n):
            xg = x[di * bl:(di + 1) * bl, mi * sl:(mi + 1) * sl]
            out, aux = _dispatch_combine(
                xg.reshape(bl * sl, d), params["router"], top_k,
                capacity(bl * sl, num_experts, top_k, capacity_factor),
                lambda buf: _expert_swiglu(buf, params["w_gate"],
                                           params["w_up"], params["w_down"]))
            row.append(out.reshape(bl, sl, d))
            auxs.append(aux)
        rows.append(torch.cat(row, dim=1))
    return torch.cat(rows), torch.stack(auxs).mean()


__all__ = ["capacity", "expert_parallel", "moe_ffn", "moe_ffn_grouped",
           "moe_ffn_sharded", "moe_init", "moe_spec", "route", "slots"]
