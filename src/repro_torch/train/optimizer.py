"""Optimizers over parameter trees (dicts and lists of tensors).

Supported: adam, adamw, adagrad (the classic for sparse recsys
embeddings), sgd (momentum).  All state lives in a tree mirroring the
params, with the JAX package's moment-buffer keys (``m``/``v``/``acc``/
``mom``) and a 0-d int32 ``step``, so checkpoints of the two packages
share one layout.

Each optimizer is one :class:`OptimizerRule` registered under its kind
string; ``init``/``apply_updates`` resolve the rule from the registry
instead of branching per kind.

Where JAX donates the old buffers to a jitted step, the port updates
params and moments in place under ``torch.no_grad()``: at deepfm's full
width a fresh copy of the tables and of adagrad's accumulators would be
~2 GB that need not exist.  The arithmetic keeps JAX's order and
rounding, one rounded operation at a time (moments in float32, the
update cast back to the param's dtype), so the two packages agree to
float32 rounding.  Each rule uses the gradient's own buffer and at most
one temporary the size of the leaf.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Type

import torch

from repro_torch.core.schemes.base import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adam"          # adam | adamw | adagrad | sgd
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0   # adamw
    momentum: float = 0.9       # sgd
    grad_clip: Optional[float] = 1.0   # global-norm clip; None = off
    # schedule: constant | cosine | linear_warmup_cosine
    schedule: str = "constant"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule_lr(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d int tensor) as a 0-d float32
    tensor on the step's device, computed in float32 as JAX computes
    it."""
    step = torch.as_tensor(step)
    base = torch.tensor(cfg.lr, dtype=torch.float32, device=step.device)
    if cfg.schedule == "constant":
        return base
    f32 = torch.float32
    warm = torch.clamp((step + 1).to(f32) / max(cfg.warmup_steps, 1),
                       max=1.0)
    if cfg.schedule in ("linear_warmup_cosine", "cosine"):
        t = torch.clamp((step - cfg.warmup_steps).to(f32)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
        return base * warm * frac
    raise ValueError(cfg.schedule)


# ----------------------------------------------------------------------
# optimizer-rule registry
# ----------------------------------------------------------------------

class OptimizerRule:
    """One optimizer: moment-buffer layout + the update math."""

    state_keys: Tuple[str, ...] = ()
    # an elementwise rule may take each large leaf in pieces of at most
    # this many elements (views of the param and its moments), so its
    # float32 temporaries are a piece's size, not the leaf's; 0 = whole
    # leaves (adagrad keeps them whole: its replay reads leaf for leaf)
    piece_elements: int = 0

    @classmethod
    def update(cls, cfg: OptimizerConfig, lr: torch.Tensor,
               step: torch.Tensor, params: List[torch.Tensor],
               grads: List[torch.Tensor],
               moments: Dict[str, List[torch.Tensor]]) -> None:
        """Update ``params`` and ``moments`` (leaf lists, in tree order)
        in place.  ``grads`` are float32 buffers the rule may overwrite,
        iterated once per pass over them."""
        raise NotImplementedError


_OPTIMIZERS: Dict[str, Type[OptimizerRule]] = {}


def register_optimizer(kind: str):
    def deco(cls: Type[OptimizerRule]) -> Type[OptimizerRule]:
        prev = _OPTIMIZERS.get(kind)
        if prev is not None and prev is not cls:
            raise ValueError(
                f"optimizer kind {kind!r} already registered to {prev}")
        _OPTIMIZERS[kind] = cls
        return cls
    return deco


def _rule(kind: str) -> Type[OptimizerRule]:
    try:
        return _OPTIMIZERS[kind]
    except KeyError:
        raise ValueError(
            f"unknown optimizer kind {kind!r}; registered: "
            f"{', '.join(sorted(_OPTIMIZERS))}") from None


@register_optimizer("adam")
class _Adam(OptimizerRule):
    state_keys = ("m", "v")
    decoupled_weight_decay = False
    piece_elements = 1 << 27

    @classmethod
    def update(cls, cfg, lr, step, params, grads, moments):
        t = (step + 1).to(torch.float32)
        bc1 = 1 - torch.pow(cfg.b1, t)
        bc2 = 1 - torch.pow(cfg.b2, t)
        for p, g, m, v in zip(params, grads, moments["m"], moments["v"]):
            tmp = torch.mul(g, 1 - cfg.b1)
            m.mul_(cfg.b1).add_(tmp)                # b1*m + (1-b1)*g
            torch.mul(g, g, out=tmp)
            v.mul_(cfg.b2).add_(tmp.mul_(1 - cfg.b2))   # b2*v + (1-b2)*g²
            torch.div(m, bc1, out=tmp)              # m / bc1
            torch.div(v, bc2, out=g)
            tmp.div_(g.sqrt_().add_(cfg.eps))       # / (sqrt(v/bc2) + eps)
            if cls.decoupled_weight_decay and cfg.weight_decay:
                tmp.add_(torch.mul(p.to(torch.float32), cfg.weight_decay,
                                   out=g))
            p.sub_(tmp.mul_(lr))                    # p - lr*u


@register_optimizer("adamw")
class _AdamW(_Adam):
    decoupled_weight_decay = True


@register_optimizer("adagrad")
class _Adagrad(OptimizerRule):
    state_keys = ("acc",)

    @classmethod
    def update(cls, cfg, lr, step, params, grads, moments):
        for p, g, a in zip(params, grads, moments["acc"]):
            tmp = torch.mul(g, g)
            a.add_(tmp)                             # acc + g²
            torch.sqrt(a, out=tmp).add_(cfg.eps)    # sqrt(acc) + eps
            p.sub_(g.mul_(lr).div_(tmp))            # p - lr*g / (...)


@contextlib.contextmanager
def record_adagrad():
    """Within the block, every adagrad update appends (the params'
    device, its lr, its eps, the clipped float32 gradients it consumed,
    copied to the CPU) to the list this yields: the tape that
    :func:`adagrad_replay` replays."""
    rule = _OPTIMIZERS["adagrad"]
    tape: List[Tuple] = []

    class _Recorded(rule):
        @classmethod
        def update(cls, cfg, lr, step, params, grads, moments):
            tape.append((params[0].device, float(lr), cfg.eps,
                         [g.to("cpu", copy=True) for g in grads]))
            super().update(cfg, lr, step, params, grads, moments)

    _OPTIMIZERS["adagrad"] = _Recorded
    try:
        yield tape
    finally:
        _OPTIMIZERS["adagrad"] = rule


def adagrad_replay(params, tape,
                   acc=None) -> Tuple[List[torch.Tensor], ...]:
    """The plain reference of a recorded adagrad run: adagrad in float64
    on the CPU from ``params`` (the run's starting tree) and ``acc`` (its
    float32 accumulators there; default zeros, a run from its first
    step) over ``tape``'s updates (:func:`record_adagrad`, one
    device's).  Returns (params, accumulators, slack) as lists of
    leaves; ``slack`` is, per element, what float32 rounding may add
    over the run: at step k, (k + 4) units
    of 2^-24 relative to lr (k roundings of the accumulator, halved by
    the square root, and four of the update) and 2^-23 relative to the
    param.  A float32 run holds each element within its slack of the
    replay however ill-conditioned adagrad's step on it is, since the
    replay consumes the very gradients the run did."""
    p = [t.detach().to("cpu", torch.float64, copy=True)
         for t in tree_leaves(params)]
    acc = [torch.zeros_like(t) for t in p] if acc is None else [
        t.detach().to("cpu", torch.float64, copy=True)
        for t in tree_leaves(acc)]
    slack = [torch.zeros_like(t) for t in p]
    for k, (_, lr, eps, grads) in enumerate(tape, 1):
        for x, a, s, g in zip(p, acc, slack, grads):
            g = g.double()
            a.add_(g * g)
            x.sub_(lr * g / (a.sqrt() + eps))
            s.add_(x.abs() * 2.0 ** -23 + lr * (k + 4) * 2.0 ** -24)
    return p, acc, slack


@register_optimizer("sgd")
class _SGD(OptimizerRule):
    state_keys = ("mom",)

    @classmethod
    def update(cls, cfg, lr, step, params, grads, moments):
        for p, g, m in zip(params, grads, moments["mom"]):
            m.mul_(cfg.momentum).add_(g)            # momentum*m + g
            p.sub_(torch.mul(m.to(p.dtype), lr.to(p.dtype)))


def init(cfg: OptimizerConfig, params: Any) -> Dict:
    """Optimizer state: a 0-d int32 ``step`` and one float32 zero tree
    per moment buffer, on the params' devices (bf16 params + fp32
    moments is the standard mixed-precision recipe)."""
    rule = _rule(cfg.kind)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    state: Dict[str, Any] = {
        "step": torch.zeros((), dtype=torch.int32, device=device)}
    for k in rule.state_keys:
        state[k] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    return state


def _global_norm(leaves: List[torch.Tensor], mesh=None,
                 split: Optional[List[tuple]] = None) -> torch.Tensor:
    """sqrt of the sum of squares, leaf sums added left to right from
    0.0 in tree order, as JAX's ``tree.reduce`` adds them.  Under a
    ``mesh``, ``split`` gives each leaf the axes it is cut over (empty:
    replicated): the cut leaves' sums are added per set of axes and
    summed over those axes (one collective a set), and a replicated
    leaf counts once."""
    device = leaves[0].device if leaves else None
    total = torch.zeros((), dtype=torch.float32, device=device)
    sharded: Dict[tuple, torch.Tensor] = {}
    for i, g in enumerate(leaves):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        axes = split[i] if split is not None else ()
        if axes:
            sharded[axes] = sharded.get(axes, torch.zeros(
                (), dtype=torch.float32, device=device)) + sq
        else:
            total = total + sq
    if sharded:
        from repro_torch.sharding.collectives import psum
        for axes, part in sharded.items():
            total = total + psum(part, mesh, axes)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, mesh=None, specs=None):
    """Scale ``grads`` in place so their global norm is at most
    ``max_norm``; returns (grads, the norm before clipping).

    Under a ``mesh`` with ``specs`` (the gradients' placement: the
    params' spec tree, or the moments' under ZeRO-1,
    ``sharding/rules.py``), ``grads`` are this rank's: a leaf whose spec
    cuts it holds its block and adds its squares over the axes that cut
    it, a replicated leaf counts once, so every rank clips by the one
    global norm (a norm of this rank's blocks alone would differ by
    rank)."""
    leaves = tree_leaves(grads)
    split = None
    if mesh is not None and specs is not None:
        from repro_torch.sharding.rules import spec_leaves, split_axes
        split = [split_axes(s, mesh) for s in spec_leaves(specs)]
        if len(split) != len(leaves):
            raise ValueError(f"{len(split)} specs for {len(leaves)} "
                             f"gradient leaves")
    norm = _global_norm(leaves, mesh, split)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in leaves:
        g.mul_(scale.to(g.dtype))
    return grads, norm


class _AsFloat32:
    """Gradient leaves as float32, each copied when a rule's loop
    reaches it (a float32 leaf is itself), so a bfloat16 model's float32
    gradients never all exist at once."""

    def __init__(self, leaves: List[torch.Tensor]):
        self.leaves = leaves

    def __iter__(self):
        return (g.to(torch.float32) for g in self.leaves)

    def __len__(self) -> int:
        return len(self.leaves)


def _pieces(n: int, params: List[torch.Tensor], grads: List[torch.Tensor],
            moments: Dict[str, List[torch.Tensor]]):
    """The leaves with each one past ``n`` elements split into flat
    pieces of at most ``n``: views of the param and its moments (kept
    whole where one is not contiguous), the gradient's matching
    pieces."""
    p_out, g_out = [], []
    m_out: Dict[str, List[torch.Tensor]] = {k: [] for k in moments}
    for i, (p, g) in enumerate(zip(params, grads)):
        ms = {k: v[i] for k, v in moments.items()}
        if p.numel() <= n or not all(t.is_contiguous() for t in
                                     (p, *ms.values())):
            p_out.append(p)
            g_out.append(g)
            for k, t in ms.items():
                m_out[k].append(t)
            continue
        p_out += p.view(-1).split(n)
        g_out += g.reshape(-1).split(n)
        for k, t in ms.items():
            m_out[k] += t.view(-1).split(n)
    return p_out, g_out, m_out


def apply_updates(cfg: OptimizerConfig, params, grads,
                  state: Dict, mesh=None, specs=None) -> Tuple[Any, Dict]:
    """One optimizer step, in place: ``params`` and the moment trees of
    ``state`` are updated where they lie and ``grads`` are consumed (a
    bf16 gradient is copied to float32 as its leaf's turn comes).
    Returns (params, the new state with ``step`` + 1).  Under a ``mesh``
    the trees are this rank's and ``specs`` the params' spec tree: the
    clip takes the global norm (:func:`clip_by_global_norm`), then each
    leaf updates on its own block, as every elementwise rule may."""
    rule = _rule(cfg.kind)
    step = state["step"]
    with torch.no_grad():
        lr = schedule_lr(cfg, step)
        if cfg.grad_clip is not None:
            clip_by_global_norm(grads, cfg.grad_clip, mesh, specs)
        leaves, g_leaves = tree_leaves(params), tree_leaves(grads)
        moments = {k: tree_leaves(state[k]) for k in rule.state_keys}
        if rule.piece_elements:
            leaves, g_leaves, moments = _pieces(rule.piece_elements, leaves,
                                                g_leaves, moments)
        rule.update(cfg, lr, step, leaves, _AsFloat32(g_leaves), moments)
    return params, {**state, "step": step + 1}


def zero1_cut(p_spec: Tuple, m_spec: Tuple, mesh) -> Optional[Tuple]:
    """(dim, axes) along which ZeRO-1 cuts a moment finer than its param
    (``sharding/rules.py::zero1_spec``), or None: the dim whose entry the
    moment's spec names and the param's does not, over axes of more
    than one rank."""
    for dim, (p, m) in enumerate(zip(p_spec, m_spec)):
        if m is not None and m != p:
            axes = (m,) if isinstance(m, str) else tuple(m)
            if any(mesh.shape[a] > 1 for a in axes):
                return dim, axes
    return None


def apply_updates_zero1(cfg: OptimizerConfig, params, grads, state: Dict,
                        mesh, p_specs, m_specs) -> Tuple[Any, Dict]:
    """One optimizer step under ZeRO-1, in place: ``grads`` (a tree like
    the params', or its leaves in ``tree_leaves`` order) are this rank's
    blocks of the whole (reduced) gradients as the moments are placed
    (``m_specs``, the tree of one moment's specs; ``p_specs`` the
    params').  The clip takes the global norm over those blocks; each
    rank updates the slice of each param that its moments cover, then
    the updated slices are gathered over the axes ZeRO-1 cut them
    over.  Returns (params, the new state with ``step`` + 1)."""
    from repro_torch.sharding.collectives import all_gather, block
    from repro_torch.sharding.rules import spec_leaves
    rule = _rule(cfg.kind)
    step = state["step"]
    with torch.no_grad():
        lr = schedule_lr(cfg, step)
        if cfg.grad_clip is not None:
            clip_by_global_norm(grads, cfg.grad_clip, mesh, m_specs)
        leaves, g_leaves = tree_leaves(params), tree_leaves(grads)
        cuts = [zero1_cut(p, m, mesh) for p, m in
                zip(spec_leaves(p_specs), spec_leaves(m_specs),
                    strict=True)]
        slices = [p if cut is None else block(p, mesh, cut[1], cut[0])
                  for p, cut in zip(leaves, cuts)]
        moments = {k: tree_leaves(state[k]) for k in rule.state_keys}
        p_up, g_up, m_up = slices, g_leaves, moments
        if rule.piece_elements:
            p_up, g_up, m_up = _pieces(rule.piece_elements, slices,
                                       g_leaves, moments)
        rule.update(cfg, lr, step, p_up, _AsFloat32(g_up), m_up)
        for p, part, cut in zip(leaves, slices, cuts):
            if cut is not None:
                p.copy_(all_gather(part, mesh, cut[1], dim=cut[0]))
    return params, {**state, "step": step + 1}


# convenience container ------------------------------------------------

class TrainState:
    """(params, opt_state, step) bundle; checkpoints see it as the pair
    (params, opt_state), as JAX's pytree of the same name flattens."""

    def __init__(self, params, opt_state):
        self.params = params
        self.opt_state = opt_state

    @property
    def step(self) -> torch.Tensor:
        return self.opt_state["step"]

    @staticmethod
    def create(cfg: OptimizerConfig, params) -> "TrainState":
        return TrainState(params, init(cfg, params))


def loss_grads(loss_fn: Callable, params, batch) -> Tuple[Any, Dict]:
    """(gradient tree of ``loss_fn``'s loss in ``params``, its metrics
    detached).  The params take part in autograd only here; a leaf the
    loss does not reach gets zeros."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch)
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, flat)}
    grads = tree_map(lambda p: by_id[id(p)], params)
    return grads, {k: v.detach() for k, v in metrics.items()}


def make_step_fn(cfg: OptimizerConfig, loss_fn: Callable) -> Callable:
    """Standard step: state, batch -> (state, metrics).  ``loss_fn``
    must return (loss, metrics_dict).  The update is in place, so the
    returned state holds the same tensors as the one passed in."""

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        grads, metrics = loss_grads(loss_fn, state.params, batch)
        params, opt_state = apply_updates(cfg, state.params, grads,
                                          state.opt_state)
        return TrainState(params, opt_state), metrics

    return step
