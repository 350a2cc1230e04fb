"""Three-term roofline model on H100 SXM data-sheet constants, and the
counts a dry run traces on the meta device.

    compute term    = Σ over dtypes of FLOPs(dtype) / peak(dtype)
    memory term     = bytes / HBM bandwidth
    collective term = Σ over mesh axes of bytes(axis) / link(axis)

per rank of the mesh.  The terms are seconds; the largest is the
bottleneck that a perfect overlap could not hide.  Peaks (NVIDIA H100
SXM data sheet): 3.35 TB/s of HBM3; 67 TFLOP/s in float32 outside the
tensor cores (TF32 stays off, as the parity tests pin it); 989 TFLOP/s
dense bfloat16; NVLink 450 GB/s a direction within an 8-GPU node, and
50 GB/s (NDR InfiniBand, one NIC a GPU) for an axis whose ranks span
nodes, ranks laid out row-major, 8 a node.

The counts come from one step of a built cell traced on the meta
device (:class:`CostCounter`): FLOPs by ``torch.utils.flop_counter``'s
per-op formulas, split by the dtype of each op's first tensor; bytes as
each aten op's input and output bytes, views excluded; a peak from the
storages alive; each dispatched kernel op (``kernels/dispatch.py``)
counted once at its own ``cost``.  The port runs eagerly, op by op, so
these bytes are its real traffic less what the caches catch; they are
not a fused program's.  Collectives come from the mesh's ``CommStats``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

HBM_BW = 3.35e12                     # bytes/s
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
NVLINK_BW = 450e9                    # bytes/s a direction, within a node
IB_BW = 50e9                         # bytes/s a GPU, across nodes
GPUS_PER_NODE = 8


def peak_flops(dtype: str) -> float:
    """The peak of FLOPs of ``dtype``; any other type than the half
    types at float32's (the CUDA cores)."""
    return PEAK_FLOPS.get(dtype, PEAK_FLOPS["float32"])


def axis_link_bw(mesh_shape: Dict[str, int], axis: str) -> float:
    """The link bandwidth of ``axis`` of a mesh of ``mesh_shape`` (axis ->
    size, in mesh order; ranks row-major, ``GPUS_PER_NODE`` a node):
    NVLink when every group of the axis lies within one node, else
    InfiniBand."""
    names = list(mesh_shape)
    n = mesh_shape[axis]
    stride = math.prod(mesh_shape[a] for a in names[names.index(axis) + 1:])
    size = math.prod(mesh_shape.values())
    for base in range(size):
        if (base // stride) % n:
            continue                 # not the first rank of its group
        last = base + (n - 1) * stride
        if base // GPUS_PER_NODE != last // GPUS_PER_NODE:
            return IB_BW
    return NVLINK_BW


@dataclasses.dataclass
class RooflineTerms:
    """The three terms of one rank's step (the JAX package's fields)."""

    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float                 # one rank's traced FLOPs
    hlo_bytes: float                 # one rank's traced bytes
    collective_bytes: float          # bytes a rank sends into collectives
    model_flops: float = 0.0         # useful FLOPs of the step, every rank
    chips: int = 1

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_fraction(self) -> Optional[float]:
        """MODEL_FLOPS / (traced FLOPs · chips): how much of the traced
        compute is useful (remat's recompute and redundancy lower it)."""
        if not self.model_flops or not self.hlo_flops:
            return None
        return self.model_flops / (self.hlo_flops * self.chips)

    @property
    def roofline_fraction(self) -> Optional[float]:
        """The share of the bound that the useful FLOPs would take at the
        step's own mix of peaks (compute_s per traced FLOP): (useful
        FLOPs / chips at that rate) / bound_s."""
        if not self.model_flops or self.bound_s <= 0 or not self.hlo_flops:
            return None
        rate = self.compute_s / self.hlo_flops
        return self.model_flops / self.chips * rate / self.bound_s

    def row(self) -> Dict:
        return {"compute_ms": self.compute_s * 1e3,
                "memory_ms": self.memory_s * 1e3,
                "collective_ms": self.collective_s * 1e3,
                "dominant": self.dominant,
                "useful_frac": self.useful_fraction,
                "roofline_frac": self.roofline_fraction}


def terms(flops_by_dtype: Dict[str, float], nbytes: float,
          axis_bytes: Dict[str, float], mesh_shape: Dict[str, int],
          model_flops: float = 0.0) -> RooflineTerms:
    """The terms of one rank's counts: FLOPs by dtype, bytes, and the
    bytes it sends over each axis of a mesh of ``mesh_shape``."""
    return RooflineTerms(
        compute_s=sum(f / peak_flops(d) for d, f in flops_by_dtype.items()),
        memory_s=nbytes / HBM_BW,
        collective_s=sum(b / axis_link_bw(mesh_shape, a)
                         for a, b in axis_bytes.items()),
        hlo_flops=float(sum(flops_by_dtype.values())), hlo_bytes=nbytes,
        collective_bytes=float(sum(axis_bytes.values())),
        model_flops=model_flops, chips=math.prod(mesh_shape.values()))


def kernel_roofline(flops: float, nbytes: float,
                    measured_s: Optional[float] = None,
                    dtype: str = "float32") -> Dict:
    """The least time one kernel call can take: the larger of its bytes
    over HBM and its FLOPs over ``dtype``'s peak (``bound_ms``, bound by
    ``"bytes"`` or ``"operations"``), and the share of it a call of
    ``measured_s`` reaches, uncapped: a share above 1 means the count of
    FLOPs or bytes is wrong."""
    t_ops = flops / peak_flops(dtype)
    t_bytes = nbytes / HBM_BW
    bound = max(t_ops, t_bytes)
    frac = None
    if measured_s and bound > 0:
        frac = bound / measured_s
    return {"bound_ms": bound * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "roofline_fraction": frac, "flops": flops, "bytes": nbytes}


def op_roofline(name: str, *args, measured_s: Optional[float] = None,
                **kwargs) -> Dict:
    """:func:`kernel_roofline` of one call of the dispatched op ``name``
    on these arguments, from its ``cost`` (``kernels/dispatch.py``)."""
    from repro_torch.kernels.dispatch import op_cost
    c = op_cost(name, *args, **kwargs)
    return kernel_roofline(c.flops, c.bytes, measured_s, c.dtype)


# ----------------------------------------------------------------------
# MODEL_FLOPS estimates (useful FLOPs a step)
# ----------------------------------------------------------------------

def lm_train_model_flops(n_params_active: int, tokens: int) -> float:
    """6·N·D for a train step (forward 2ND, backward 4ND)."""
    return 6.0 * n_params_active * tokens


def lm_forward_model_flops(n_params_active: int, tokens: int) -> float:
    """2·N·D for inference (prefill: tokens = B·S; decode: tokens = B)."""
    return 2.0 * n_params_active * tokens


# ----------------------------------------------------------------------
# the operations a step does as the port computes it (the card's bounds)
# ----------------------------------------------------------------------

def lm_prefill_flops(cfg, b: int, s: int) -> int:
    """The operations of one prefill of ``b`` prompts of ``s`` tokens as
    the port computes it: every projection, attention's two products
    over each layer's visible pairs, the FFN (an MoE layer's router and
    its capacity-padded expert GEMMs: E x cap rows whatever the routing)
    and the last token's vocab head."""
    from repro_torch.kernels.flash_attention.ops import visible_pairs
    from repro_torch.models import lm
    from repro_torch.nn import moe
    d, hd, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    t = b * s
    proj = 4 * t * d * hd * (cfg.num_heads + cfg.num_kv_heads)
    if cfg.is_moe:
        cap = moe.capacity(t, cfg.num_experts, cfg.num_experts_per_tok,
                           cfg.moe_capacity_factor)
        ffn = 2 * t * d * cfg.num_experts + 6 * cfg.num_experts * cap * d * f
    else:
        ffn = 6 * t * d * f
    attn = sum(4 * hd * cfg.num_heads * b * visible_pairs(s, window)
               for _, _, window, _ in lm._layer_plan(cfg, s))
    return cfg.num_layers * (proj + ffn) + attn + 2 * b * d * cfg.vocab_size


def lm_train_flops(cfg, b: int, s: int) -> tuple:
    """(the operations of one training step of ``b`` x ``s`` tokens as
    the card must do them, the parts): 6·N·T for the weights that
    multiply each token (every projection, the FFN, an MoE layer's
    router and its top-k experts only, the vocab head; not the token
    table, a gather), the remat forward 2·N·T (every layer and each xent
    chunk recomputed), and attention's products over each layer's
    visible pairs: 4·hd a pair and head forward, again in the remat
    forward, and 10·hd in the backward (P recomputed, then dV, dP, dQ,
    dK)."""
    from repro_torch.kernels.flash_attention.ops import visible_pairs
    from repro_torch.models import lm
    t = b * s
    d, hd = cfg.d_model, cfg.resolved_head_dim
    ffn = 3 * d * cfg.d_ff
    if cfg.is_moe:
        ffn = ffn * cfg.num_experts_per_tok + d * cfg.num_experts
    n = (cfg.num_layers * (d * hd * 2 * (cfg.num_heads + cfg.num_kv_heads)
                           + ffn) + d * cfg.vocab_size)
    pairs = sum(visible_pairs(s, window) for _, _, window, _ in
                lm._layer_plan(cfg, s)) * b * cfg.num_heads
    parts = {"weights": 6 * n * t, "remat": 2 * n * t,
             "attention": 18 * hd * pairs}
    return sum(parts.values()), parts


def gnn_step_flops(cfg, n: int, e: int, d_feat: int) -> float:
    """The operations of one MACE training step over ``n`` nodes and
    ``e`` edges: ``launch/cells.py::mace_model_flops``, plus the feature
    projection's (forward and backward, 3 x 2·N·F·C)."""
    from repro_torch.launch.cells import mace_model_flops
    return mace_model_flops(cfg, n, e, train=True) \
        + 6.0 * n * d_feat * cfg.d_hidden


# ----------------------------------------------------------------------
# counting a traced step
# ----------------------------------------------------------------------

def _flop_registry() -> dict:
    from torch.utils import flop_counter
    reg = getattr(flop_counter, "flop_registry", None)
    if reg is None:
        reg = flop_counter.FlopCounterMode().flop_registry
    return reg


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


# ops that move no data: allocations that write nothing, and metadata
_FREE = ("empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "lift_fresh")


class CostCounter(TorchDispatchMode):
    """Counts what the ops run inside it do: FLOPs by dtype
    (``torch.utils.flop_counter``'s formulas), bytes (each aten op's
    inputs and outputs, views and allocations excluded), the peak of the
    bytes its ops' outputs hold alive, and every dispatched kernel op
    once, at its ``cost`` (``kernels/dispatch.py::counting`` pauses the
    count inside it)."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[str, float] = {}
        self.bytes = 0
        self.ops: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._paused = 0
        self._registry = _flop_registry()

    def add_op(self, name: str, cost) -> None:
        self.ops[name] = self.ops.get(name, 0) + 1
        self.flops[cost.dtype] = self.flops.get(cost.dtype, 0) + cost.flops
        self.bytes += cost.bytes

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        name = func._overloadpacket.__name__
        if _is_view(func) or name in _FREE:
            return out
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        self.bytes += sum(_nbytes(t) for t in ins) + sum(
            _nbytes(t) for t in outs)
        fn = self._registry.get(func._overloadpacket)
        if fn is not None and ins:
            dtype = str(ins[0].dtype).rsplit(".", 1)[-1]
            self.flops[dtype] = self.flops.get(dtype, 0) + fn(
                *args, **kwargs, out_val=out)
        seen = {id(t) for t in ins}
        for t in outs:
            if id(t) not in seen:
                n = _nbytes(t)
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(t, self._free, n)
        return out


__all__ = ["CostCounter", "GPUS_PER_NODE", "HBM_BW", "IB_BW", "NVLINK_BW",
           "PEAK_FLOPS", "RooflineTerms", "axis_link_bw", "gnn_step_flops",
           "kernel_roofline", "lm_forward_model_flops", "lm_prefill_flops",
           "lm_train_flops", "lm_train_model_flops", "op_roofline",
           "peak_flops", "terms"]
