"""Kernel backend dispatch — one switch for every hand-written kernel.

Every hot-path op in ``repro_torch.kernels`` ships two implementations:

  ``cuda``   the hand-written CUDA C++ kernel for Hopper (``csrc/``),
             bound with ctypes by the op's wrapper module
  ``torch``  the plain PyTorch version (``ref.py``) — the same function
             written with ordinary tensor ops; the CPU path and the
             yardstick the kernel is held against on the card

Call sites never branch on hardware.  They call
:func:`dispatch`/``op(..., backend=None)`` and the backend is resolved
in precedence order:

  1. explicit ``backend=`` argument (e.g. from a config field such as
     ``EmbeddingConfig.kernel_backend``); ``"auto"`` and ``None`` both
     mean "no preference"
  2. the ``REPRO_TORCH_KERNEL_BACKEND`` environment variable
  3. ``auto``: resolved from the device of the op's first tensor
     argument — a CUDA tensor gets ``cuda``, a CPU tensor gets ``torch``

There is no silent fallback: asking for ``cuda`` with CPU tensors
raises inside the kernel wrapper, and the wrapper never retries on the
plain version.  An explicit ``torch`` request runs the plain version on
whatever device the tensors are on.

Block-size autotune
-------------------

``register_op`` also takes each op's ``cost``: the FLOPs and bytes a
call must do (:class:`OpCost`), the count its roofline bound and a dry
run (``counting``) read.

``register_op`` accepts a declared *tunable-params spec* — kwarg name
-> :class:`Tunable` (default + candidate values).  :func:`tune` sweeps
the candidate grid over example args, timing each combination on the
resolved backend, and caches the winner keyed by ``(op, backend,
shape-bucket)``, where the bucket rounds every tensor dim up to the
next power of two.  :func:`dispatch` consults the cache for any
declared tunable kwarg the caller leaves unset (or passes as ``None``),
falling back to the declared default; an explicit value always pins.
With nothing tuned and no cache file named, the lookup is skipped: the
serving path pays no shape-bucket work per call.

The in-process cache optionally persists to a JSON file named by the
``REPRO_TORCH_KERNEL_TUNE_CACHE`` environment variable: :func:`tune`
saves after each sweep and the first cache lookup loads it.  A missing
or unreadable file degrades to the declared defaults with a warning —
tuned and default block sizes give bit-identical results by the
kernels' contract.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import time
import warnings
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

BACKENDS = ("auto", "cuda", "torch")

ENV_VAR = "REPRO_TORCH_KERNEL_BACKEND"
TUNE_CACHE_ENV = "REPRO_TORCH_KERNEL_TUNE_CACHE"

_REGISTRY: Dict[str, Dict[str, Callable]] = {}
_TUNABLES: Dict[str, Dict[str, "Tunable"]] = {}
_COSTS: Dict[str, Optional[Callable]] = {}
# the counter a dry run counts dispatched ops into (``counting``)
_COUNTER: Any = None

# (op, backend, shape-bucket) -> {param: value}
_TUNED: Dict[Tuple[str, str, str], Dict[str, Any]] = {}
_tune_file_loaded: Optional[str] = None


# ----------------------------------------------------------------------
# backend selection
# ----------------------------------------------------------------------

def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; "
                         f"expected one of {BACKENDS}")


def _first_tensor(args: Iterable) -> Optional[torch.Tensor]:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a
    return None


def resolve_backend(backend: Optional[str] = None,
                    device: Optional[torch.device] = None) -> str:
    """Resolve a backend request to ``cuda`` or ``torch``.

    Precedence: explicit arg > $REPRO_TORCH_KERNEL_BACKEND > auto.
    ``auto`` resolves from ``device`` — the device of the tensors the
    op will run on — and raises when none is given.
    """
    if backend == "auto":
        backend = None          # "auto" carries no preference
    choice = backend or os.environ.get(ENV_VAR) or "auto"
    _check_backend(choice)
    if choice != "auto":
        return choice
    if device is None:
        raise ValueError("backend 'auto' resolves from the input tensor's "
                         "device; none was given")
    return "cuda" if torch.device(device).type == "cuda" else "torch"


@contextlib.contextmanager
def pinned_backend(backend: Optional[str]):
    """Inside the block every op whose call names no backend resolves to
    ``backend`` (through ``$REPRO_TORCH_KERNEL_BACKEND``); ``None``
    changes nothing."""
    old = os.environ.get(ENV_VAR)
    if backend is not None:
        _check_backend(backend)
        os.environ[ENV_VAR] = backend
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(ENV_VAR, None)
        else:
            os.environ[ENV_VAR] = old


# ----------------------------------------------------------------------
# op registry
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Tunable:
    """One autotunable kwarg of a kernel op: its default plus the
    candidate values :func:`tune` sweeps.  Candidates must be
    value-interchangeable — the op's output is bit-identical across
    them (block geometry only changes the schedule)."""

    default: Any
    candidates: Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class OpCost:
    """What one call of an op must do, whatever runs it: its FLOPs, of
    one type (``dtype``, the name of the torch dtype whose peak bounds
    them), and the bytes it must move (each input read once, each output
    written once).  The roofline's bound of a call
    (``roofline/model.py::kernel_roofline``) and a dry run's count of a
    dispatched op (``roofline/model.py::CostCounter``) read it."""

    flops: float
    bytes: float
    dtype: str = "float32"


def dtype_name(t: torch.Tensor) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``."""
    return str(t.dtype).rsplit(".", 1)[-1]


def register_op(name: str, *, cuda: Callable, torch: Callable,
                tunables: Optional[Dict[str, Tunable]] = None,
                cost: Optional[Callable[..., OpCost]] = None) -> None:
    """Register one op's two implementations, its autotunable
    block-geometry kwargs (an empty dict means nothing to sweep) and
    ``cost(*args, **kwargs)``: the :class:`OpCost` of a call."""
    _REGISTRY[name] = {"cuda": cuda, "torch": torch}
    _TUNABLES[name] = dict(tunables or {})
    _COSTS[name] = cost


def op_cost(name: str, *args, **kwargs) -> OpCost:
    """The :class:`OpCost` of calling op ``name`` on these arguments."""
    _impls(name)
    if _COSTS.get(name) is None:
        raise KeyError(f"kernel op {name!r} declares no cost")
    return _COSTS[name](*args, **kwargs)


@contextlib.contextmanager
def counting(counter):
    """Inside the block every dispatched op is counted as one op with its
    cost: ``counter.add_op(name, cost)``, its implementation run under
    ``counter.paused()`` (the aten ops of the plain version that gives
    its output shapes on the meta device are not counted)."""
    global _COUNTER
    old, _COUNTER = _COUNTER, counter
    try:
        yield counter
    finally:
        _COUNTER = old


def registered_ops() -> Dict[str, Dict[str, Callable]]:
    _ensure_registered()
    return dict(_REGISTRY)


def _ensure_registered() -> None:
    if not _REGISTRY:
        # ops.py modules register themselves at import time
        import repro_torch.kernels  # noqa: F401


def _impls(name: str) -> Dict[str, Callable]:
    _ensure_registered()
    if name not in _REGISTRY:
        raise KeyError(f"kernel op {name!r} not registered; known: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def dispatch(name: str, *args, backend: Optional[str] = None, **kwargs):
    """Run op ``name`` on the backend resolved for its first tensor
    argument's device.  Declared tunable kwargs left unset (or None)
    resolve through the autotune cache, falling back to the declared
    defaults; explicit values always pin."""
    impls = _impls(name)
    t = _first_tensor(args)
    be = resolve_backend(backend, None if t is None else t.device)
    spec = _TUNABLES[name]
    unset = [p for p in spec if kwargs.get(p) is None]
    if unset:
        tuned = _cached(name, be, args)
        for p in unset:
            kwargs[p] = tuned.get(p, spec[p].default)
    counter = _COUNTER
    if counter is not None:
        # the cost's own reads of the arguments are not the op's work
        with counter.paused():
            cost = op_cost(name, *args, **kwargs)
            out = impls[be](*args, **kwargs)
        counter.add_op(name, cost)
        return out
    return impls[be](*args, **kwargs)


# ----------------------------------------------------------------------
# block-size autotune
# ----------------------------------------------------------------------

def op_tunables(name: str) -> Dict[str, Tunable]:
    """Declared tunable spec for ``name`` (empty when none declared)."""
    _ensure_registered()
    return dict(_TUNABLES.get(name, {}))


def _bucket_dim(n: int) -> int:
    return 1 << (int(n) - 1).bit_length() if n > 0 else 0


def shape_bucket(*args) -> str:
    """Canonical shape-bucket key for a call's positional args: tensors
    contribute ``dtype[dims]`` with every dim rounded up to the next
    power of two; anything else contributes its repr."""
    parts = []
    for a in args:
        if isinstance(a, torch.Tensor):
            dims = "x".join(str(_bucket_dim(d)) for d in a.shape)
            dtype = str(a.dtype).removeprefix("torch.")
            parts.append(f"{dtype}[{dims}]")
        else:
            parts.append(repr(a))
    return ",".join(parts)


def _tune_file() -> Optional[str]:
    return os.environ.get(TUNE_CACHE_ENV) or None


def _maybe_load_tune_file() -> None:
    """Merge the JSON cache file named by $REPRO_TORCH_KERNEL_TUNE_CACHE
    into the in-process cache (once per distinct path; in-process
    entries win).  Any read/parse failure warns and falls back to the
    declared defaults."""
    global _tune_file_loaded
    path = _tune_file()
    if path is None or path == _tune_file_loaded:
        return
    _tune_file_loaded = path
    if not os.path.exists(path):
        return
    try:
        with open(path) as f:
            raw = json.load(f)
        entries = []
        for op, per_backend in raw.items():
            for be, per_bucket in per_backend.items():
                _check_backend(be)
                for bucket, params in per_bucket.items():
                    if not isinstance(params, dict):
                        raise ValueError(f"params for {op}/{be}/{bucket} "
                                         f"not a dict")
                    entries.append(((op, be, bucket), dict(params)))
    except (OSError, ValueError, AttributeError) as e:
        warnings.warn(f"ignoring invalid kernel tune cache {path!r}: {e}; "
                      f"falling back to default block sizes",
                      RuntimeWarning, stacklevel=2)
        return
    for key, params in entries:
        _TUNED.setdefault(key, params)


def save_tune_cache(path: Optional[str] = None) -> Optional[str]:
    """Write the in-process tune cache as JSON to ``path`` (default:
    $REPRO_TORCH_KERNEL_TUNE_CACHE); None when neither names a file."""
    path = path or _tune_file()
    if path is None:
        return None
    out: Dict[str, Dict[str, Dict[str, Dict[str, Any]]]] = {}
    for (op, be, bucket), params in sorted(_TUNED.items()):
        out.setdefault(op, {}).setdefault(be, {})[bucket] = params
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    return path


def clear_tune_cache() -> None:
    """Drop every in-process tuned entry (tests; does not touch the
    JSON file) and forget which file was loaded."""
    global _tune_file_loaded
    _TUNED.clear()
    _tune_file_loaded = None


def _cached(name: str, backend: str, args: Tuple) -> Dict[str, Any]:
    """Tuned kwargs of ``(name, backend, bucket of args)``; the shape
    bucket is built only when something was tuned or a file is named."""
    _maybe_load_tune_file()
    if not _TUNED:
        return {}
    return _TUNED.get((name, backend, shape_bucket(*args)), {})


def tuned_params(name: str, args: Iterable, *,
                 backend: Optional[str] = None) -> Dict[str, Any]:
    """Cached tuned kwargs for op ``name`` called with ``args`` on the
    resolved backend — ``{}`` when the shape bucket was never tuned."""
    if not _TUNABLES.get(name):
        return {}
    args = tuple(args)
    t = _first_tensor(args)
    be = resolve_backend(backend, None if t is None else t.device)
    return dict(_cached(name, be, args))


def _sync(out) -> None:
    """Wait for the card when the op's result lies on it: PyTorch
    returns before the device finishes, so an unsynchronised clock
    measures only the enqueue."""
    tensors = out if isinstance(out, (tuple, list)) else (out,)
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def _default_timer(thunk: Callable[[], Any], iters: int) -> float:
    _sync(thunk())                      # build + warm outside the clock
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(thunk())
        best = min(best, time.perf_counter() - t0)
    return best


def tune(name: str, args_sets: Iterable, *, backend: Optional[str] = None,
         iters: int = 3, timer: Optional[Callable] = None,
         force: bool = False, save: bool = True) -> Dict[str, Dict[str, Any]]:
    """Sweep op ``name``'s declared tunable candidates over example
    calls and cache the fastest config per shape bucket.

    ``args_sets``: iterable of positional-arg tuples (real tensors —
    the sweep executes the op).  ``timer(thunk, iters)`` overrides the
    measurement (tests inject a deterministic one).  Already-tuned
    buckets are returned from cache unless ``force``.  The declared
    default combo is swept first and a challenger must strictly beat
    it, so ties keep the default.  Returns ``{shape_bucket: winning
    params}`` and, when ``save`` and $REPRO_TORCH_KERNEL_TUNE_CACHE is
    set, persists the cache file.
    """
    impls = _impls(name)
    spec = _TUNABLES[name]
    timer = timer or _default_timer
    out: Dict[str, Dict[str, Any]] = {}
    params_names = list(spec)
    combos = [dict(zip(params_names, values))
              for values in itertools.product(
                  *(spec[p].candidates for p in params_names))] or [{}]
    defaults = {p: spec[p].default for p in params_names}
    if params_names:
        combos = [defaults] + [c for c in combos if c != defaults]
    for args in args_sets:
        if not isinstance(args, tuple):
            args = (args,)
        t = _first_tensor(args)
        be = resolve_backend(backend, None if t is None else t.device)
        impl = impls[be]
        bucket = shape_bucket(*args)
        key = (name, be, bucket)
        if not force and key in _TUNED:
            out[bucket] = dict(_TUNED[key])
            continue
        best: Optional[Tuple[float, Dict[str, Any]]] = None
        for combo in combos:
            try:
                elapsed = timer(lambda: impl(*args, **combo), iters)
            except (ValueError, RuntimeError):  # combo invalid for shape
                continue
            if best is None or elapsed < best[0]:
                best = (elapsed, combo)
        if best is None:
            raise ValueError(f"no tunable candidate of {name!r} ran for "
                             f"bucket {bucket!r}")
        _TUNED[key] = dict(best[1])
        out[bucket] = dict(best[1])
    if save:
        save_tune_cache()
    return out


__all__ = ["BACKENDS", "ENV_VAR", "OpCost", "TUNE_CACHE_ENV", "Tunable",
           "clear_tune_cache", "counting", "dispatch", "dtype_name",
           "op_cost", "op_tunables",
           "register_op", "registered_ops", "resolve_backend",
           "save_tune_cache", "shape_bucket", "tune", "tuned_params"]
