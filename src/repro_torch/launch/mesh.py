"""Device meshes over ``torch.distributed`` process groups.

One process per rank.  A :class:`Mesh` names the axes of the ranks
(``"data"`` and ``"model"``, and ``"pod"`` for the multi-pod shape)
over a ``torch.distributed.device_mesh.DeviceMesh``; every rank holds
plain local tensors and calls the explicit collectives of
``sharding/collectives.py`` over the mesh's per-axis groups — what the
body of a ``shard_map`` does in the JAX package.  There is no ambient
mesh: the engines, ``quantized_gather`` and ``sharded_topk`` take
``mesh=`` explicitly.

A mesh needs a process group whose world size equals its size.
:func:`init_distributed` starts one from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) with an explicit backend:
``nccl`` for one rank per card, ``gloo`` for CPU ranks or for ranks
that share a card (NCCL refuses two ranks on one device; gloo carries
the collectives of CUDA tensors through host memory).  :func:`spawn`
starts a group of local ranks for tests and demos, as the JAX
package's ``force_host_device_count`` gives one process several XLA
host devices.  An :class:`AbstractMesh` (``jax.sharding.AbstractMesh``'s
counterpart) names the same axes with no process group behind them: it
stands for one rank of a mesh of any size, its device is ``meta``, and
the collectives on it only count what they would move (the dry run,
``launch/dryrun.py``).

Nothing here touches ``torch.distributed`` or the card at import.
"""
from __future__ import annotations

import contextlib
import datetime
import io
import math
import multiprocessing
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

BACKENDS = ("nccl", "gloo")
# a collective that waits longer than this raises instead of hanging
DEFAULT_TIMEOUT_S = 300.0


class Mesh:
    """Named axes over the ranks of the default process group.

    ``shape`` maps each axis name to its size, in mesh order (rank r
    sits at the row-major coordinate of r); ``device`` is this rank's
    device.  The per-axis groups come from a ``DeviceMesh``, built on
    the CPU device type for gloo (so it never picks a card for the
    rank) and on ``cuda`` for NCCL."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device=None):
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != \
                len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names "
                             f"{axis_names} must pair one to one")
        size = math.prod(shape)
        if not dist.is_initialized():
            raise RuntimeError(
                f"a mesh of {size} ranks needs a process group of world "
                f"size {size}; none is initialised (init_distributed, or "
                f"spawn for local ranks)")
        world = dist.get_world_size()
        if world != size:
            raise ValueError(f"mesh {dict(zip(axis_names, shape))} has "
                             f"{size} ranks but the process group has "
                             f"world size {world}")
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.size = size
        self.device = rank_device(device)
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        self.device_mesh = init_device_mesh(device_type, shape,
                                            mesh_dim_names=axis_names)
        # a ``sharding.collectives.CommStats`` to count the collectives
        # made through this mesh; None counts nothing
        self.stats = None

    # the collectives run (``sharding/collectives.py``)
    abstract = False

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.device_mesh.get_local_rank(axis)


class AbstractMesh:
    """Named axes of a mesh that no process group backs, standing for its
    rank ``rank`` (row-major, as :class:`Mesh` lays ranks out): the same
    ``shape``, ``axis_names``, ``size``, ``axis_index`` and ``stats``,
    ``device`` meta.  A collective on it makes no ``torch.distributed``
    call: it counts into ``stats`` what the rank would send and returns
    a meta tensor of the shape it would return
    (``sharding/collectives.py``), so a cell built on it holds meta
    tensors of exactly the rank's shapes."""

    abstract = True

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: int = 0):
        shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != \
                len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names "
                             f"{axis_names} must pair one to one")
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.size = math.prod(shape)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not one of the {self.size} "
                             f"ranks of mesh {self.shape}")
        self.rank = rank
        self.device = torch.device("meta")
        self.stats = None
        coords, r = {}, rank
        for a in reversed(axis_names):
            r, coords[a] = divmod(r, self.shape[a])
        self._coords = coords

    def group(self, axis: str):
        raise RuntimeError(f"an abstract mesh {self.shape} has no process "
                           f"group (axis {axis!r})")

    def axis_index(self, axis: str) -> int:
        """The coordinate of the rank it stands for along ``axis``."""
        return self._coords[axis]

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape}, rank={self.rank})"


def abstract_production_mesh(*, multi_pod: bool = False,
                             rank: int = 0) -> AbstractMesh:
    """:func:`make_production_mesh`'s axes as an :class:`AbstractMesh`."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"), rank)
    return AbstractMesh((16, 16), ("data", "model"), rank)


# the device this process's group was started for (``_start_group``)
_GROUP_DEVICE: Optional[torch.device] = None


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` when given, else the one its
    process group was started for, else the card ``cuda:<LOCAL_RANK>``
    (torchrun's variable; 0 when unset).  No rank is moved to another
    card by a modulus: ranks that share one card name it."""
    if device is None:
        device = _GROUP_DEVICE or \
            f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def _check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS} (nccl: one "
                         f"rank per card; gloo: CPU ranks or ranks "
                         f"sharing a card), got {backend!r}")
    return backend


def _start_group(backend: str, device: torch.device, init_method: str,
                 rank: int, world: int, timeout_s: float) -> None:
    global _GROUP_DEVICE
    import torch.distributed as dist
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank device {device} requested but no "
                               f"CUDA device is available")
        torch.cuda.set_device(device)
    dist.init_process_group(
        _check_backend(backend), init_method=init_method, rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    _GROUP_DEVICE = device


def init_distributed(backend: str, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Start the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, and its rendezvous
    address) with the named ``backend``; returns this rank's device
    (:func:`rank_device`).  Without torchrun's variables the group has
    one rank."""
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    device = rank_device(device)
    if "MASTER_ADDR" in os.environ:
        init_method = "env://"
    else:                       # one rank on its own: a private store
        init_method = "file://" + os.path.join(
            tempfile.mkdtemp(prefix="repro_torch_pg_"), "store")
    _start_group(backend, device, init_method, rank, world, timeout_s)
    return device


def make_debug_mesh(n_data: int = 2, n_model: int = 4, *,
                    multi_pod: bool = False, device=None) -> Mesh:
    """(data, model), or (pod=2, data, model) with ``multi_pod``: the
    JAX package's small mesh for sharding tests (8 ranks by default)."""
    if multi_pod:
        return Mesh((2, n_data, n_model), ("pod", "data", "model"), device)
    return Mesh((n_data, n_model), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """Single pod: (data=16, model=16), 256 ranks.  Multi-pod: (pod=2,
    data=16, model=16), 512 ranks.  Raises on any other world size —
    it never shrinks to the group it finds."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"), device)
    return Mesh((16, 16), ("data", "model"), device)


def parse_mesh(spec: str):
    """'data=2,model=2' -> (("data", "model"), (2, 2))."""
    axes, shape = [], []
    for part in spec.split(","):
        name, _, n = part.partition("=")
        if not n:
            raise ValueError(f"bad mesh axis {part!r}; want name=N")
        axes.append(name.strip())
        shape.append(int(n))
    return tuple(axes), tuple(shape)


def mesh_of_spec(spec: str, command: str, sharded: str):
    """(axes, shape) of a CLI's ``--mesh`` ('data=2,model=2'), checked
    against the world torchrun started: a mesh with no ``model`` axis to
    shard the ``sharded`` leaves over, or a world size that is not the
    mesh's, raises ``ValueError``, naming ``command`` (``-m
    repro_torch.launch.<cli>``)."""
    import torch.distributed as dist
    axes, shape = parse_mesh(spec)
    if "model" not in axes:
        raise ValueError(f"mesh {dict(zip(axes, shape))} has no 'model' "
                         f"axis to shard {sharded} over")
    need = math.prod(shape)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world != need:
        raise ValueError(
            f"--mesh {spec} needs {need} ranks, found {world} (one process "
            f"a rank: python -m torch.distributed.run --nproc-per-node "
            f"{need} {command} ...)")
    return axes, shape


def run_on_mesh(axes, shape, backend: str, device, fn: Callable):
    """``fn(mesh)`` on this rank's mesh, for a CLI under torchrun (one
    process a rank): join the process group, or start it from
    torchrun's environment with ``backend`` (and end it after), with
    ``device`` the rank's (None: its card).  Ranks other than 0 print
    nothing."""
    import torch.distributed as dist
    started = not dist.is_initialized()
    if started:
        init_distributed(backend, device=device)
    try:
        mesh = Mesh(shape, axes, device=device)
        if dist.get_rank() == 0:
            return fn(mesh)
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(mesh)
    finally:
        if started:
            dist.destroy_process_group()


# ----------------------------------------------------------------------
# local ranks for tests and demos
# ----------------------------------------------------------------------

def _rank_main(fn, rank, world, backend, device, store, timeout_s, args,
               results) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist
    try:
        _start_group(backend, torch.device(device), "file://" + store,
                     rank, world, timeout_s)
        # every rank's connections made before any rank goes on: one that
        # ran ahead, finished and closed its group would cut a peer still
        # connecting (gloo's "connectFullMesh failed")
        dist.barrier()
        out = ("ok", fn(rank, *args))
    except BaseException:          # reported to the parent, not raised
        out = ("error", traceback.format_exc())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    # pickled here, so the queue carries bytes: a tensor in a result
    # crosses as its data, not as a handle into this process's memory
    results.put((rank, pickle.dumps(out)))


def spawn(fn: Callable, world: int, backend: str = "gloo", device="cpu",
          args: Tuple = (), store_dir: Optional[str] = None,
          timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``world`` local ranks, each its own
    process in a process group of that size, and return their results
    in rank order.

    Every rank uses ``device`` (ranks that share a card pass it, e.g.
    ``cuda:0`` with gloo) and one CPU thread.  The group starts from a
    ``file://`` store in ``store_dir`` (default: a fresh temporary
    directory), so concurrent groups never share a port; it waits at
    most ``timeout_s`` in its start and in any collective.  The ranks
    are forked from a server that imported torch, not from the caller
    (whose JAX or CUDA state must not cross); that server imports the
    caller's main module, so a script guards its entry point with
    ``if __name__ == "__main__"``.  ``fn`` and ``args`` must pickle: a
    module-level function.  Raises, after stopping every rank, when a
    rank raises, dies or outlives ``timeout_s``."""
    _check_backend(backend)
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["repro_torch.launch.mesh"])
    store_dir = store_dir or tempfile.mkdtemp(prefix="repro_torch_pg_")
    store = os.path.join(str(store_dir), f"store-{uuid.uuid4().hex}")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, backend, str(device), store,
                               timeout_s, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got: Dict[int, Any] = {}
    try:
        while len(got) < world:
            try:
                rank, blob = results.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in got]
                if dead:
                    # a result may still be in flight: drain once more
                    try:
                        rank, blob = results.get(timeout=2.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"rank(s) {dead} of {world} died without a "
                            f"result (exit codes "
                            f"{[procs[r].exitcode for r in dead]})") \
                            from None
                elif time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world} ranks did not finish within "
                        f"{timeout_s:.0f}s; ranks {sorted(got)} did")
                else:
                    continue
            status, value = pickle.loads(blob)
            if status == "error":
                raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                   f"{value}")
            got[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        if alive:
            raise TimeoutError(f"ranks {alive} did not exit")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
    return [got[r] for r in range(world)]


__all__ = ["AbstractMesh", "BACKENDS", "DEFAULT_TIMEOUT_S", "Mesh",
           "abstract_production_mesh", "init_distributed",
           "make_debug_mesh", "make_production_mesh", "mesh_of_spec",
           "parse_mesh", "rank_device", "run_on_mesh", "spawn"]
