"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm \\
        --full --steps 5 --batch 4096
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm \\
        --device cpu --steps 5 --ckpt-dir build/ckpt --ckpt-every 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
        --full --batch 1 --seq 4096 --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch mace \\
        --full --steps 5
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 -m repro_torch.launch.train --arch deepfm \\
        --full --steps 5 --batch 4096 --mesh data=2,model=2 \\
        --dist-backend gloo --device cuda:0
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 -m repro_torch.launch.train --arch stablelm-3b \\
        --device cpu --steps 4 --mesh data=2,model=2 --dist-backend gloo \\
        --opts fsdp
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 -m repro_torch.launch.train --arch mace \\
        --full --steps 5 --mesh data=2,model=2 --dist-backend gloo \\
        --device cuda:0

trains on the card unless ``--device cpu`` is given (``--smoke``, the
reduced config, is the default; ``--full`` is the published one).  The
loop includes checkpoint/auto-resume, straggler detection and optional
failure injection (``--fail-at``) to exercise the fault-tolerance path
end to end.  Ported: the recsys and LM branches of the JAX package's
launcher.  Every recsys arch trains with adagrad at lr 1e-2 (global-norm
clip 1.0): ``deepfm`` and ``autoint`` on ``CTRStream`` batches, ``bst``
and ``two-tower-retrieval`` on uniform ids drawn as the JAX launcher
draws them.  Every LM arch trains ``models/lm.py::loss_fn`` with adamw
at lr 3e-4 (20 warmup steps, cosine to step 1,000) on uniform tokens,
``--seq`` of them a row.  ``mace`` (the GNN family) trains
``MACE.energy_loss`` with adam at lr 1e-3 on ``molecule_batch``es of
``min(--batch, 32)`` molecules of 12 atoms and 24 edges, batch ``s``
drawn from seed ``s``, as the JAX launcher trains it.

``--mesh data=D,model=M`` trains any arch on a mesh, one
process a rank under torchrun (``--dist-backend``: ``nccl`` for a card
a rank, ``gloo`` for ranks that share a card or run on the CPU): the
recsys rules row-shard the large tables over ``model`` and the batch
over ``data`` (``launch/cells.py::recsys_train_cell``); the LM rules
split the layers over ``model`` (tensor parallel), the batch over
``data`` and adam's moments over ``data`` too (ZeRO-1), with
``--microbatches`` gradient accumulation
(``launch/cells.py::lm_train_cell``, the LM optimizer above).  Every
rank draws the same stream and takes its data shard, checkpoints hold
whole arrays, and a resume places them on whatever mesh resumes.  Rank
0 prints.  ``--opts`` applies the JAX package's named LM options
(``launch/cells.py::LM_CFG_OPTS``: ``moe_shard_map``, ``remat_group``,
``split_cache``, ``xent_chunk_256``, ``attn_block_2048``, ``fsdp``,
``kv_repeat``).  ``mace`` on a mesh splits each molecule batch's nodes
and edges over every axis and its channels over ``model``
(``gnn_param_rules``, ``launch/cells.py::mace_cell``), adam's moments
whole on every rank.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core.api import resolve_device
from repro_torch.core.schemes.base import tree_leaves
from repro_torch.launch.mesh import BACKENDS, mesh_of_spec, run_on_mesh
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.loop import LoopConfig, fit
from repro_torch.train.optimizer import TrainState
from repro_torch.train.resilience import FailureInjector


def recsys_stream(cfg, batch: int, start: int = 0):
    """An endless stream of ``cfg``'s training batches as CPU tensors,
    from batch ``start`` on, drawn as the JAX launcher draws them:
    ``two_tower`` and ``bst`` take uniform ids from
    ``np.random.default_rng(0)`` (a stream that starts later draws and
    discards the batches before it), the field models a ``CTRStream``
    of (``sparse_ids``, ``label``)."""
    from repro_torch.data.synthetic import CTRStream

    def ids(rng, high, shape):
        return torch.from_numpy(rng.integers(0, high, shape).astype(np.int32))

    if cfg.model == "two_tower":
        logq = float(np.log(1.0 / cfg.n_items))

        def draw(rng):
            return {"user_ids": ids(rng, cfg.n_users, batch),
                    "item_ids": ids(rng, cfg.n_items, batch),
                    "item_logq": torch.full((batch,), logq,
                                            dtype=torch.float32)}
    elif cfg.model == "bst":
        def draw(rng):
            return {"hist_ids": ids(rng, cfg.n_items, (batch, cfg.seq_len)),
                    "target_id": ids(rng, cfg.n_items, batch),
                    "label": torch.from_numpy(
                        (rng.random(batch) < 0.3).astype(np.float32))}
    else:
        for b in CTRStream(cfg.field_vocab_sizes, batch, start=start):
            yield {"sparse_ids": torch.from_numpy(b["sparse_ids"]),
                   "label": torch.from_numpy(b["label"])}
        return
    # ``integers`` may take more than one draw per id, so the batches
    # before ``start`` are drawn, not skipped
    rng = np.random.default_rng(0)
    for _ in range(start):
        draw(rng)
    while True:
        yield draw(rng)


# every recsys arch's optimizer, as the JAX launcher's
RECSYS_OPTIMIZER = opt_lib.OptimizerConfig(kind="adagrad", lr=1e-2)


def recsys_setup(cfg, batch: int, device="cuda", start: int = 0):
    """(model, state, step_fn, data) of a recsys model: params drawn
    from a generator seeded 0 on ``device``, ``RECSYS_OPTIMIZER``
    (adagrad at lr 1e-2, global-norm clip 1.0), and
    :func:`recsys_stream` from batch ``start`` on (``fit`` moves each
    batch to the params' device)."""
    from repro_torch.launch.cells import recsys_model
    device = resolve_device(device)
    model = recsys_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    state = TrainState.create(RECSYS_OPTIMIZER, params)
    step = opt_lib.make_step_fn(RECSYS_OPTIMIZER, model.loss)
    return model, state, step, recsys_stream(cfg, batch, start)


def lm_stream(cfg, batch: int, seq: int, start: int = 0):
    """An endless stream of LM batches as CPU tensors, from batch
    ``start`` on, drawn as the JAX launcher draws them: each row
    ``seq + 1`` uniform tokens from ``np.random.default_rng(0)``, the
    first ``seq`` the ``tokens``, the last ``seq`` the ``labels`` (the
    batches before ``start`` are drawn and discarded)."""
    rng = np.random.default_rng(0)

    def draw():
        toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1))
        return {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
                "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}

    for _ in range(start):
        draw()
    while True:
        yield draw()


# every LM arch's optimizer, as the JAX launcher's
LM_OPTIMIZER = opt_lib.OptimizerConfig(kind="adamw", lr=3e-4,
                                       schedule="linear_warmup_cosine",
                                       warmup_steps=20, total_steps=1000)


def lm_step_fn(cfg):
    """The LM training step: ``models/lm.py::loss_fn`` under
    ``LM_OPTIMIZER``."""
    from repro_torch.models import lm
    return opt_lib.make_step_fn(LM_OPTIMIZER,
                                functools.partial(lm.loss_fn, cfg=cfg))


def lm_setup(cfg, batch: int, seq: int, device="cuda", start: int = 0):
    """(state, step_fn, data) of an LM: params from ``lm.model_init``
    with a generator seeded 0 on ``device``, ``LM_OPTIMIZER`` (adamw at
    lr 3e-4 under ``linear_warmup_cosine``, 20 warmup steps of 1,000),
    and :func:`lm_stream` from batch ``start`` on."""
    from repro_torch.models import lm
    device = resolve_device(device)
    params = lm.model_init(torch.Generator(device=device).manual_seed(0),
                           cfg)
    state = TrainState.create(LM_OPTIMIZER, params)
    return state, lm_step_fn(cfg), lm_stream(cfg, batch, seq, start)


def gnn_stream(cfg, batch: int, start: int = 0):
    """An endless stream of ``molecule_batch`` graphs (numpy arrays and
    the Python int ``n_graphs``), from batch ``start`` on, drawn as the
    JAX launcher draws them: ``min(batch, 32)`` molecules of 12 atoms
    and 24 edges over ``cfg.num_species`` species, batch ``s`` from
    seed ``s`` (so a stream that starts later skips nothing it must
    draw)."""
    from repro_torch.data.graph import molecule_batch
    seed = start
    while True:
        yield molecule_batch(n_graphs=min(batch, 32), n_atoms=12,
                             n_edges=24, n_species=cfg.num_species,
                             seed=seed)
        seed += 1


# MACE's optimizer, as the JAX launcher's
GNN_OPTIMIZER = opt_lib.OptimizerConfig(kind="adam", lr=1e-3)


def gnn_setup(cfg, batch: int, device="cuda", start: int = 0):
    """(model, state, step_fn, data) of MACE: params drawn from a
    generator seeded 0 on ``device``, ``GNN_OPTIMIZER`` (adam at lr
    1e-3, global-norm clip 1.0) over ``MACE.energy_loss``, and
    :func:`gnn_stream` from batch ``start`` on (``fit`` moves each
    batch to the params' device)."""
    from repro_torch.models.gnn.mace import MACE
    device = resolve_device(device)
    model = MACE(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    state = TrainState.create(GNN_OPTIMIZER, params)
    step = opt_lib.make_step_fn(GNN_OPTIMIZER, model.energy_loss)
    return model, state, step, gnn_stream(cfg, batch, start)


def gnn_stream_shape(batch: int):
    """The ``ShapeSpec`` of :func:`gnn_stream`'s batches (``molecule``'s
    kind at ``min(batch, 32)`` molecules of 12 atoms and 24 edges), the
    shape ``mace_cell`` places them by."""
    from repro_torch.configs.base import ShapeSpec
    return ShapeSpec("molecule_stream", "graph_batched", n_nodes=12,
                     n_edges=24, batch_graphs=min(batch, 32))


@dataclasses.dataclass
class TrainRun:
    """What :func:`train` built and measured."""

    cfg: Any                        # the arch's config, overrides applied
    model: Any                      # the recsys or GNN model; None for an LM
    state: TrainState
    history: List[Dict]             # one entry per logged step
    seconds: float                  # wall time of ``fit``


def train(arch: str, *, smoke: bool = True, steps: int = 100,
          batch: int = 32, seq: int = 64, ckpt_dir: str = "",
          ckpt_every: int = 0, fail_at: int = 0, log_every: int = 10,
          device="cuda", overrides: Optional[Dict[str, Any]] = None,
          mesh=None, microbatches: int = 1) -> TrainRun:
    """Train ``arch`` for ``steps`` steps (resuming from ``ckpt_dir``
    when it holds a committed checkpoint); ``fail_at`` > 0 raises
    ``SimulatedFailure`` after that step, as a crashed host would.
    ``seq`` is an LM's tokens a row; ``overrides`` replaces fields of
    the arch's config (a depth cut, the attention route).

    A resumed run's stream starts at the newest committed step's batch,
    so it trains on the batches an uninterrupted run would have.  (Were
    that checkpoint to fail validation, ``fit`` would fall back to an
    older one and the stream would run ahead of it by the steps
    between.)

    With a ``mesh`` this rank trains its share, ``device`` is the
    mesh's, and the returned state is this rank's; an LM accumulates
    ``microbatches`` microbatches a step there."""
    family, cfg = get_arch(arch, smoke=smoke)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if microbatches != 1 and (mesh is None or family != "lm"):
        raise ValueError("microbatches are the LM train cell's: they take "
                         "an LM arch on a mesh")
    start = (ckpt_lib.latest_step(ckpt_dir) if ckpt_dir else None) or 0
    specs = None
    if mesh is not None and family == "lm":
        from repro_torch.launch.cells import lm_train_cell
        cell = lm_train_cell(cfg, mesh, microbatches,
                             optimizer=LM_OPTIMIZER)
        model, state, step, specs = None, cell.state, cell.step, cell.specs
        data = map(cell.local_batch, lm_stream(cfg, batch, seq, start))
    elif mesh is not None and family == "gnn":
        from repro_torch.launch.cells import mace_cell
        cell = mace_cell(cfg, gnn_stream_shape(batch), mesh)
        model, state, step, specs = cell.model, cell.state, cell.step, \
            cell.specs
        data = map(cell.local_graph, gnn_stream(cfg, batch, start))
    elif mesh is not None:
        from repro_torch.launch.cells import recsys_train_cell
        cell = recsys_train_cell(cfg, mesh)
        model, state, step, specs = cell.model, cell.state, cell.step, \
            cell.specs
        data = map(cell.local_batch, recsys_stream(cfg, batch, start))
    elif family == "lm":
        model = None
        state, step, data = lm_setup(cfg, batch, seq, device=device,
                                     start=start)
    elif family == "gnn":
        model, state, step, data = gnn_setup(cfg, batch, device=device,
                                             start=start)
    else:
        model, state, step, data = recsys_setup(cfg, batch, device=device,
                                                start=start)
    injector = FailureInjector(fail_at_steps=[fail_at]) if fail_at else None
    lcfg = LoopConfig(total_steps=steps, log_every=log_every,
                      ckpt_every=ckpt_every, ckpt_dir=ckpt_dir,
                      metrics_hook=lambda s, m: print(
                          f"step {s}: " + " ".join(
                              f"{k}={v:.6f}" for k, v in m.items()
                              if k != "step"), flush=True))
    t0 = time.perf_counter()
    state, hist = fit(state, step, data, lcfg, injector=injector, mesh=mesh,
                      specs=specs)
    seconds = time.perf_counter() - t0
    if hist:
        device = tree_leaves(state.params)[0].device
        where = "" if mesh is None else f" (a rank of mesh {mesh.shape})"
        print(f"done: {steps} steps in {seconds:.1f}s on {device}{where}; "
              f"final loss {hist[-1]['loss']:.4f}")
    return TrainRun(cfg, model, state, hist, seconds)


def main(argv: Optional[List[str]] = None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=64,
                    help="an LM's tokens a row")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=0,
                    help="inject a crash at this step (tests restart)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card, "
                         "under --mesh cuda:<LOCAL_RANK>; 'cpu' runs the "
                         "plain PyTorch ops)")
    ap.add_argument("--mesh", default=None, metavar="data=2,model=2",
                    help="train on this mesh (tables, layers and MACE's "
                         "channels over 'model', the batch or the graph's "
                         "nodes over the rest), one process a rank under "
                         "torchrun")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="an LM's microbatches a step on a mesh (the "
                         "gradients accumulated, one update)")
    ap.add_argument("--opts", default="",
                    help="comma-separated LM options of the JAX package's "
                         "_LM_CFG_OPTS (launch/cells.py::LM_CFG_OPTS)")
    ap.add_argument("--dist-backend", default="nccl", choices=BACKENDS,
                    help="--mesh's process-group backend: nccl (one rank "
                         "per card) or gloo (ranks that share a card, or "
                         "CPU ranks)")
    args = ap.parse_args(argv)
    if args.arch not in ARCHS:
        ap.error(f"unknown arch {args.arch!r}; archs: {sorted(ARCHS)}")
    family, cfg = get_arch(args.arch, smoke=args.smoke)
    overrides = None
    if args.opts:
        from repro_torch.launch.cells import lm_cfg_with_opts
        if family != "lm":
            ap.error(f"--opts are LM options; {args.arch} is {family}")
        try:
            new = lm_cfg_with_opts(cfg, args.opts.split(","))
        except ValueError as e:
            ap.error(str(e))
        overrides = {f.name: getattr(new, f.name)
                     for f in dataclasses.fields(new)
                     if getattr(new, f.name) != getattr(cfg, f.name)}

    def run(mesh=None):
        return train(args.arch, smoke=args.smoke, steps=args.steps,
                     batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, fail_at=args.fail_at,
                     log_every=args.log_every, device=args.device,
                     overrides=overrides, mesh=mesh,
                     microbatches=args.microbatches)

    if not args.mesh:
        return run()
    try:
        axes, shape = mesh_of_spec(args.mesh, "-m repro_torch.launch.train",
                                   "tables, layers and channels")
    except ValueError as e:
        ap.error(str(e))
    device = None if args.device == "cuda" else args.device
    return run_on_mesh(axes, shape, args.dist_backend, device, run)


if __name__ == "__main__":
    main()
