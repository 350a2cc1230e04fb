"""The training loop: eager steps, periodic checkpointing, auto-resume,
straggler monitoring, failure injection (for tests), metric logging.

PyTorch runs eagerly, so there is no jit and nothing to donate: the
step updates the state in place (``train/optimizer.py``).  Each batch
moves to the params' device before its step.  On the card the step
timer waits for the device before it stops, so a step's time is the
device's and not the time to queue it.

As in the JAX package, ``fit`` feeds the next batch of ``data_iter`` to
every step, a resumed run's first step included: a caller that wants a
resumed run to see the batches an uninterrupted one would have hands
``fit`` a stream positioned at the checkpoint's step
(``launch/train.py`` does).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.schemes.base import tree_leaves
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import TrainState
from repro_torch.train.resilience import (FailureInjector, StepTimer,
                                          StragglerDetector)


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    log_every: int = 50
    ckpt_every: int = 0           # 0 = no checkpointing
    ckpt_dir: str = ""
    ckpt_keep: int = 3
    metrics_hook: Optional[Callable[[int, Dict], None]] = None


def on_device(batch: Dict, device) -> Dict:
    """The batch's arrays as tensors on ``device``; a Python number (a
    graph batch's ``n_graphs``) stays one, so reading it needs no sync."""
    return {k: v if isinstance(v, (int, float)) else
            (v if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


def fit(state: TrainState,
        step_fn: Callable,
        data_iter: Iterator,
        cfg: LoopConfig,
        injector: Optional[FailureInjector] = None,
        resume: bool = True, mesh=None,
        specs: Optional[TrainState] = None
        ) -> Tuple[TrainState, List[Dict]]:
    """Runs ``step_fn`` to ``total_steps``; resumes from the newest
    committed checkpoint in ``ckpt_dir`` when present.

    Under a ``mesh`` every rank runs it on its own ``state`` (placed by
    ``specs``, a :class:`TrainState` of spec trees) and its own batches:
    checkpoints hold the whole arrays (``checkpoint.save`` gathers
    them) and a resume places this rank's blocks through
    ``checkpoint.elastic_restore``, whatever mesh wrote them."""
    start_step = 0
    if resume and cfg.ckpt_dir:
        template = state
        if mesh is not None:
            from repro_torch.sharding.rules import whole_like
            template = TrainState(
                whole_like(state.params, specs.params, mesh),
                whole_like(state.opt_state, specs.opt_state, mesh))
        restored, step = ckpt_lib.restore_latest(
            cfg.ckpt_dir, template, spec_tree=specs, mesh=mesh)
        if restored is not None:
            state = restored
            start_step = step
    device = tree_leaves(state.params)[0].device
    history: List[Dict] = []
    timer = StepTimer()
    detector = StragglerDetector(num_hosts=1)

    for step in range(start_step, cfg.total_steps):
        batch = on_device(next(data_iter), device)
        timer.start()
        state, metrics = step_fn(state, batch)
        if device.type == "cuda":
            # the step's time on the device; and before the failure
            # point, so the checkpoint below is never torn mid-step
            torch.cuda.synchronize(device)
        if injector is not None:
            injector.maybe_fail(step)
        dt = timer.stop()
        detector.record(0, dt)

        if cfg.ckpt_every and cfg.ckpt_dir \
                and (step + 1) % cfg.ckpt_every == 0:
            ckpt_lib.save(cfg.ckpt_dir, step + 1, state, keep=cfg.ckpt_keep,
                          mesh=mesh, specs=specs)

        if (step + 1) % cfg.log_every == 0 or step == cfg.total_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step + 1
            m["step_time_s"] = dt
            history.append(m)
            if cfg.metrics_hook:
                cfg.metrics_hook(step + 1, m)
    return state, history
