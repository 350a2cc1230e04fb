"""The paper-reproduction runs of the three backbones (GMF, NeuMF,
SASRec), trained on the card: the twin of the JAX package's
``benchmarks/common.py``, ``benchmarks/convergence.py`` (Fig. 3) and
``benchmarks/compression_curves.py`` (Fig. 2).

    PYTHONPATH=src python -m repro_torch.launch.backbones convergence [--full]
    PYTHONPATH=src python -m repro_torch.launch.backbones curves [--full]

Trains a backbone with a chosen embedding scheme on the ML-1M-like
synthetic set (personalized + sequential tasks) or an AAR-like
relevance set (item-to-item task), and evaluates HR@10 / RMSE exactly
as the paper does (§3.5): for HR@10, rank the withheld test item
against 100 sampled negatives per user.  Runs on the card unless
``--device cpu`` is given; the samplers draw the JAX package's batches
from the same seeds, and the evaluation the same candidates.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.sampler import PointwiseSampler, SequenceSampler
from repro_torch.data.synthetic import InteractionData, aar_like, movielens_like
from repro_torch.models.recsys.backbones import (GMF, BackboneConfig, SASRec,
                                                 make_backbone)
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.optimizer import TrainState

# Fig. 3's claim: MGQE's final training loss within this relative gap of
# the full embedding's
TRACK_GAP = 0.25


@dataclasses.dataclass
class RunResult:
    scheme: str
    metric: float            # HR@10 (higher better) or RMSE (lower better)
    size_bits: int
    size_pct: float          # % of full-embedding size
    losses: List[float]
    seconds: float
    step_ms: float           # training step, host clock over the steps
    model: object = None     # the model and its trained params, for
    params: Optional[Dict] = None    # export and serving


# ----------------------------------------------------------------------
# evaluation (paper §3.5: HR@10 vs 100 sampled negatives)
# ----------------------------------------------------------------------

def eval_candidates(data: InteractionData, n_users_eval: int = 500,
                    n_neg: int = 100, seed: int = 7, shift: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(users (U,), candidates (U, 1 + n_neg)): the evaluated users and,
    per user, the withheld test item then ``n_neg`` sampled items, ids
    shifted by ``shift`` (SASRec's 0 = pad), in the JAX package's
    draws."""
    rng = np.random.default_rng(seed)
    users = rng.choice(data.n_users, min(n_users_eval, data.n_users),
                       replace=False)
    cand = np.concatenate(
        [data.test_item[users][:, None] + shift,
         rng.integers(shift, data.n_items + shift, (len(users), n_neg))],
        axis=1)
    return users, cand


def _hr_at_10(scores: np.ndarray) -> float:
    """Ties count against the model (``>=``)."""
    rank = (scores[:, 1:] >= scores[:, :1]).sum(axis=1)
    return float((rank < 10).mean())


def hr_at_10_pointwise(model, params, data: InteractionData,
                       n_users_eval: int = 500, n_neg: int = 100,
                       seed: int = 7, artifacts: Optional[Dict] = None
                       ) -> float:
    """HR@10 of GMF or NeuMF; with ``artifacts`` (``model.export``),
    scored from the served rows."""
    users, cand = eval_candidates(data, n_users_eval, n_neg, seed)
    u_rep = np.repeat(users, n_neg + 1)
    dev = model.device
    with torch.no_grad():
        scores, _ = model.score(params, torch.from_numpy(u_rep).to(dev),
                                torch.from_numpy(cand.reshape(-1)).to(dev),
                                artifacts)
    return _hr_at_10(scores.cpu().numpy().reshape(len(users), n_neg + 1))


def hr_at_10_sasrec(model: SASRec, params, data: InteractionData,
                    maxlen: int, n_users_eval: int = 500,
                    n_neg: int = 100, seed: int = 7,
                    artifacts: Optional[Dict] = None) -> float:
    """HR@10 of SASRec from the last position's hidden state; with
    ``artifacts``, from the served rows throughout."""
    users, cand = eval_candidates(data, n_users_eval, n_neg, seed, shift=1)
    seqs = np.zeros((len(users), maxlen), np.int64)
    for i, u in enumerate(users):
        s = data.train_seqs[u][-maxlen:] + 1          # shift: 0 = pad
        seqs[i, maxlen - len(s):] = s
    dev = model.device
    with torch.no_grad():
        hidden, _ = model.trunk(params, torch.from_numpy(seqs).to(dev),
                                artifacts)
        scores = model.score_items(params, hidden[:, -1:],
                                   torch.from_numpy(cand).to(dev), artifacts)
    return _hr_at_10(scores.cpu().numpy())


# ----------------------------------------------------------------------
# training runs
# ----------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit(model, params, loss_fn, data_iter, steps: int, lr: float,
        log_every: int = 0) -> Tuple[TrainState, List[float]]:
    """Adam without clipping over ``steps`` numpy batches, each moved to
    the model's device; the logged losses (``bce``, else ``loss``) at
    every ``log_every``-th step and the last."""
    ocfg = opt_lib.OptimizerConfig(kind="adam", lr=lr, grad_clip=None)
    state = TrainState.create(ocfg, params)
    step = opt_lib.make_step_fn(ocfg, loss_fn)
    losses = []
    for i in range(steps):
        batch = next(data_iter)
        batch = {k: torch.from_numpy(v).to(model.device)
                 for k, v in batch.items()}
        state, metrics = step(state, batch)
        if log_every and (i % log_every == 0 or i == steps - 1):
            losses.append(float(metrics["bce" if "bce" in metrics
                                        else "loss"]))
    return state, losses


def _timed_fit(model, params, loss_fn, data_iter, steps, lr):
    """``fit`` logging 40 times, and its milliseconds a step (the host
    clock around the steps, ending in a synchronise)."""
    _sync(model.device)
    t0 = time.perf_counter()
    state, losses = fit(model, params, loss_fn, data_iter, steps, lr,
                        log_every=max(steps // 40, 1))
    _sync(model.device)
    return state, losses, (time.perf_counter() - t0) * 1e3 / max(steps, 1)


def run_pointwise(model_name: str, scheme_cfg: BackboneConfig,
                  data: InteractionData, steps: int = 400,
                  lr: float = 2e-3, eval_users: int = 500,
                  device="cuda") -> RunResult:
    """Task 1 (personalized): GMF / NeuMF on ML-like implicit feedback."""
    t0 = time.time()
    model = make_backbone(scheme_cfg, device=device)
    params = model.init()
    sampler = iter(PointwiseSampler(data, batch_pos=512, n_neg=4))
    state, losses, step_ms = _timed_fit(model, params, model.loss, sampler,
                                        steps, lr)
    hr = hr_at_10_pointwise(model, state.params, data,
                            n_users_eval=eval_users)
    full_bits = 32 * scheme_cfg.dim * (
        scheme_cfg.n_users + scheme_cfg.n_items) * (
        2 if model_name == "neumf" else 1)
    bits = model.serving_size_bits()
    return RunResult(scheme_cfg.embed_kind, hr, bits,
                     100.0 * bits / full_bits, losses, time.time() - t0,
                     step_ms, model, state.params)


def run_sasrec(scheme_cfg: BackboneConfig, data: InteractionData,
               steps: int = 400, lr: float = 1e-3,
               eval_users: int = 500, device="cuda") -> RunResult:
    """Task 2 (sequential): SASRec next-item prediction."""
    t0 = time.time()
    model = SASRec(scheme_cfg, device=device)
    params = model.init()
    sampler = iter(SequenceSampler(data, batch=128,
                                   maxlen=scheme_cfg.maxlen))
    state, losses, step_ms = _timed_fit(model, params, model.loss, sampler,
                                        steps, lr)
    hr = hr_at_10_sasrec(model, state.params, data, scheme_cfg.maxlen,
                         n_users_eval=eval_users)
    full_bits = 32 * scheme_cfg.dim * (scheme_cfg.n_items + 1)
    bits = model.serving_size_bits()
    return RunResult(scheme_cfg.embed_kind, hr, bits,
                     100.0 * bits / full_bits, losses, time.time() - t0,
                     step_ms, model, state.params)


def run_item2item(scheme_cfg: BackboneConfig, aar: Dict,
                  steps: int = 400, lr: float = 2e-3,
                  device="cuda") -> RunResult:
    """Task 3 (item-to-item): GMF-style regressor on relevance scores.
    Reports RMSE (lower better), scores normalized to [-1, 1]."""
    t0 = time.time()
    model = GMF(scheme_cfg, device=device)
    params = model.init()
    rng = np.random.default_rng(0)
    n = len(aar["train_a"])

    def data_iter():
        while True:
            idx = rng.integers(0, n, 1024)
            yield {"user_ids": aar["train_a"][idx],
                   "item_ids": aar["train_b"][idx],
                   "label": aar["train_y"][idx] / 100.0}

    state, losses, step_ms = _timed_fit(model, params, model.mse_loss,
                                        data_iter(), steps, lr)
    dev = model.device
    with torch.no_grad():
        pred, _ = model.score(state.params,
                              torch.from_numpy(aar["eval_a"]).to(dev),
                              torch.from_numpy(aar["eval_b"]).to(dev))
    rmse = float(np.sqrt(np.mean(
        (pred.cpu().numpy() - aar["eval_y"] / 100.0) ** 2))) * 100.0
    full_bits = 32 * scheme_cfg.dim * (scheme_cfg.n_users
                                       + scheme_cfg.n_items)
    bits = model.serving_size_bits()
    return RunResult(scheme_cfg.embed_kind, rmse, bits,
                     100.0 * bits / full_bits, losses, time.time() - t0,
                     step_ms, model, state.params)


# ----------------------------------------------------------------------
# scheme sweeps (paper Fig. 2 x-axis: model size)
# ----------------------------------------------------------------------

def scheme_grid(n_users: int, n_items: int, model: str = "gmf",
                dim: int = 64) -> Dict[str, List[BackboneConfig]]:
    """Configs per scheme, swept the way the paper sweeps sizes:
    FE -> dimension, SQ -> bits, LRF -> rank, DPQ/MGQE -> subspaces D."""
    base = dict(model=model, n_users=n_users, n_items=n_items, dim=dim)
    grid = {
        "full": [BackboneConfig(embed_kind="full", **dict(base, dim=d))
                 for d in (64, 16, 8, 4)],
        "sq": [BackboneConfig(embed_kind="sq", sq_bits=b, **base)
               for b in (8, 4)],
        "lrf": [BackboneConfig(embed_kind="lrf", lrf_rank=r, **base)
                for r in (16, 8, 4)],
        "dpq": [BackboneConfig(embed_kind="dpq", num_subspaces=D, **base)
                for D in (16, 8, 4)],
        "mgqe": [BackboneConfig(embed_kind="mgqe", num_subspaces=D, **base)
                 for D in (16, 8, 4)],
    }
    return grid


# ----------------------------------------------------------------------
# the two reproductions (Fig. 3 and Fig. 2)
# ----------------------------------------------------------------------

def rel_gap(fe: float, mg: float) -> Tuple[float, str]:
    """Fig. 3's verdict on two final losses: the relative gap, and
    TRACKS below TRACK_GAP, else DIVERGES."""
    gap = abs(mg - fe) / max(abs(fe), 1e-9)
    return gap, "TRACKS" if gap < TRACK_GAP else "DIVERGES"


def convergence(quick: bool = True, out_json: str = "", device="cuda"):
    """Paper Fig. 3: training-loss trajectories of MGQE vs full
    embeddings on the backbone models — MGQE must track FE closely (same
    default hyper-parameters, no retuning)."""
    n_users, n_items = (1200, 800) if quick else (6040, 3416)
    steps = 200 if quick else 2000
    ml = movielens_like(n_users=n_users, n_items=n_items, seed=0)
    print("== Fig.3 reproduction: convergence MGQE vs FE ==")
    curves = {}
    for model in ("gmf", "neumf", "sasrec"):
        for kind in ("full", "mgqe"):
            cfg = BackboneConfig(model=model, n_users=n_users,
                                 n_items=n_items, dim=64, embed_kind=kind)
            if model == "sasrec":
                r = run_sasrec(cfg, ml, steps=steps, eval_users=100,
                               device=device)
            else:
                r = run_pointwise(model, cfg, ml, steps=steps,
                                  eval_users=100, device=device)
            curves[f"{model}/{kind}"] = r.losses
            print(f"  {model:6s}/{kind:4s}: loss "
                  f"{r.losses[0]:.3f} -> {r.losses[-1]:.3f}, HR@10 "
                  f"{r.metric:.3f}, size {r.size_pct:.2f}% "
                  f"({r.seconds:.0f}s, {r.step_ms:.3f} ms a step)")
    # the Fig.3 claim: final losses within a small gap
    for model in ("gmf", "neumf", "sasrec"):
        fe = curves[f"{model}/full"][-1]
        mg = curves[f"{model}/mgqe"][-1]
        gap, verdict = rel_gap(fe, mg)
        print(f"  {model}: final FE={fe:.3f} MGQE={mg:.3f} "
              f"rel-gap={gap:.1%} -> {verdict}")
    if out_json:
        with open(out_json, "w") as f:
            json.dump(curves, f, indent=1)
    return curves


def compression_curves(quick: bool = True, out_json: str = "",
                       device="cuda"):
    """Paper Fig. 2: recommendation quality vs serving model size, per
    compression scheme, on the three tasks.

    Quick mode (default): GMF + SASRec on a reduced ML-like set and
    GMF-regression on a reduced AAR-like set, fewer steps, one seed.
    Full mode approaches the paper protocol (6040x3416)."""
    if quick:
        n_users, n_items, steps, eval_users = 1200, 800, 250, 300
        aar_apps, aar_pairs, sas_steps = 2000, 60_000, 120
        sas_schemes = ("full", "dpq", "mgqe")
        i2i_schemes = ("full", "sq", "lrf", "dpq", "mgqe")
    else:
        n_users, n_items, steps, eval_users = 6040, 3416, 2000, 2000
        aar_apps, aar_pairs, sas_steps = 20_000, 400_000, 1500
        sas_schemes = i2i_schemes = ("full", "sq", "lrf", "dpq", "mgqe")

    print("== Fig.2 reproduction: quality vs serving size ==")
    print(f"(quick={quick}: ML-like {n_users}x{n_items}, "
          f"AAR-like {aar_apps} apps)")
    ml = movielens_like(n_users=n_users, n_items=n_items, seed=0)
    aar = aar_like(n_apps=aar_apps, n_pairs=aar_pairs, seed=1)
    rows = []

    # ---- Task 1: personalized (GMF) --------------------------------
    print("\n-- Task 1: GMF on ML-like (HR@10 up, size% down) --")
    grid = scheme_grid(n_users, n_items, "gmf")
    for scheme, cfgs in grid.items():
        for cfg in cfgs[:2] if quick else cfgs:
            r = run_pointwise("gmf", cfg, ml, steps=steps,
                              eval_users=eval_users, device=device)
            tag = {"full": f"d={cfg.dim}", "sq": f"b={cfg.sq_bits}",
                   "lrf": f"r={cfg.lrf_rank}"}.get(
                scheme, f"D={cfg.num_subspaces}")
            print(f"  {scheme:5s} {tag:6s}: HR@10={r.metric:.3f} "
                  f"size={r.size_pct:5.1f}%  ({r.seconds:.0f}s)")
            rows.append({"task": "gmf-ml", "scheme": scheme, "tag": tag,
                         "metric": r.metric, "size_pct": r.size_pct})

    # ---- Task 2: sequential (SASRec) --------------------------------
    print("\n-- Task 2: SASRec on ML-like (HR@10) --")
    for scheme, cfgs in scheme_grid(n_users, n_items, "sasrec").items():
        if scheme not in sas_schemes:
            continue
        cfg = cfgs[1] if len(cfgs) > 1 else cfgs[0]
        r = run_sasrec(cfg, ml, steps=sas_steps, eval_users=eval_users,
                       device=device)
        print(f"  {scheme:5s}: HR@10={r.metric:.3f} "
              f"size={r.size_pct:5.1f}%  ({r.seconds:.0f}s)")
        rows.append({"task": "sasrec-ml", "scheme": scheme,
                     "metric": r.metric, "size_pct": r.size_pct})

    # ---- Task 3: item-to-item (AAR-like, RMSE) -----------------------
    print("\n-- Task 3: GMF-regressor on AAR-like (RMSE down) --")
    for scheme, cfgs in scheme_grid(aar["n_apps"], aar["n_apps"],
                                    "gmf").items():
        if scheme not in i2i_schemes:
            continue
        cfg = cfgs[1] if len(cfgs) > 1 else cfgs[0]
        r = run_item2item(cfg, aar, steps=steps, device=device)
        print(f"  {scheme:5s}: RMSE={r.metric:.2f} "
              f"size={r.size_pct:5.1f}%  ({r.seconds:.0f}s)")
        rows.append({"task": "gmf-aar", "scheme": scheme,
                     "metric": r.metric, "size_pct": r.size_pct})

    if out_json:
        with open(out_json, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"\nwrote {len(rows)} rows -> {out_json}")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("figure", choices=("convergence", "curves"),
                    help="Fig. 3 (loss trajectories, FE vs MGQE) or "
                         "Fig. 2 (quality vs serving size per scheme)")
    ap.add_argument("--full", action="store_true",
                    help="the paper's sizes (6040x3416) and step counts")
    ap.add_argument("--json", default="", help="write the results here")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run = convergence if a.figure == "convergence" else compression_curves
    run(quick=not a.full, out_json=a.json, device=a.device)


if __name__ == "__main__":
    main()
