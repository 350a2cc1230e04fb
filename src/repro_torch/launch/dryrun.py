"""Dry run: build every (arch x shape) cell on the production meshes on
the meta device and count one rank's step against the roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--json out.json]

Each cell is built by ``launch/cells.py::build_cell`` on an
``AbstractMesh`` (``launch/mesh.py``) that stands for rank 0 of (16, 16)
or, with ``--multi-pod``, (2, 16, 16): its params, optimizer state,
exports and batches are meta tensors of that rank's shapes, so nothing
is drawn or allocated.  One step is then traced on the meta device
(``roofline/model.py::CostCounter``): its FLOPs by dtype, its bytes, a
peak from the storages alive, and its collectives (the mesh's
``CommStats``, by kind and by axis), each turned into seconds on H100
constants.  The numbers are analytic: no card runs them.  A row mirrors
the JAX package's ``launch/dryrun.py`` with ``trace_s`` in place of its
``compile_s`` and no XLA-only field.  Exit 1 on any failure.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Dict

import torch

from repro_torch.configs.registry import ARCHS, SHAPE_SKIPS, shapes_for
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import abstract_production_mesh
from repro_torch.roofline import CostCounter, terms


def tree_bytes(tree) -> int:
    """Bytes of every tensor of ``tree`` (dicts, lists, tuples, a
    ``TrainState``); a python int counts as an int32 scalar, as the JAX
    cells hold a cache's position."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, bool):
        return 0
    if isinstance(tree, int):
        return 4
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if hasattr(tree, "params") and hasattr(tree, "opt_state"):
        return tree_bytes(tree.params) + tree_bytes(tree.opt_state)
    return 0


def trace_step(cell, mesh) -> Dict:
    """One step of ``cell`` traced: the counter, the mesh's collectives
    and the output, with the seconds the trace took."""
    from repro_torch.kernels.dispatch import counting
    from repro_torch.sharding.collectives import CommStats
    mesh.stats = CommStats()
    counter = CostCounter()
    t0 = time.time()
    try:
        with counting(counter), counter:
            out = cell.fn(*cell.args)
    finally:
        stats, mesh.stats = mesh.stats, None
    return {"counter": counter, "comm": stats, "out": out,
            "trace_s": time.time() - t0}


def run_cell(arch: str, shape, mesh, multi_pod: bool, verbose: bool = True,
             opts=()) -> dict:
    t0 = time.time()
    cell = build_cell(arch, shape, mesh, multi_pod, opts=tuple(opts))
    traced = trace_step(cell, mesh)
    counter, comm = traced["counter"], traced["comm"]
    args_b = tree_bytes(cell.args)
    out_b = tree_bytes(traced["out"])
    t = terms(counter.flops, counter.bytes, comm.axis_bytes, mesh.shape,
              cell.model_flops)
    row = {
        "arch": arch, "shape": shape.name,
        "mesh": "x".join(str(s) for s in mesh.shape.values()),
        "note": cell.note, "opts": ",".join(opts),
        "trace_s": round(time.time() - t0, 1),
        # memory (a rank's)
        "args_gb": args_b / 1e9, "out_gb": out_b / 1e9,
        "temp_gb": counter.peak / 1e9,
        "peak_gb": (args_b + counter.peak) / 1e9,
        # roofline terms (a rank's step)
        "flops": t.hlo_flops, "flops_by_dtype": dict(counter.flops),
        "bytes": t.hlo_bytes, "coll_bytes": t.collective_bytes,
        "coll_kinds": dict(comm.kind_bytes), "coll_counts": dict(comm.kinds),
        "coll_axis_bytes": dict(comm.axis_bytes),
        "kernel_ops": dict(counter.ops),
        "compute_ms": t.compute_s * 1e3, "memory_ms": t.memory_s * 1e3,
        "collective_ms": t.collective_s * 1e3, "dominant": t.dominant,
        "model_flops": cell.model_flops,
        "useful_frac": t.useful_fraction,
        "roofline_frac": t.roofline_fraction,
    }
    if verbose:
        uf, rf = row["useful_frac"], row["roofline_frac"]
        print(f"[{arch} x {shape.name}] {cell.note}")
        print(f"  trace {row['trace_s']}s | per-rank args "
              f"{row['args_gb']:.3f} GB, temps {row['temp_gb']:.2f} GB, "
              f"peak {row['peak_gb']:.2f} GB")
        print(f"  terms ms: compute {row['compute_ms']:.3f} | memory "
              f"{row['memory_ms']:.3f} | collective "
              f"{row['collective_ms']:.3f}  -> {row['dominant']}-bound")
        print(f"  collectives: {row['coll_counts']} "
              f"({row['coll_bytes'] / 1e6:.3f} MB a rank); kernel ops "
              f"{row['kernel_ops']}")
        print(f"  useful_frac {uf if uf is None else round(uf, 3)} | "
              f"roofline_frac {rf if rf is None else round(rf, 3)}")
        sys.stdout.flush()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--json", default=None, help="append rows to this file")
    ap.add_argument("--opt", default="",
                    help="comma-separated named options, e.g. "
                         "moe_shard_map,remat_group,microbatch2")
    args = ap.parse_args(argv)
    opts = tuple(o for o in args.opt.split(",") if o)

    if args.both_meshes:
        meshes = [(abstract_production_mesh(multi_pod=False), False),
                  (abstract_production_mesh(multi_pod=True), True)]
    else:
        meshes = [(abstract_production_mesh(multi_pod=args.multi_pod),
                   args.multi_pod)]

    cells = []
    if args.all:
        archs = list(ARCHS)
    elif args.arch:
        archs = [args.arch]
    else:
        raise SystemExit("--arch or --all required")
    for arch in archs:
        for shape in shapes_for(arch):
            if args.shape and shape.name != args.shape:
                continue
            skip = SHAPE_SKIPS.get((arch, shape.name))
            if skip:
                print(f"[{arch} x {shape.name}] SKIPPED: {skip}")
                continue
            cells.append((arch, shape))

    rows, failures = [], []
    for mesh, multi_pod in meshes:
        print(f"=== mesh {tuple(mesh.shape.values())} "
              f"({'multi-pod' if multi_pod else 'single-pod'}) ===")
        for arch, shape in cells:
            try:
                rows.append(run_cell(arch, shape, mesh, multi_pod,
                                     opts=opts))
            except Exception:
                failures.append((arch, shape.name, multi_pod))
                print(f"[{arch} x {shape.name}] FAILED")
                traceback.print_exc()
                sys.stdout.flush()

    if args.json:
        existing = []
        if os.path.exists(args.json):
            with open(args.json) as f:
                existing = json.load(f)
        with open(args.json, "w") as f:
            json.dump(existing + rows, f, indent=1, default=str)
        print(f"wrote {len(rows)} rows -> {args.json}")

    print(f"\n{len(rows)} cells OK, {len(failures)} failed")
    for f_ in failures:
        print("  FAILED:", f_)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
