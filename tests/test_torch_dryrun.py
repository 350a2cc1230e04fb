"""The port's dry run against the JAX package's, on the CPU.

``launch/cells.py::build_cell`` on an ``AbstractMesh`` (``launch/
mesh.py``), ``roofline/model.py`` and ``launch/dryrun.py``.  Bars:

* every one of the 38 runnable cells on (16, 16) and (2, 16, 16): the
  port's per-rank argument bytes (its params, optimizer state, exports,
  caches and batches as meta tensors of rank 0's shapes) equal to the
  per-device bytes of JAX's ``build_cell`` on
  ``jax.sharding.AbstractMesh`` (``NamedSharding.shard_shape`` times the
  itemsize), argument by argument, exactly; a planted wrong spec fails;
* at smoke configs on (2, 2): each rank's dry-run count of collectives,
  their kinds and bytes equal to what that rank of 4 gloo CPU ranks
  counts running the same cell; a planted extra collective fails;
* the counter: a matmul's FLOPs, each kernel op counted once at its own
  ``cost`` (none of its plain version's aten ops), remat's recompute
  visible in the FLOPs, the dominant term, the link of each axis;
* the CLI: ``--all`` prints the two skips and exits 0 (one mesh here,
  the arch filter keeping it short), an unknown option raises naming
  its family.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import all_cells
from repro_torch.launch.cells import build_cell
from repro_torch.launch.dryrun import trace_step, tree_bytes
from repro_torch.launch.mesh import AbstractMesh as TorchAbstractMesh
from repro_torch.launch.mesh import abstract_production_mesh, spawn
from repro_torch.roofline import model as roofline

# JAX and the JAX package are imported where JAX's cells are built: the
# ranks import this module for their body and need neither

TIMEOUT = 240.0
CELLS = [(arch, shape.name) for arch, shape, _ in all_cells()]


# ----------------------------------------------------------------------
# per-rank argument bytes against JAX's dry run
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_mesh(multi_pod):
    from jax.sharding import AbstractMesh
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _jax_arg_bytes(arch, shape_name, multi_pod, opts=()):
    """JAX's per-device bytes of each argument of its cell."""
    import jax
    from jax.sharding import NamedSharding
    from repro.configs.registry import all_cells as jax_all_cells
    from repro.launch import cells as jax_cells
    shape = next(s for a, s, _ in jax_all_cells()
                 if a == arch and s.name == shape_name)
    cell = jax_cells.build_cell(arch, shape, _jax_mesh(multi_pod), multi_pod,
                                opts=opts)
    out = []
    for arg, shard in zip(cell.args, cell.in_shardings):
        leaves = jax.tree.leaves(arg)
        shards = jax.tree.leaves(
            shard, is_leaf=lambda x: isinstance(x, NamedSharding))
        if len(shards) == 1:
            shards = shards * len(leaves)
        out.append(sum(int(np.prod(s.shard_shape(x.shape)))
                       * np.dtype(x.dtype).itemsize
                       for x, s in zip(leaves, shards, strict=True)))
    return out


def _port_arg_bytes(arch, shape_name, multi_pod):
    shape = next(s for a, s, _ in all_cells()
                 if a == arch and s.name == shape_name)
    cell = build_cell(arch, shape, abstract_production_mesh(
        multi_pod=multi_pod), multi_pod)
    return [tree_bytes(a) for a in cell.args]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_per_rank_argument_bytes_equal_jax(arch, shape):
    for multi_pod in (False, True):
        got = _port_arg_bytes(arch, shape, multi_pod)
        assert got == _jax_arg_bytes(arch, shape, multi_pod), multi_pod


def test_all_38_runnable_cells_are_listed():
    from repro.configs.registry import all_cells as jax_all_cells
    assert len(CELLS) == 38
    assert CELLS == [(a, s.name) for a, s, _ in jax_all_cells()]


def test_planted_wrong_spec_fails(monkeypatch):
    """deepfm's batch replicated where the JAX cell splits it over the
    data axes: its bytes are no longer JAX's."""
    from repro_torch.launch import cells
    want = _jax_arg_bytes("deepfm", "train_batch", False)
    assert _port_arg_bytes("deepfm", "train_batch", False) == want
    monkeypatch.setattr(cells, "_data_spec", lambda struct, multi_pod: {
        k: () for k in struct})
    assert _port_arg_bytes("deepfm", "train_batch", False) != want


def test_abstract_mesh_is_jax_abstract_mesh():
    m = TorchAbstractMesh((2, 16, 16), ("pod", "data", "model"), rank=37)
    j = _jax_mesh(True)
    assert m.shape == dict(j.shape) and m.size == j.size
    assert m.axis_names == tuple(j.axis_names)
    assert m.device.type == "meta"
    # rank 37 sits at (0, 2, 5), row-major
    assert [m.axis_index(a) for a in m.axis_names] == [0, 2, 5]
    with pytest.raises(RuntimeError, match="no process group"):
        m.group("data")


def test_collectives_on_an_abstract_mesh_count_and_skip():
    """Meta outputs of the real shapes, counted by kind, bytes and axis,
    with no torch.distributed call (no process group exists here)."""
    from repro_torch.sharding import collectives as coll
    m = TorchAbstractMesh((2, 4), ("data", "model"), rank=5)
    m.stats = coll.CommStats()
    x = torch.empty((8, 3), device="meta")
    assert coll.psum(x, m, ("data", "model")).shape == (8, 3)
    assert coll.all_gather(x, m, "model", dim=1).shape == (8, 12)
    assert coll.all_to_all(x, m, "model", 0, 1).shape == (2, 12)
    assert coll.broadcast(x, m, "data").shape == (8, 3)
    assert coll.pmax(x, m, "model").shape == (8, 3)
    assert m.stats.counted() == (
        6, 6 * 96, {"all-gather": 1, "all-reduce": 3, "all-to-all": 1,
                    "broadcast": 1},
        {"all-gather": 96, "all-reduce": 288, "all-to-all": 96,
         "broadcast": 96})
    assert m.stats.axis_bytes == {"data": 192, "model": 384}


# ----------------------------------------------------------------------
# the dry run at (2, 2) against 4 gloo ranks
# ----------------------------------------------------------------------

# name -> (arch, shape at a smoke size, opts)
MESH_CELLS = {
    "deepfm-train": ("deepfm", ShapeSpec("train_batch", "rec_train",
                                         batch=16), ()),
    "deepfm-serve": ("deepfm", ShapeSpec("serve_p99", "rec_serve",
                                         batch=8), ()),
    "deepfm-retrieval": ("deepfm", ShapeSpec(
        "retrieval_cand", "rec_retrieval", batch=1, n_candidates=30), ()),
    "bst-train": ("bst", ShapeSpec("train_batch", "rec_train", batch=8),
                  ()),
    "bst-serve": ("bst", ShapeSpec("serve_p99", "rec_serve", batch=8), ()),
    "two-tower-train": ("two-tower-retrieval", ShapeSpec(
        "train_batch", "rec_train", batch=8), ()),
    "two-tower-serve": ("two-tower-retrieval", ShapeSpec(
        "serve_p99", "rec_serve", batch=8), ()),
    "two-tower-retrieval": ("two-tower-retrieval", ShapeSpec(
        "retrieval_cand", "rec_retrieval", batch=1, n_candidates=40), ()),
    "stablelm-train": ("stablelm-3b", ShapeSpec(
        "train_4k", "train", seq_len=16, global_batch=4), ("fsdp",)),
    "qwen3-train": ("qwen3-moe-30b-a3b", ShapeSpec(
        "train_4k", "train", seq_len=16, global_batch=4),
        ("moe_shard_map", "microbatch2")),
    "gemma3-4b-prefill": ("gemma3-4b", ShapeSpec(
        "prefill_32k", "prefill", seq_len=16, global_batch=2), ()),
    "gemma3-4b-decode": ("gemma3-4b", ShapeSpec(
        "decode_32k", "decode", seq_len=24, global_batch=2), ()),
    "gemma3-4b-long": ("gemma3-4b", ShapeSpec(
        "long_500k", "decode", seq_len=32, global_batch=1),
        ("split_cache",)),
    "mace-molecule": ("mace", ShapeSpec(
        "molecule", "graph_batched", n_nodes=5, n_edges=12,
        batch_graphs=3), ()),
    "mace-graph": ("mace", ShapeSpec(
        "full_graph_sm", "graph_full", n_nodes=14, n_edges=40, d_feat=6),
        ()),
}


def _smoke_cell(name, mesh):
    arch, shape, opts = MESH_CELLS[name]
    _, cfg = get_arch(arch, smoke=True)
    return build_cell(arch, shape, mesh, opts=opts, cfg=cfg)


def _fill(args, seed):
    """The cell's inputs (every argument after the state or served model
    that is not a cache) filled: ints in [0, 2) (a valid id, token,
    species, node, label and graph of every smoke config), floats from
    a normal."""
    g = torch.Generator().manual_seed(seed)
    for a in args:
        leaves = a.values() if isinstance(a, dict) else [a]
        for t in leaves:
            if not isinstance(t, torch.Tensor):
                continue
            if t.dtype.is_floating_point:
                t.copy_(torch.randn(t.shape, generator=g))
            else:
                t.copy_(torch.randint(0, 2, t.shape, generator=g))


def _inputs(name, cell):
    """The indices of the cell's arguments that are inputs: the last
    (batch, tokens, graph; a decode's cache stays empty), two-tower's
    corpus and user too."""
    last = len(cell.args) - 1
    return [1, 2] if name == "two-tower-retrieval" else [last]


def _counted_body(rank):
    """Each cell's step on this rank, counted; then deepfm's train step
    again with one planted extra collective."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import collectives as coll
    torch.manual_seed(0)
    m = make_debug_mesh(2, 2, device="cpu")
    out = {}
    for name in list(MESH_CELLS) + ["planted"]:
        cell = _smoke_cell("deepfm-train" if name == "planted" else name, m)
        _fill([cell.args[i] for i in _inputs(name, cell)], 100 + rank)
        m.stats = coll.CommStats()
        try:
            cell.fn(*cell.args)
            if name == "planted":
                coll.psum(torch.zeros(3), m, "data")
        finally:
            stats, m.stats = m.stats, None
        out[name] = stats.counted()
    return out


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    """Each rank's counts on 4 gloo ranks."""
    return spawn(_counted_body, 4, store_dir=tmp_path_factory.mktemp("pg"),
                 timeout_s=TIMEOUT)


def _dry(name, rank):
    mesh = TorchAbstractMesh((2, 2), ("data", "model"), rank=rank)
    return trace_step(_smoke_cell(name, mesh), mesh)["comm"].counted()


@pytest.mark.parametrize("name", sorted(MESH_CELLS))
def test_dry_run_counts_what_gloo_ranks_count(counted, name):
    for rank in range(4):
        assert _dry(name, rank) == counted[rank][name], rank


def test_planted_extra_collective_fails(counted):
    for rank in range(4):
        assert counted[rank]["planted"] != _dry("deepfm-train", rank)
        assert counted[rank]["deepfm-train"] == _dry("deepfm-train", rank)


# ----------------------------------------------------------------------
# the counter and the terms
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_flops_by_dtype(dtype):
    a = torch.empty((64, 32), dtype=dtype, device="meta")
    b = torch.empty((32, 48), dtype=dtype, device="meta")
    with roofline.CostCounter() as c:
        a @ b
    name = str(dtype).rsplit(".", 1)[-1]
    assert c.flops == {name: 2 * 64 * 32 * 48}
    size = a.element_size()
    assert c.bytes == (64 * 32 + 32 * 48 + 64 * 48) * size


def _op_args():
    """Each op's arguments on the meta device, and the FLOPs, bytes and
    dtype the chip's bound columns give them (PERF.md §6)."""
    meta = dict(device="meta")
    b, d, k, s, n, q, topk = 512, 5, 256, 2, 4096, 8, 100
    u8 = dict(dtype=torch.uint8, **meta)
    codes = torch.empty((b, d), **u8)
    cent = torch.empty((d, k, s), **meta)
    m, dd = 4, 10
    rq_codes, cbs = torch.empty((b, m), **u8), torch.empty((m, k, dd), **meta)
    packed, pcent = torch.empty((b, 3), **u8), torch.empty((d, 16, s), **meta)
    e = torch.empty((b, d, s), dtype=torch.bfloat16, **meta)
    cent16 = torch.empty((d, k, s), dtype=torch.bfloat16, **meta)
    table = torch.empty((1000, 16), **meta)
    ids = torch.empty((300,), dtype=torch.int64, **meta)
    seg = torch.empty((300,), dtype=torch.int32, **meta)
    qh = torch.empty((2, 64, 4, 32), dtype=torch.bfloat16, **meta)
    kh = torch.empty((2, 64, 2, 32), dtype=torch.bfloat16, **meta)
    lut = torch.empty((q, k), **meta)
    luts = torch.empty((3, q, k), **meta)
    pq = torch.empty((n, q), **u8)
    pairs = 16 * 17 // 2 + (64 - 16) * 16
    return {
        "mgqe_decode": ((codes, cent), {},
                        (0, b * d + d * k * s * 4 + b * d * s * 4,
                         "float32")),
        "rq_decode_stages": ((rq_codes, cbs), {},
                             (b * (m - 1) * dd,
                              b * m + m * k * dd * 4 + b * dd * 4,
                              "float32")),
        "packed_decode": ((packed, pcent, 4), {},
                          (0, b * 3 + d * 16 * s * 4 + b * d * s * 4,
                           "float32")),
        "dpq_assign": ((e, cent16), {},
                       (2 * s * d * b * k,
                        b * d * s * 2 + d * k * s * 2 + b * d * 4,
                        "bfloat16")),
        "embedding_bag": ((table, ids, seg, 40), {},
                          (300 * 16, 300 * 16 * 4 + 300 * 12 + 40 * 16 * 4,
                           "float32")),
        "flash_attention": ((qh, kh, kh), {"window": 16},
                            (4 * 32 * pairs * 2 * 4,
                             (2 * qh.numel() + 2 * kh.numel()) * 2,
                             "bfloat16")),
        "pq_score": ((lut, pq), {}, (n * q, n * q + q * k * 4 + n * 4,
                                     "float32")),
        "pq_score_batched": ((luts, pq), {},
                             (3 * n * q, n * q + 3 * q * k * 4 + 3 * n * 4,
                              "float32")),
        "pq_topk": ((luts, pq, topk), {},
                    (3 * n * q, n * q + 3 * q * k * 4 + 3 * topk * 8,
                     "float32")),
    }


@pytest.mark.parametrize("op", sorted(_op_args()))
def test_each_kernel_op_counts_once_at_its_cost(op):
    """Dispatched on the meta device inside the counter: one op, its
    cost's FLOPs and bytes, none of its plain version's aten ops."""
    from repro_torch.kernels import dispatch
    args, kw, (flops, nbytes, dtype) = _op_args()[op]
    cost = dispatch.op_cost(op, *args, **kw)
    assert (cost.flops, cost.bytes, cost.dtype) == (flops, nbytes, dtype)
    c = roofline.CostCounter()
    with dispatch.counting(c), c:
        dispatch.dispatch(op, *args, **kw)
    assert c.ops == {op: 1}
    assert c.bytes == nbytes
    assert c.flops == {dtype: flops}
    bound = roofline.kernel_roofline(flops, nbytes, dtype=dtype)
    assert bound["bound_ms"] == pytest.approx(
        max(flops / roofline.peak_flops(dtype), nbytes / roofline.HBM_BW)
        * 1e3)


def _lm_step_flops(remat, granularity="layer"):
    from repro_torch.launch.cells import lm_train_cell
    _, cfg = get_arch("stablelm-3b", smoke=True)
    cfg = dataclasses.replace(cfg, remat=remat,
                              remat_granularity=granularity)
    mesh = TorchAbstractMesh((1, 1), ("data", "model"))
    shape = ShapeSpec("train_4k", "train", seq_len=16, global_batch=2)
    cell = build_cell("stablelm-3b", shape, mesh, cfg=cfg)
    assert isinstance(cell.cell, type(lm_train_cell(cfg, mesh)))
    return sum(trace_step(cell, mesh)["counter"].flops.values())


def test_remat_recompute_is_visible_in_flops():
    """Remat recomputes each layer's forward in the backward: more FLOPs
    than without it, by less than one more forward (2·N·D) of the
    layers."""
    plain = _lm_step_flops(False)
    layer = _lm_step_flops(True)
    group = _lm_step_flops(True, "group")
    assert layer > plain and group > plain
    assert layer - plain < plain / 2


@pytest.mark.parametrize("arch", ["stablelm-3b", "gemma3-4b", "gemma3-27b",
                                  "qwen3-moe-30b-a3b", "mixtral-8x7b"])
def test_prefill_flops_are_the_traced_count(arch):
    """``roofline.lm_prefill_flops`` (the card's prefill bound) equals the
    FLOPs a prefill cell traces on the meta device, less the masked
    pairs that the plain attention computes there and the kernel skips
    (a window's and the causal mask's), exactly."""
    from repro_torch.kernels.flash_attention.ops import visible_pairs
    from repro_torch.models import lm
    _, cfg = get_arch(arch, smoke=True)
    b, s = 2, 16
    mesh = TorchAbstractMesh((1, 1), ("data", "model"))
    cell = build_cell(arch, ShapeSpec("p", "prefill", seq_len=s,
                                      global_batch=b), mesh, cfg=cfg)
    traced = sum(trace_step(cell, mesh)["counter"].flops.values())
    masked = sum(4 * cfg.resolved_head_dim * cfg.num_heads * b
                 * (s * s - visible_pairs(s, window))
                 for _, _, window, _ in lm._layer_plan(cfg, s))
    assert masked > 0
    assert traced == roofline.lm_prefill_flops(cfg, b, s) + masked


def test_roofline_fraction_is_not_capped():
    """A call faster than its bound reads a share above 1: the count of
    its FLOPs or bytes is wrong, and the share says so."""
    r = roofline.kernel_roofline(0, 3.35e9, measured_s=0.5e-3)
    assert r["bound_ms"] == pytest.approx(1.0)
    assert r["roofline_fraction"] == pytest.approx(2.0)


def test_dominant_term():
    t = roofline.RooflineTerms(compute_s=1.0, memory_s=3.0, collective_s=2.0,
                               hlo_flops=1e12, hlo_bytes=1e12,
                               collective_bytes=1e9, model_flops=5e11)
    assert t.dominant == "memory" and t.bound_s == 3.0
    assert t.useful_fraction == 0.5
    assert t.roofline_fraction == pytest.approx(0.5e12 * 1e-12 / 3.0)
    x = torch.empty((4096, 4096), device="meta")
    with roofline.CostCounter() as c:
        x @ x
    mm = roofline.terms(c.flops, c.bytes, {}, {"data": 1, "model": 1})
    with roofline.CostCounter() as c:
        x + x
    add = roofline.terms(c.flops, c.bytes, {}, {"data": 1, "model": 1})
    assert mm.dominant == "compute" and add.dominant == "memory"
    coll = roofline.terms({}, 0, {"model": 1e9}, {"data": 16, "model": 16})
    assert coll.dominant == "collective"
    assert coll.collective_s == pytest.approx(1e9 / roofline.IB_BW)


@pytest.mark.parametrize("shape,axis,want", [
    ({"data": 2, "model": 2}, "model", "nvlink"),
    ({"data": 2, "model": 2}, "data", "nvlink"),
    ({"data": 1, "model": 8}, "model", "nvlink"),
    ({"data": 2, "model": 8}, "data", "ib"),
    ({"data": 16, "model": 16}, "model", "ib"),
    ({"pod": 2, "data": 4, "model": 2}, "data", "nvlink"),
    ({"pod": 2, "data": 4, "model": 2}, "pod", "ib"),
])
def test_axis_link(shape, axis, want):
    bw = {"nvlink": roofline.NVLINK_BW, "ib": roofline.IB_BW}[want]
    assert roofline.axis_link_bw(shape, axis) == bw


# ----------------------------------------------------------------------
# the CLI and the options
# ----------------------------------------------------------------------

def test_dryrun_cli_prints_the_skips_and_exits_0(capsys):
    from repro_torch.launch import dryrun
    assert dryrun.main(["--arch", "stablelm-3b", "--shape", "long_500k"]) \
        == 0
    out = capsys.readouterr().out
    assert "[stablelm-3b x long_500k] SKIPPED" in out
    assert dryrun.main(["--arch", "bst", "--multi-pod", "--shape",
                        "serve_p99"]) == 0
    out = capsys.readouterr().out
    assert "1 cells OK, 0 failed" in out and "2x16x16" not in out


def test_dryrun_cli_exits_1_on_a_failure(capsys):
    from repro_torch.launch import dryrun
    assert dryrun.main(["--arch", "deepfm", "--shape", "serve_p99",
                        "--opt", "fsdp"]) == 1
    out = capsys.readouterr()
    assert "[deepfm x serve_p99] FAILED" in out.out
    assert "unknown opt 'fsdp' for family recsys" in out.err


@pytest.mark.parametrize("family,arch,opt", [
    ("lm", "stablelm-3b", "sharded_embedding"),
    ("recsys", "deepfm", "remat_group"),
    ("gnn", "mace", "microbatchx"),
])
def test_unknown_option_names_its_family(family, arch, opt):
    shape = next(s for a, s, _ in all_cells() if a == arch)
    with pytest.raises(ValueError, match=f"unknown opt {opt!r} for family "
                                         f"{family}"):
        build_cell(arch, shape, abstract_production_mesh(), opts=(opt,))


@pytest.mark.parametrize("opt", ["microbatch2", "embed_full",
                                 "embed_sharded_rows", "moe_shard_map",
                                 "remat_group", "split_cache",
                                 "xent_chunk_256", "attn_block_2048",
                                 "fsdp", "kv_repeat"])
def test_every_lm_option_of_jax_builds(opt):
    """Every option JAX's ``build_cell`` takes for an LM builds here, its
    argument bytes equal to JAX's cell's with that option."""
    arch = "qwen3-moe-30b-a3b" if opt == "moe_shard_map" else "gemma3-4b"
    shape_name = "long_500k" if opt == "split_cache" and arch == \
        "gemma3-4b" else "train_4k"
    shape = next(s for a, s, _ in all_cells()
                 if a == arch and s.name == shape_name)
    cell = build_cell(arch, shape, abstract_production_mesh(), opts=(opt,))
    assert f"+opts[{opt}]" in cell.note
    assert [tree_bytes(a) for a in cell.args] == _jax_arg_bytes(
        arch, shape_name, False, (opt,))
