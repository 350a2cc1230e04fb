"""The port's ``embedding_bag`` op and the recsys fields' pooled lookups
against the JAX package.

Inputs are drawn with numpy and handed to both packages.  The port's
``bag`` runs its plain version here (CPU tensors): one float32 segment
sum, rounded once to the table's dtype.  Beside it, the port's
``embedding_bag_inorder`` adds in the CUDA kernel's order and rounding
(the card tests hold the kernel to it bit for bit).  The JAX side runs
its ``xla`` reference (``embedding_bag_ref``) and the Pallas kernel in
interpret mode.  The bars:

* float32 against the reference: bit-identical, both port versions
  (all add the bag's rows in id order from +0.0, one rounded add each;
  the CPU's ``index_add`` adds in id order);
* float32 weighted against the interpreted kernel: within 1e-5 (the
  interpreter may fuse ``out += row * w`` into one FMA, the port rounds
  the product first);
* bfloat16, the in-order version: bit-identical to the interpreted
  kernel and, unweighted, to the reference (every product and add
  rounded to bfloat16, as the kernel's ``out_ref[...] +=`` rounds).
  Weighted, the reference promotes to float32 (bfloat16 rows times
  float32 weights) where the kernel and the port stay in bfloat16, so
  the port is held to it within the rounding of every product and add:
  (terms + 1) * 2^-8 times the bag's sum of |row * w|;
* bfloat16, the plain version (products rounded, sums in float32,
  rounded once): within that same bar of the kernel and the reference;
* ``fields.embedding_bag``: sum and mean as the plain version above;
  max, a gather and a segment max on both sides, bit-identical, with
  -inf in empty bags as JAX's ``segment_max`` leaves them;
  ``embedding_bag_padded`` within 1e-6 (a ``sum`` over the padded axis,
  reduced in another order).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import embedding_bag as jax_bag_kernel
from repro.kernels.embedding_bag import embedding_bag_ref as jax_bag_ref
from repro.models.recsys import fields as jax_fields
from repro_torch.kernels import dispatch
from repro_torch.kernels.embedding_bag import (bag, embedding_bag,
                                               embedding_bag_inorder,
                                               embedding_bag_ref)
from repro_torch.kernels.embedding_bag.embedding_bag import (
    BAG_BLOCKS_PER_SM, BAG_CHUNK_MAX, BAG_SMEM_BUDGET, BAG_THREADS,
    BAG_WIDE_BYTES, BAG_WIDE_CHUNK_BYTES, bag_plan, bag_smem)
from repro_torch.models.recsys import fields

INTERPRET_TOL = 1e-5     # float32, weighted: FMA in the interpreter
BF16_EPS = 2.0 ** -8     # bfloat16 rounding, relative

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np32(x) -> np.ndarray:
    x = x.detach() if isinstance(x, torch.Tensor) else x
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _inputs(nnz, bags, vocab, dim, seed, weighted):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(vocab, dim)).astype(np.float32)
    seg = np.sort(rng.integers(0, bags, nnz)).astype(np.int32)
    ids = rng.integers(0, vocab, nnz).astype(np.int32)
    w = rng.normal(size=nnz).astype(np.float32) if weighted else None
    return table, ids, seg, w


def _both(table, ids, seg, bags, w, dtype):
    """(port's bag, port's in-order version, JAX reference, JAX
    interpreted kernel), each as float32 numpy, on the same inputs in
    ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    jt = jnp.asarray(table, jdt)
    jw = None if w is None else jnp.asarray(w)
    ref = jax_bag_ref(jt, jnp.asarray(ids), jnp.asarray(seg), bags, jw)
    ker = jax_bag_kernel(jt, jnp.asarray(ids), jnp.asarray(seg), bags, jw,
                         interpret=True)
    tt = torch.from_numpy(table).to(tdt)
    args = (tt, torch.from_numpy(ids), torch.from_numpy(seg), bags,
            None if w is None else torch.from_numpy(w))
    got, inorder = bag(*args), embedding_bag_inorder(*args)
    for t in (got, inorder):
        assert t.dtype == tdt and tuple(t.shape) == (bags, table.shape[1])
    return _np32(got), _np32(inorder), _np32(ref), _np32(ker)


def _abs_sums(table, ids, seg, bags, w, dtype):
    """Per bag and column, the number of terms and the sum of |row * w|
    (in float64, the table first rounded to ``dtype``)."""
    t = _np32(jnp.asarray(table, DTYPES[dtype][0])).astype(np.float64)
    rows = np.abs(t[ids]) * (1.0 if w is None else np.abs(w)[:, None])
    s = np.zeros((bags, table.shape[1]))
    np.add.at(s, seg, rows)
    n = np.bincount(seg, minlength=bags)[:, None]
    return n, s


def _check(got, inorder, ref, ker, n, abs_sum, dtype, weighted):
    bar = (n + 1) * BF16_EPS * abs_sum
    if dtype == "float32":
        for t in (got, inorder):
            np.testing.assert_array_equal(t, ref)
            if weighted:
                np.testing.assert_allclose(t, ker, rtol=INTERPRET_TOL,
                                           atol=INTERPRET_TOL)
            else:
                np.testing.assert_array_equal(t, ker)
        return
    np.testing.assert_array_equal(inorder, ker)
    if weighted:
        assert (np.abs(inorder - ref) <= bar).all()
    else:
        np.testing.assert_array_equal(inorder, ref)
    assert (np.abs(got - ker) <= bar).all()
    assert (np.abs(got - ref) <= bar).all()


# --------------------------------------------- tests/test_kernels.py twins

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bag_matching_jax(dtype):
    rng = np.random.default_rng(0)
    table = rng.normal(size=(40, 8)).astype(np.float32)
    ids = np.asarray([1, 2, 2, 7, 39, 0, 5], np.int32)
    seg = np.asarray([0, 0, 2, 2, 2, 4, 4], np.int32)
    got, inorder, ref, ker = _both(table, ids, seg, 6, None, dtype)
    _check(got, inorder, ref, ker, *_abs_sums(table, ids, seg, 6, None, dtype),
           dtype, False)
    assert (got[[1, 3, 5]] == 0).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bag_weighted_and_empty_bags(dtype):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(20, 4)).astype(np.float32)
    ids = np.asarray([3, 3, 3], np.int32)
    seg = np.asarray([1, 1, 3], np.int32)
    w = np.asarray([0.5, 1.5, 2.0], np.float32)
    got, inorder, ref, ker = _both(table, ids, seg, 5, w, dtype)
    _check(got, inorder, ref, ker, *_abs_sums(table, ids, seg, 5, w, dtype), dtype,
           True)
    assert np.abs(got[[0, 2, 4]]).sum() == 0


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("nnz,bags,vocab,dim", [(50, 10, 100, 16),
                                                (200, 7, 30, 32),
                                                (333, 64, 1000, 10)])
def test_bag_random_sweep(nnz, bags, vocab, dim, dtype, weighted):
    table, ids, seg, w = _inputs(nnz, bags, vocab, dim, nnz, weighted)
    got, inorder, ref, ker = _both(table, ids, seg, bags, w, dtype)
    _check(got, inorder, ref, ker, *_abs_sums(table, ids, seg, bags, w, dtype),
           dtype, weighted)


def test_bag_int64_ids_and_ragged_edge():
    """int64 ids and segments (torch's default), 257 bags with the
    last one holding the only ids, and no ids at all."""
    rng = np.random.default_rng(5)
    table = rng.normal(size=(30, 6)).astype(np.float32)
    ids = np.asarray([4, 29, 0], np.int64)
    seg = np.asarray([256, 256, 256], np.int64)
    got = bag(torch.from_numpy(table), torch.from_numpy(ids),
              torch.from_numpy(seg), 257)
    want = np.asarray(jax_bag_ref(jnp.asarray(table), jnp.asarray(ids),
                                  jnp.asarray(seg), 257))
    np.testing.assert_array_equal(got.numpy(), want)
    empty = bag(torch.from_numpy(table), torch.zeros(0, dtype=torch.int64),
                torch.zeros(0, dtype=torch.int64), 3)
    assert tuple(empty.shape) == (3, 6) and (empty == 0).all()


def test_plain_bag_is_differentiable_like_jax():
    """Grads to the table and the weights of the plain version against
    ``jax.grad`` of the reference (float32, within 1e-6)."""
    table, ids, seg, w = _inputs(120, 9, 40, 8, 7, True)
    cot = np.random.default_rng(8).normal(size=(9, 8)).astype(np.float32)

    def jloss(t, ww):
        return jnp.sum(jax_bag_ref(t, jnp.asarray(ids), jnp.asarray(seg), 9,
                                   ww) * cot)

    jg_t, jg_w = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table),
                                                 jnp.asarray(w))
    tt = torch.from_numpy(table).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = bag(tt, torch.from_numpy(ids), torch.from_numpy(seg), 9, tw)
    torch.sum(out * torch.from_numpy(cot)).backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg_t), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jg_w), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_bag_is_one_segment_sum(dtype):
    """The plain version is one gather and one float32 ``index_add``,
    rounded once; a bag of 5,000 ids costs it no more steps than a bag
    of one (the in-order version takes one step per position)."""
    rng = np.random.default_rng(9)
    table = torch.from_numpy(rng.normal(size=(60, 10)).astype(np.float32)
                             ).to(DTYPES[dtype][1])
    ids = torch.from_numpy(rng.integers(0, 60, 5003))
    seg = torch.cat([torch.zeros(5000, dtype=torch.int64),
                     torch.tensor([1, 3, 3])])
    w = torch.from_numpy(rng.normal(size=5003).astype(np.float32))
    rows = (table[ids] * w.to(table.dtype)[:, None]).float()
    want = torch.zeros(4, 10).index_add(0, seg, rows).to(table.dtype)
    got = embedding_bag_ref(table, ids, seg, 4, w)
    assert got.dtype == table.dtype
    np.testing.assert_array_equal(_np32(got), _np32(want))
    assert (got[2] == 0).all()
    inorder = embedding_bag_inorder(table, ids, seg, 4, w)
    if dtype == "float32":
        np.testing.assert_array_equal(_np32(got), _np32(inorder))
    else:
        n = torch.bincount(seg, minlength=4)[:, None].numpy()
        abs_sum = torch.zeros(4, 10).index_add(0, seg, rows.abs()).numpy()
        bar = (n + 1) * BF16_EPS * abs_sum
        assert (np.abs(_np32(got) - _np32(inorder)) <= bar).all()


def test_out_of_range_ids_are_clamped():
    """Outside the contract the plain version clamps ids into the table,
    as the kernel does (JAX's reference gives NaN rows there; no parity
    is claimed)."""
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    out = bag(table, torch.tensor([-3, 9]), torch.tensor([0, 1]), 2)
    np.testing.assert_array_equal(out.numpy(), table[[0, 3]].numpy())


# ------------------------------------------------- registration, refusals

def test_op_is_registered_with_both_backends():
    impls = dispatch.registered_ops()["embedding_bag"]
    assert set(impls) == {"cuda", "torch"}
    assert impls["torch"] is embedding_bag_ref
    assert dispatch.op_tunables("embedding_bag") == {}


def test_cuda_wrapper_refuses_cpu_tensors():
    table, ids, seg, _ = _inputs(10, 3, 8, 4, 0, False)
    args = (torch.from_numpy(table), torch.from_numpy(ids),
            torch.from_numpy(seg), 3)
    before = embedding_bag.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        embedding_bag(*args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bag(*args, backend="cuda")
    assert embedding_bag.launches == before


@pytest.mark.parametrize("which", ["table", "weights"])
def test_cuda_wrapper_refuses_grad(which):
    """The kernel has no backward: a table or weights that require grad
    are refused (before any device check), and accepted under no_grad
    (where only the device check is left to refuse these CPU tensors)."""
    table, ids, seg, w = _inputs(10, 3, 8, 4, 0, True)
    tt, tw = torch.from_numpy(table), torch.from_numpy(w)
    (tt if which == "table" else tw).requires_grad_(True)
    args = (tt, torch.from_numpy(ids), torch.from_numpy(seg), 3, tw)
    with pytest.raises(RuntimeError, match="no backward"):
        embedding_bag(*args)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        embedding_bag(*args)


# ------------------------------------------------------ fields.embedding_bag

@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_fields_embedding_bag_matches_jax(mode, weighted):
    table, ids, seg, w = _inputs(90, 12, 50, 10, 11, weighted)
    seg[seg == 4] = 5                                 # bag 4 left empty
    seg = np.sort(seg)
    want = np.asarray(jax_fields.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(seg), 12,
        None if w is None else jnp.asarray(w), mode=mode, backend="xla"))
    got = fields.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(seg),
        12, None if w is None else torch.from_numpy(w), mode=mode)
    if mode == "mean":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    empty = -np.inf if mode == "max" else 0.0
    assert (got.numpy()[4] == empty).all() and (want[4] == empty).all()


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_fields_embedding_bag_bf16_matches_jax(mode):
    table, ids, seg, _ = _inputs(300, 5, 40, 8, 13, False)
    jt = jnp.asarray(table, jnp.bfloat16)
    want = np.asarray(jax_fields.embedding_bag(
        jt, jnp.asarray(ids), jnp.asarray(seg), 5, mode=mode,
        backend="xla"))
    assert want.dtype == ml_dtypes.bfloat16
    got = fields.embedding_bag(torch.from_numpy(table).bfloat16(),
                               torch.from_numpy(ids), torch.from_numpy(seg),
                               5, mode=mode)
    assert got.dtype == torch.bfloat16
    # the plain sum against JAX's per-add rounding, as in _check; a mean
    # divides both by the count and rounds once more on each side
    n, abs_sum = _abs_sums(table, ids, seg, 5, None, "bfloat16")
    bar = (n + 1) * BF16_EPS * abs_sum
    if mode == "mean":
        bar = (bar + 2 * BF16_EPS * abs_sum) / np.maximum(n, 1)
    assert (np.abs(_np32(got) - want.astype(np.float32)) <= bar).all()
    inorder = embedding_bag_inorder(torch.from_numpy(table).bfloat16(),
                                    torch.from_numpy(ids),
                                    torch.from_numpy(seg), 5)
    if mode == "sum":
        np.testing.assert_array_equal(_np32(inorder), want.astype(np.float32))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_padded_matches_jax(mode):
    rng = np.random.default_rng(17)
    table = rng.normal(size=(30, 6)).astype(np.float32)
    ids = rng.integers(0, 30, (7, 5))
    ids[rng.random((7, 5)) < 0.4] = -1
    ids[3] = -1                                       # an all-padding row
    want = np.asarray(jax_fields.embedding_bag_padded(
        jnp.asarray(table), jnp.asarray(ids, jnp.int32), mode=mode))
    got = fields.embedding_bag_padded(torch.from_numpy(table),
                                      torch.from_numpy(ids), mode=mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert (got.numpy()[3] == 0).all()


# ------------------------------------------------ the kernel's launch plan
# bag_plan is pure Python: its plans are pinned here at deepfm's (d = 10)
# and two-tower's (d = 256) widths, in float32 and bfloat16, and walked
# below as the kernel walks them.

SMS = 132
PLAN_SHAPES = {"deepfm": 10, "two_tower": 256, "wide": 4096}


@pytest.mark.parametrize("idx_bytes", [4, 8])
@pytest.mark.parametrize("elem_bytes", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(PLAN_SHAPES))
@pytest.mark.parametrize("num_bags", [1, 257, 1000, 4096, 1_000_000])
def test_bag_plan_fits_what_the_kernel_takes(num_bags, shape, elem_bytes,
                                             idx_bytes):
    """Every bag in exactly one tile and every vector of a row in one
    slab; a thread per (bag, vector) of a tile; shared memory as the
    kernel lays it out, within a block's 227 KB and the budget of
    BAG_BLOCKS_PER_SM blocks an SM; at least one row a chunk."""
    d = PLAN_SHAPES[shape]
    p = bag_plan(num_bags, d, elem_bytes, idx_bytes, SMS)
    assert p.threads == BAG_THREADS
    assert d % p.vec == 0 and p.vec * elem_bytes <= 16
    g = d // p.vec
    assert 1 <= p.slab <= min(g, BAG_THREADS)
    assert p.grid_y * p.slab >= g > (p.grid_y - 1) * p.slab
    assert 1 <= p.tile and p.tile * p.slab <= BAG_THREADS
    assert p.grid_x * p.tile >= num_bags > (p.grid_x - 1) * p.tile
    assert 1 <= p.chunk <= BAG_CHUNK_MAX
    assert p.smem == bag_smem(p.tile, p.chunk, p.slab, p.vec * elem_bytes,
                              idx_bytes)
    assert p.smem <= min(227 * 1024, BAG_SMEM_BUDGET)
    assert BAG_BLOCKS_PER_SM * (p.smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("elem_bytes", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ["deepfm", "two_tower"])
def test_bag_plan_fills_the_card_at_4096_bags(shape, elem_bytes):
    """At the paths' 4,096 bags every SM gets a block; narrow rows take
    the smallest tile that BAG_BLOCKS_PER_SM blocks an SM allow:
    deepfm's 16 bags a tile (256 blocks, one wave of two an SM)."""
    p = bag_plan(4096, PLAN_SHAPES[shape], elem_bytes, 4, SMS)
    blocks = p.grid_x * p.grid_y
    assert blocks >= SMS
    if shape == "deepfm":
        assert p.tile == -(-4096 // (BAG_BLOCKS_PER_SM * SMS))
        assert (p.vec, p.tile, p.slab, p.grid_x) == (2, 16, 5, 256)
        assert blocks <= BAG_BLOCKS_PER_SM * SMS
    else:
        assert p.tile == 1 and blocks == 4096


def test_bag_plan_wide_rows():
    """The wide-row rule: a slab of at least BAG_WIDE_BYTES takes tiles
    of one bag and chunks of BAG_WIDE_CHUNK_BYTES of rows (d = 256: 16
    float32 rows of 1 KB, 32 bfloat16 rows); rows past BAG_THREADS
    vectors are cut into slabs of BAG_THREADS vectors, a chunk still of
    several rows (d = 4,096: 4 slabs of 4 KB in float32, 2 in bfloat16,
    4 rows a chunk).  Below the rule, the chunk is what the budget holds
    for both buffers."""
    assert BAG_WIDE_BYTES == 512 and BAG_WIDE_CHUNK_BYTES == 16 * 1024
    p = bag_plan(4096, 256, 4, 4, SMS)
    assert (p.vec, p.slab, p.grid_y, p.tile, p.chunk) == (4, 64, 1, 1, 16)
    b = bag_plan(4096, 256, 2, 4, SMS)
    assert (b.vec, b.slab, b.grid_y, b.tile, b.chunk) == (8, 32, 1, 1, 32)
    for eb, slabs in ((4, 4), (2, 2)):
        w = bag_plan(4096, 4096, eb, 8, SMS)
        assert (w.slab, w.grid_y, w.tile, w.chunk) == (BAG_THREADS, slabs,
                                                       1, 4)
    # just below the rule (d = 64 float32: 256-byte rows) the chunk is
    # what the budget holds, and one more id would not fit
    n = bag_plan(4096, 64, 4, 4, SMS)
    assert n.slab * n.vec * 4 < BAG_WIDE_BYTES and n.tile == 16
    assert bag_smem(n.tile, n.chunk + 1, n.slab, 16, 4) > BAG_SMEM_BUDGET
    assert n.smem <= BAG_SMEM_BUDGET
    # deepfm's narrow rows: the chunk at its cap, a tile's ids in one
    assert bag_plan(4096, 10, 4, 4, SMS).chunk == BAG_CHUNK_MAX


def test_bag_plan_vectors_follow_alignment():
    """The vector is the widest that divides d and both addresses; a
    bfloat16 row of odd width takes 2-byte vectors."""
    assert bag_plan(4096, 10, 4, 4, SMS).vec == 2
    assert bag_plan(4096, 256, 4, 4, SMS, align=4).vec == 1
    assert bag_plan(4096, 256, 2, 4, SMS, align=8).vec == 4
    assert bag_plan(4096, 3, 2, 4, SMS).vec == 1
    with pytest.raises(ValueError, match="num_bags"):
        bag_plan(0, 10, 4, 4, SMS)


HINT_STEP = 1024          # csrc/embedding_bag.cu's kHintStep


def _warp_lower_bound(seg, key, hint):
    """The kernel's 32-way warp search (``warp_lower_bound``), lane by
    lane: where there are more than 32 * HINT_STEP ids, a first step of
    32 pivots HINT_STEP apart around ``hint``; then steps of 32 even
    pivots, each keeping the piece before the first that reaches
    ``key``; then the last <= 32 candidates at once."""
    lo, hi, n = 0, len(seg), len(seg)
    if n > 32 * HINT_STEP:
        piv = [min(max(hint - 16 * HINT_STEP - 1 + (j + 1) * HINT_STEP, 0),
                   n - 1) for j in range(32)]
        ge = [seg[p] >= key for p in piv]
        if not any(ge):
            lo = piv[31] + 1
        else:
            j = ge.index(True)
            hi = piv[j]
            lo = piv[j - 1] + 1 if j else 0
    while hi - lo > 32:
        n = hi - lo
        ge = [seg[lo + ((lane + 1) * n >> 5) - 1] >= key
              for lane in range(32)]
        if not any(ge):
            return hi
        j = ge.index(True)
        lo, hi = lo + (j * n >> 5), lo + ((j + 1) * n >> 5) - 1
    ge = [lo + lane < hi and seg[lo + lane] >= key for lane in range(32)]
    return lo + ge.index(True) if any(ge) else hi


def _hint(key, nnz, num_bags):
    return int(key / num_bags * nnz)


def _walk_plan(table, ids, seg, num_bags, weights, plan):
    """The kernel's partition in Python: tiles of ``plan.tile`` bags,
    each span found by the warp search, walked in chunks of
    ``plan.chunk`` ids, each bag's start by the adjacent difference (a
    sentinel until found), and a running sum per bag in id order with
    ``ref.py``'s arithmetic (every product and add rounded to the
    table's dtype)."""
    seg_l = seg.tolist()
    n = len(seg_l)
    rows = table.index_select(0, ids.long().clamp(0, table.shape[0] - 1))
    if weights is not None:
        rows = rows * weights.to(table.dtype)[:, None]
    out = torch.zeros((num_bags, table.shape[1]), dtype=table.dtype)
    big = 1 << 62
    for b0 in range(0, num_bags, plan.tile):
        nb = min(plan.tile, num_bags - b0)
        lo = _warp_lower_bound(seg_l, b0, _hint(b0, n, num_bags))
        hi = _warp_lower_bound(seg_l, b0 + nb, _hint(b0 + nb, n, num_bags))
        assert (lo, hi) == (np.searchsorted(seg_l, b0),
                            np.searchsorted(seg_l, b0 + nb))
        start = [big] * (nb + 1)
        acc = torch.zeros((nb, table.shape[1]), dtype=table.dtype)
        for c0 in range(lo, hi, plan.chunk):
            c1 = min(c0 + plan.chunk, hi)
            for i in range(c0, c1):
                b = b0 if i == lo else seg_l[i - 1] + 1
                for bag in range(max(b, b0), min(seg_l[i], b0 + nb - 1) + 1):
                    start[bag - b0] = i
            for t in range(nb):
                for i in range(max(start[t], c0), min(start[t + 1], c1)):
                    acc[t] = acc[t] + rows[i]
        out[b0:b0 + nb] = acc
    return out


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1000, 40_000, 130_926])
def test_warp_search_is_lower_bound(n):
    """The warp search equals ``searchsorted`` on sorted segment ids,
    with the hinted first step (n > 32,768) where the hint is right,
    far off, and past either end."""
    rng = np.random.default_rng(n)
    bags = 4096
    seg = np.sort(rng.integers(0, bags, n)).tolist()
    skew = np.sort(np.minimum(rng.zipf(1.1, n), bags) - 1).tolist()
    for s in (seg, skew):
        for key in (-1, 0, 1, 7, 2048, 4000, 4095, 4096, 4097):
            want = np.searchsorted(s, key)
            for hint in (_hint(key, n, bags), 0, n, -5 * n, 5 * n):
                assert _warp_lower_bound(s, key, hint) == want


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["ragged", "one_bag", "all_empty_but_last",
                                  "empty_borders"])
def test_kernel_partition_matches_inorder(case, dtype):
    """The plan's (tile, chunk) walk, with chunks small enough that bags
    straddle them, equals ``embedding_bag_inorder`` bit for bit: ragged
    bags (a bag longer than three chunks, empty ones), one bag of every
    id, empty bags but the last, and empty bags on both sides of a tile
    border."""
    rng = np.random.default_rng(11)
    if case == "ragged":
        lens = rng.integers(0, 12, 40)
        lens[[0, 7, 8, 39]] = 0
        lens[20] = 61
    elif case == "one_bag":
        lens = np.asarray([300])
    elif case == "all_empty_but_last":
        lens = np.zeros(100, np.int64)
        lens[-1] = 9
    else:
        lens = rng.integers(1, 6, 48)
        lens[[15, 16, 31, 32, 47]] = 0            # tiles of 16 bags
    b = lens.size
    seg = np.repeat(np.arange(b), lens)
    vocab = 300 if case == "one_bag" else 50
    ids = (rng.permutation(vocab) if case == "one_bag"
           else rng.integers(-2, vocab + 2, seg.size))
    table = torch.from_numpy(rng.normal(size=(vocab, 10)).astype(np.float32)
                             ).to(DTYPES[dtype][1])
    w = torch.from_numpy(rng.normal(size=seg.size).astype(np.float32))
    tseg, tids = torch.from_numpy(seg), torch.from_numpy(ids)
    p = bag_plan(b, 10, table.element_size(), 8, SMS)
    for tile, chunk in ((p.tile, 7), (16, 7), (3, 1), (16, 64)):
        plan = p._replace(tile=tile, chunk=chunk)
        for ww in (None, w):
            got = _walk_plan(table, tids, tseg, b, ww, plan)
            want = embedding_bag_inorder(table, tids, tseg, b, ww)
            assert torch.equal(got.view(torch.int16 if dtype == "bfloat16"
                                        else torch.int32),
                               want.view(torch.int16 if dtype == "bfloat16"
                                         else torch.int32))
