"""The port's ServingEngine and serve CLI against the JAX package's.

Both engines serve the same exported table (the JAX artifact carried
across with ``repro_torch.convert``) through the same request streams:
the counters must be equal and every served row bit-identical.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import deepfm as jax_deepfm
from repro.configs import two_tower_retrieval as jax_two_tower
from repro.core import Embedding as JaxEmbedding
from repro.core import EmbeddingConfig as JaxConfig
from repro.launch import engine as jax_engine
from repro.launch import serve as jax_serve
from repro.models.recsys import fields as jax_fields
from repro_torch.configs import deepfm, get_arch
from repro_torch.convert import artifact_from_numpy
from repro_torch.core import Embedding, EmbeddingConfig
from repro_torch.launch import engine, serve
from repro_torch.models.recsys import fields

COUNTERS = ("requests", "lookups", "padded_lookups", "flushes")

CONFIGS = {
    "shared_k": dict(vocab_size=5000, dim=10, kind="mgqe", num_subspaces=5,
                     num_centroids=256, tier_boundaries=(500,),
                     tier_num_centroids=(256, 64)),
    "private_d": dict(vocab_size=5000, dim=10, kind="mgqe", num_subspaces=5,
                      num_centroids=16, mgqe_variant="private_d",
                      tier_boundaries=(500,), tier_num_subspaces=(5, 2)),
    "dpq": dict(vocab_size=5000, dim=8, kind="dpq", num_subspaces=4,
                num_centroids=32),
    # deepfm's rq field and the mpe table of the JAX bench, cut to 5,000
    # rows: M = 5 stages of K = 256; tiers at 5% and 25% at 8/4/2 bits
    "rq": dict(vocab_size=5000, dim=10, kind="rq", num_levels=5,
               num_centroids=256),
    "mpe": dict(vocab_size=5000, dim=10, kind="mpe", num_subspaces=5,
                tier_boundaries=(250, 1250), tier_bits=(8, 4, 2)),
}


def _engines(kw, block_b=None, max_queue=512):
    jemb = JaxEmbedding(JaxConfig(**kw, kernel_backend="xla"))
    jart = jemb.export(jemb.init(jax.random.PRNGKey(0)))
    cfg = EmbeddingConfig(**kw)
    emb = Embedding(cfg, device="cpu")
    tart = artifact_from_numpy(jax.tree.map(np.asarray, jart), cfg, "cpu")
    jeng = jax_engine.ServingEngine(jemb, jart, block_b=block_b,
                                    max_queue=max_queue)
    teng = engine.ServingEngine(emb, tart, block_b=block_b,
                                max_queue=max_queue, device="cpu")
    return jeng, teng


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_random_stream_counters_equal_to_jax(name):
    jeng, teng = _engines(CONFIGS[name])
    vocab = CONFIGS[name]["vocab_size"]
    jst = jax_engine.drive_random_stream(jeng, vocab, 60, 48, seed=3)
    tst = engine.drive_random_stream(teng, vocab, 60, 48, seed=3)
    for c in COUNTERS:
        assert getattr(tst, c) == getattr(jst, c), c
    assert tst.seconds > 0 and tst.lookups_per_s > 0


def test_zipf_stream_counters_equal_to_jax():
    jeng, teng = _engines(CONFIGS["shared_k"], max_queue=300)
    jst = jax_engine.drive_zipf_stream(jeng, 5000, 40, 64, seed=1)
    tst = engine.drive_zipf_stream(teng, 5000, 40, 64, seed=1)
    for c in COUNTERS:
        assert getattr(tst, c) == getattr(jst, c), c


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_flushed_rows_bit_identical_to_jax(name):
    jeng, teng = _engines(CONFIGS[name], block_b=64)
    rng = np.random.default_rng(5)
    reqs = [rng.integers(0, 5000, int(n)) for n in (1, 63, 64, 130, 7)]
    for r in reqs:
        assert jeng.submit(r) == teng.submit(r)
    jouts, touts = jeng.flush(), teng.flush()
    assert len(jouts) == len(touts) == len(reqs)
    for r, j, t in zip(reqs, jouts, touts):
        assert tuple(t.shape) == (len(r), teng.emb.cfg.dim)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert teng.stats().padded_lookups == 320        # 265 -> 5 x 64
    np.testing.assert_array_equal(teng.lookup([3, 4999]).numpy(),
                                  np.asarray(jeng.lookup([3, 4999])))


def test_engine_overrides_rebuild_the_config():
    _, teng = _engines(CONFIGS["dpq"], block_b=32)
    assert teng.block_b == teng.pad_multiple == 32
    assert teng.emb.cfg.decode_block_b == 32
    eng2 = engine.ServingEngine(teng.emb, teng.artifact, backend="torch",
                                device="cpu")
    assert eng2.emb.cfg.kernel_backend == "torch"
    np.testing.assert_array_equal(eng2.lookup([1, 2]).numpy(),
                                  teng.lookup([1, 2]).numpy())


def test_out_of_range_ids_refused_on_the_host():
    _, teng = _engines(CONFIGS["dpq"])
    for bad in ([5000], [-1], [0, 7, 5001]):
        with pytest.raises(ValueError, match=r"\[0, 5000\)"):
            teng.submit(bad)
    assert teng.pending == 0


def test_empty_flush_and_stats_dict():
    _, teng = _engines(CONFIGS["dpq"])
    assert teng.flush() == []
    d = teng.stats().as_dict()
    assert d["lookups_per_s"] == 0.0 and d["flushes"] == 0
    assert set(COUNTERS) <= set(d)


def test_serving_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    cfg = EmbeddingConfig(**CONFIGS["dpq"])
    emb = Embedding(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.ServingEngine(emb, emb.export(emb.init()))


@pytest.mark.parametrize("arch,smoke", [
    ("deepfm", True), ("deepfm", False),
    ("two-tower-retrieval", True), ("two-tower-retrieval", False)],
    ids=["smoke", "full", "two-tower-smoke", "two-tower-full"])
def test_embedding_config_of_arch_equal_to_jax(arch, smoke):
    family, cfg = get_arch(arch, smoke=smoke)
    jmod = {"deepfm": jax_deepfm, "two-tower-retrieval": jax_two_tower}[arch]
    jcfg = jmod.smoke_config() if smoke else jmod.CONFIG
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    got = engine.embedding_config_of_arch(family, cfg)
    want = jax_engine.embedding_config_of_arch("recsys", jcfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if not smoke and arch == "deepfm":
        # the full-width table the card serves
        assert (got.vocab_size, got.dim, got.num_subspaces) == \
            (10_000_000, 10, 5)
        assert got.tier_boundaries == (1_000_000,)
        assert got.tier_num_centroids == (256, 64)
    if not smoke and arch == "two-tower-retrieval":
        # the item table: n_items rows at the towers' width
        assert (got.vocab_size, got.dim, got.num_subspaces) == \
            (10_000_000, 256, 16)
        assert got.tier_num_centroids == (256, 64)
    assert deepfm.CONFIG.field_vocab_sizes == jax_deepfm.CONFIG.field_vocab_sizes


EMBED_KINDS = ("full", "dpq", "mgqe", "rq", "lrf", "sq", "hash")


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("kind", EMBED_KINDS)
def test_field_embedding_config_equal_to_jax(kind, smoke):
    """Every embed_kind, on every field of deepfm (small fields stay
    full); ``mpe`` and unknown kinds raise in both packages."""
    _, cfg = get_arch("deepfm", smoke=smoke)
    jcfg = jax_deepfm.smoke_config() if smoke else jax_deepfm.CONFIG
    cfg = dataclasses.replace(cfg, embed_kind=kind)
    jcfg = dataclasses.replace(jcfg, embed_kind=kind)
    for vocab in sorted(set(cfg.field_vocab_sizes)):
        got = fields.field_embedding_config(cfg, vocab)
        want = jax_fields.field_embedding_config(jcfg, vocab)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), vocab
    if kind == "rq" and not smoke:
        # the field the card serves: M = 5 stages, K = 256, d = 10
        got = engine.embedding_config_of_arch("recsys", cfg)
        assert (got.vocab_size, got.num_levels, got.num_centroids,
                got.dim) == (10_000_000, 5, 256, 10)
    for bad in ("mpe", "nope"):
        big = max(cfg.field_vocab_sizes)
        with pytest.raises(ValueError):
            jax_fields.field_embedding_config(
                dataclasses.replace(jcfg, embed_kind=bad), big)
        with pytest.raises(ValueError):
            fields.field_embedding_config(
                dataclasses.replace(cfg, embed_kind=bad), big)


def test_cli_smoke_counters_equal_to_jax(capsys):
    _, cfg = get_arch("deepfm", smoke=True)
    st = serve.main(["--arch", "deepfm", "--engine", "--device", "cpu",
                     "--requests", "40", "--req-batch", "32"])
    out = capsys.readouterr().out
    assert "engine table: kind=mgqe vocab=50000" in out
    assert "lookups/s" in out
    jst = jax_serve.serve_engine("recsys", jax_deepfm.smoke_config(), 40, 32,
                                 backend="xla")
    for c in COUNTERS:
        assert getattr(st, c) == getattr(jst, c), c


@pytest.mark.parametrize("kind", ["rq", "lrf", "sq", "hash"])
def test_serve_engine_of_every_kind_counters_equal_to_jax(kind, capsys):
    """serve_engine (the function behind --engine) on deepfm's smoke
    config with another embed_kind, as chip_smoke.py drives it on the
    card at full width."""
    _, cfg = get_arch("deepfm", smoke=True)
    run = serve.serve_engine("recsys", dataclasses.replace(cfg,
                                                           embed_kind=kind),
                             30, 32, device="cpu")
    assert f"engine table: kind={kind} vocab=50000" in capsys.readouterr().out
    assert len(run.requests) == 30 and run.engine.emb.cfg.kind == kind
    jst = jax_serve.serve_engine(
        "recsys", dataclasses.replace(jax_deepfm.smoke_config(),
                                      embed_kind=kind), 30, 32,
        backend="xla")
    for c in COUNTERS:
        assert getattr(run.stats, c) == getattr(jst, c), c
    ids = np.concatenate(run.requests[:3])
    rows = run.engine.lookup(ids)
    want = run.emb.serve(run.artifact, torch.from_numpy(ids.astype(np.int32)))
    assert torch.equal(rows, want)


@pytest.mark.parametrize("argv", [
    ["--arch", "deepfm", "--device", "cpu", "--batch", "0"],   # no rows
    ["--arch", "deepfm", "--engine", "--mesh", "data=2"],       # no model axis
    ["--arch", "deepfm", "--engine", "--kernel-backend", "xla"],
    ["--arch", "deepfm", "--engine", "--zipf-a", "0.5"],
    ["--arch", "deepfm", "--device", "cpu", "--engine",
     "--host-staged"],                                 # retrieval only
    ["--arch", "two-tower-retrieval", "--device", "cpu",
     "--host-staged"],                                 # flat: not stageable
    ["--arch", "two-tower-retrieval", "--device", "cpu",
     "--retrieval", "ivf_pq", "--nprobe", "0"],
])
def test_cli_refuses_unported_or_bad_flags(argv):
    with pytest.raises(SystemExit):
        serve.main(argv)


@pytest.mark.parametrize("flags", [
    ["--retrieval", "ivf_pq"],
    ["--retrieval", "ivf_pq", "--host-staged"],
    ["--retrieval", "ivf_pq", "--nprobe", "4"],
])
def test_cli_runs_ivf_flags(flags, capsys):
    """The IVF flags the CLI once refused, run on the CPU."""
    run = serve.main(["--arch", "two-tower-retrieval", "--device", "cpu",
                      "--candidates", "2000"] + flags)
    out = capsys.readouterr().out
    nprobe = int(flags[flags.index("--nprobe") + 1]) if "--nprobe" in \
        flags else 8
    assert f"nprobe={nprobe})" in out and run.stats.requests == 50
    assert run.engine.host_staged == ("--host-staged" in flags)


def test_cli_unknown_arch():
    with pytest.raises(KeyError, match="unknown arch"):
        serve.main(["--arch", "no-such-arch", "--engine", "--device", "cpu"])
