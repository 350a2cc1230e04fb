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
from repro_torch.configs import deepfm, get_arch
from repro_torch.convert import artifact_from_numpy
from repro_torch.core import Embedding, EmbeddingConfig
from repro_torch.launch import engine, serve

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


@pytest.mark.parametrize("argv", [
    ["--arch", "deepfm", "--device", "cpu"],                     # no --engine
    ["--arch", "deepfm", "--engine", "--mesh", "data=2"],       # not ported
    ["--arch", "deepfm", "--engine", "--kernel-backend", "xla"],
    ["--arch", "deepfm", "--engine", "--zipf-a", "0.5"],
    ["--arch", "two-tower-retrieval", "--device", "cpu",
     "--retrieval", "ivf_pq"],                                  # not ported
    ["--arch", "two-tower-retrieval", "--device", "cpu", "--host-staged"],
    ["--arch", "two-tower-retrieval", "--device", "cpu", "--nprobe", "4"],
])
def test_cli_refuses_unported_or_bad_flags(argv):
    with pytest.raises(SystemExit):
        serve.main(argv)


def test_cli_unknown_arch():
    with pytest.raises(KeyError, match="not ported"):
        serve.main(["--arch", "gemma3-4b", "--engine", "--device", "cpu"])
