"""Backend resolution and the autotune cache of the port's dispatch
layer: ``auto`` follows the input tensor's device, a pinned ``cuda``
on CPU tensors raises (no fallback), and shape buckets key the tune
cache exactly as the JAX package's do."""
import json

import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jax_dispatch
from repro_torch.core.types import KERNEL_BACKENDS, EmbeddingConfig
from repro_torch.kernels import dispatch
from repro_torch.kernels.dpq_assign import dpq_assign_blocked_ref


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    monkeypatch.delenv(dispatch.TUNE_CACHE_ENV, raising=False)
    dispatch.clear_tune_cache()
    yield
    dispatch.clear_tune_cache()


def test_backends_are_cuda_and_torch():
    assert dispatch.BACKENDS == ("auto", "cuda", "torch")
    assert KERNEL_BACKENDS == dispatch.BACKENDS
    assert set(dispatch.registered_ops()) == {
        "dpq_assign", "embedding_bag", "flash_attention", "mgqe_decode",
        "packed_decode", "pq_score", "pq_score_batched", "pq_topk",
        "rq_decode_stages"}
    for impls in dispatch.registered_ops().values():
        assert set(impls) == {"cuda", "torch"}


@pytest.mark.parametrize("device,want", [("cpu", "torch"),
                                         ("cuda", "cuda"),
                                         ("cuda:1", "cuda")])
def test_auto_resolves_from_tensor_device(device, want):
    assert dispatch.resolve_backend(None, torch.device(device)) == want
    assert dispatch.resolve_backend("auto", torch.device(device)) == want


def test_auto_without_a_device_raises():
    with pytest.raises(ValueError, match="device"):
        dispatch.resolve_backend("auto")


def test_precedence_explicit_env_default(monkeypatch):
    cpu, card = torch.device("cpu"), torch.device("cuda")
    assert dispatch.resolve_backend("cuda", cpu) == "cuda"
    monkeypatch.setenv(dispatch.ENV_VAR, "cuda")
    assert dispatch.resolve_backend(None, cpu) == "cuda"
    assert dispatch.resolve_backend("auto", cpu) == "cuda"
    assert dispatch.resolve_backend("torch", cpu) == "torch"
    monkeypatch.setenv(dispatch.ENV_VAR, "torch")
    assert dispatch.resolve_backend(None, card) == "torch"
    assert dispatch.resolve_backend("cuda", card) == "cuda"
    monkeypatch.setenv(dispatch.ENV_VAR, "auto")
    assert dispatch.resolve_backend(None, card) == "cuda"
    assert dispatch.resolve_backend(None, cpu) == "torch"


@pytest.mark.parametrize("bad", ["pallas", "xla", "interpret", "gpu"])
def test_bad_backend_names_raise_with_valid_set(bad, monkeypatch):
    with pytest.raises(ValueError, match="expected one of"):
        dispatch.resolve_backend(bad, torch.device("cpu"))
    with pytest.raises(ValueError, match="kernel backend"):
        EmbeddingConfig(vocab_size=8, dim=4, kernel_backend=bad)
    monkeypatch.setenv(dispatch.ENV_VAR, bad)
    with pytest.raises(ValueError, match=r"\('auto', 'cuda', 'torch'\)"):
        dispatch.resolve_backend(None, torch.device("cpu"))


def test_env_cuda_on_cpu_tensors_raises_not_falls_back(monkeypatch):
    codes = torch.zeros((4, 2), dtype=torch.uint8)
    cent = torch.zeros((2, 4, 3))
    monkeypatch.setenv(dispatch.ENV_VAR, "cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        dispatch.dispatch("mgqe_decode", codes, cent)


def test_pinned_backend_pins_and_restores(monkeypatch):
    """Inside the block an op with no backend of its own resolves to
    the pinned one; after it the environment is as it was."""
    import os
    with dispatch.pinned_backend("torch"):
        assert dispatch.resolve_backend(None, torch.device("cuda")) == "torch"
    assert dispatch.ENV_VAR not in os.environ
    monkeypatch.setenv(dispatch.ENV_VAR, "cuda")
    with dispatch.pinned_backend(None):
        assert os.environ[dispatch.ENV_VAR] == "cuda"
    with pytest.raises(ValueError, match="auto"):
        with dispatch.pinned_backend("tpu"):
            pass
    assert os.environ[dispatch.ENV_VAR] == "cuda"


def test_unknown_op_raises():
    with pytest.raises(KeyError, match="not registered"):
        dispatch.dispatch("nope", torch.zeros(1))


@pytest.mark.parametrize("shapes", [[(256, 5), (5, 256, 2)],
                                    [(4000, 8), (8, 256, 8)],
                                    [(1, 1), (3, 7, 5)]])
def test_shape_bucket_matches_jax(shapes):
    np_args = [np.zeros(shapes[0], np.uint8), np.zeros(shapes[1], np.float32)]
    t_args = [torch.from_numpy(a) for a in np_args]
    assert (dispatch.shape_bucket(*t_args, None, 3)
            == jax_dispatch.shape_bucket(*np_args, None, 3))


def _assign_args(b=300):
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.normal(size=(b, 5, 2)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(5, 64, 2)).astype(np.float32)),
            None)


def test_tune_picks_fastest_and_dispatch_uses_it(monkeypatch):
    args = _assign_args()
    fake = {64: 3.0, 128: 1.0, 256: 2.0, 512: 2.0, 1024: 5.0}

    def timer(thunk, iters):
        thunk()                      # records the combo through the spy
        return fake[calls[-1]]

    impl = dispatch._REGISTRY["dpq_assign"]["torch"]
    calls = []

    def spy(*a, **kw):
        calls.append(kw["block_b"])
        return impl(*a, **kw)

    monkeypatch.setitem(dispatch._REGISTRY["dpq_assign"], "torch", spy)
    won = dispatch.tune("dpq_assign", [args], timer=timer)
    assert list(won.values()) == [{"block_b": 128}]
    assert calls[0] == dispatch.op_tunables("dpq_assign")["block_b"].default
    calls.clear()
    dispatch.dispatch("dpq_assign", *args)
    assert calls == [128]
    calls.clear()
    dispatch.dispatch("dpq_assign", *args, block_b=64)   # explicit pins
    assert calls == [64]


def test_untuned_dispatch_skips_the_shape_bucket(monkeypatch):
    def no_bucket(*args):
        raise AssertionError("shape bucket built with nothing tuned")

    monkeypatch.setattr(dispatch, "shape_bucket", no_bucket)
    e, c, _ = _assign_args()
    got = dispatch.dispatch("dpq_assign", e, c, None)
    assert torch.equal(got, dpq_assign_blocked_ref(e, c, None))


def test_tune_ties_keep_the_default():
    won = dispatch.tune("dpq_assign", [_assign_args()],
                        timer=lambda thunk, iters: (thunk(), 1.0)[1])
    default = dispatch.op_tunables("dpq_assign")["block_b"].default
    assert list(won.values()) == [{"block_b": default}]


def test_tuned_block_sizes_are_bit_identical():
    e, c, _ = _assign_args(1000)
    outs = [dpq_assign_blocked_ref(e, c, block_b=bb)
            for bb in dispatch.op_tunables("dpq_assign")["block_b"].candidates]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_tune_cache_file_round_trip(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv(dispatch.TUNE_CACHE_ENV, str(path))
    args = _assign_args()
    won = dispatch.tune("dpq_assign", [args],
                        timer=lambda thunk, iters: (thunk(), 1.0)[1])
    raw = json.loads(path.read_text())
    assert raw["dpq_assign"]["torch"] == won
    dispatch.clear_tune_cache()
    assert dispatch.tuned_params("dpq_assign", args) == next(iter(
        won.values()))


def test_corrupt_tune_cache_warns_and_defaults(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    path.write_text(json.dumps({"dpq_assign": {"pallas": {"x": {}}}}))
    monkeypatch.setenv(dispatch.TUNE_CACHE_ENV, str(path))
    with pytest.warns(RuntimeWarning, match="ignoring invalid"):
        assert dispatch.tuned_params("dpq_assign", _assign_args()) == {}
