"""Port parity, end to end: a JAX booster carried across with
``model_from_arrays`` and served by the port's ``Predictor(device="cpu")``
gives the JAX package's ``serve.Predictor(..., quantize="int16",
traverse="fused")`` answers — raw scores bit for bit (the JAX side runs its
Pallas kernel in interpret mode), transformed outputs within 1e-6 (both
compute in float32; the exp is another library's).  A max_bin-1023
model (uint16 bins, split bins past 255) serves the same way through both
packs.  On the card (``cuda`` marker) the CUDA path equals the CPU path
bit for bit.

The JAX package is imported inside fixtures, so the file collects on the
card too."""

import numpy as np
import pytest
import torch

from torch_port_util import P, cuda_device, messy_data, state_from_booster  # noqa: F401

from lightgbm_tpu_torch import Predictor, model_from_arrays
from lightgbm_tpu_torch.serve import cache_stats, clear_plan_cache

SIZES = (1, 31, 33, 100, 512)


@pytest.fixture(scope="module")
def lgb():
    return pytest.importorskip("lightgbm_tpu")


@pytest.fixture(scope="module")
def messy():
    return messy_data()


@pytest.fixture(scope="module")
def binary(lgb, messy):
    X, y = messy
    bst = lgb.train(P, lgb.Dataset(X, label=y), 8)
    return bst, model_from_arrays(state_from_booster(bst))


@pytest.fixture(scope="module")
def multiclass(lgb):
    rng = np.random.RandomState(4)
    X = rng.randn(900, 5)
    X[rng.rand(900, 5) < 0.05] = np.nan
    y = rng.randint(0, 3, 900)
    bst = lgb.train({"objective": "multiclass", "num_class": 3,
                     "num_leaves": 7, "verbosity": -1},
                    lgb.Dataset(X, label=y), 4)
    return bst, model_from_arrays(state_from_booster(bst)), X


@pytest.fixture(scope="module")
def jax_fused(lgb, binary):
    from lightgbm_tpu import serve
    return serve.Predictor(binary[0], raw_score=True, quantize="int16",
                           traverse="fused")


@pytest.mark.parametrize("n", SIZES)
def test_raw_scores_bitwise_vs_jax_fused(binary, messy, jax_fused, n):
    X, _ = messy
    port = Predictor(binary[1], raw_score=True, quantize="int16",
                     device="cpu")
    want = jax_fused.predict(X[:n])
    got = port.predict(X[:n])
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_int8_raw_scores_bitwise_vs_jax_fused(lgb, binary, messy):
    from lightgbm_tpu import serve
    X, _ = messy
    want = serve.Predictor(binary[0], raw_score=True, quantize="int8",
                           traverse="fused").predict(X[:100])
    got = Predictor(binary[1], raw_score=True, quantize="int8",
                    device="cpu").predict(X[:100])
    np.testing.assert_array_equal(got, want)


def test_binary_probabilities_vs_jax(lgb, binary, messy):
    from lightgbm_tpu import serve
    X, _ = messy
    want = serve.Predictor(binary[0], quantize="int16",
                           traverse="fused").predict(X[:100])
    got = Predictor(binary[1], quantize="int16", device="cpu").predict(
        X[:100])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_multiclass_vs_jax(lgb, multiclass):
    """Raw margins bit for bit (three class packs), softmax within 1e-6."""
    from lightgbm_tpu import serve
    bst, model, X = multiclass
    for raw in (True, False):
        want = serve.Predictor(bst, raw_score=raw, quantize="int16",
                               traverse="fused").predict(X[:64])
        got = Predictor(model, raw_score=raw, quantize="int16",
                        device="cpu").predict(X[:64])
        assert got.shape == want.shape == (64, 3)
        if raw:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_regression_identity_output_vs_jax(lgb, messy):
    """The identity transform still rounds through float32, as in JAX."""
    from lightgbm_tpu import serve
    X, y = messy
    label = y + np.nan_to_num(X[:, 5])
    bst = lgb.train({"objective": "regression", "num_leaves": 7,
                     "verbosity": -1}, lgb.Dataset(X, label=label), 3)
    model = model_from_arrays(state_from_booster(bst))
    want = serve.Predictor(bst, quantize="int16").predict(X[:50])
    got = Predictor(model, quantize="int16", device="cpu").predict(X[:50])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quantize", ["int16", "int8"])
def test_max_bin_1023_model_bitwise_vs_jax_fused(lgb, messy, quantize):
    from lightgbm_tpu import serve
    X, y = messy
    bst = lgb.train(dict(P, max_bin=1023), lgb.Dataset(X, label=y), 4)
    assert bst._gbdt.train_data.binned.bins.dtype == np.uint16
    model = model_from_arrays(state_from_booster(bst))
    assert max(int(t.split_bin.max()) for t in model.host_trees()[0]) > 255
    want = serve.Predictor(bst, raw_score=True, quantize=quantize,
                           traverse="fused").predict(X[:200])
    got = Predictor(model, raw_score=True, quantize=quantize,
                    device="cpu").predict(X[:200])
    np.testing.assert_array_equal(got, want)


def test_untrained_model_answers_init_scores(lgb):
    X, y = messy_data(n=400)
    b0 = lgb.Booster(params=dict(P), train_set=lgb.Dataset(X, label=y))
    model = model_from_arrays(state_from_booster(b0))
    out = Predictor(model, raw_score=True, quantize="int16",
                    device="cpu").predict(X[:10])
    np.testing.assert_array_equal(out, np.full(10, b0._gbdt.init_scores[0]))


def test_sparse_batch_equals_dense(binary, messy):
    sp = pytest.importorskip("scipy.sparse")
    X, _ = messy
    Xd = np.nan_to_num(X[:120])
    port = Predictor(binary[1], raw_score=True, quantize="int16",
                     device="cpu")
    np.testing.assert_array_equal(port.predict(sp.csr_matrix(Xd)),
                                  port.predict(Xd))


def test_quantize_off_and_unfused_raise(binary, messy):
    """quantize="off" (the default) serves the fp32 pack: raw scores bit
    for bit those of the JAX package's fp32 serve plan.  The unfused
    traversal has no counterpart and raises."""
    from lightgbm_tpu import serve
    X, _ = messy
    want = serve.Predictor(binary[0], raw_score=True,
                           quantize="off").predict(X[:100])
    for kw in ({"quantize": "off"}, {}):
        got = Predictor(binary[1], raw_score=True, device="cpu",
                        **kw).predict(X[:100])
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    with pytest.raises(NotImplementedError, match="unfused"):
        Predictor(binary[1], quantize="int16", traverse="unfused",
                  device="cpu")


def test_default_device_without_cuda_raises(binary, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(binary[1], quantize="int16")


def test_input_checks_and_metrics(binary, messy):
    X, _ = messy
    clear_plan_cache()
    port = Predictor(binary[1], raw_score=True, quantize="int16",
                     device="cpu")
    one = port.predict(X[3])                     # a 1-D row
    np.testing.assert_array_equal(one, port.predict(X[3:4]))
    with pytest.raises(ValueError, match="inf"):
        port.predict(np.where(np.arange(6) == 2, np.inf, X[0]))
    with pytest.raises(ValueError, match="rows"):
        port.predict(X[:4, :5])
    assert port.predict(X[:0]).shape == (0,)
    snap = port.metrics_snapshot()
    assert snap["requests"] == 3 and snap["rows"] == 2
    assert snap["padded_rows"] == 62 and snap["quantize"] == "int16"
    assert snap["p99_ms"] >= snap["p50_ms"] > 0
    Predictor(binary[1], raw_score=True, quantize="int16", device="cpu")
    st = cache_stats()
    assert st["builds"] == 1 and st["hits"] == 1
    assert st["bytes"] == port.plan.plan_bytes > port.plan.pack_bytes
    assert port.warmup(64) == 2
    clear_plan_cache()


@pytest.mark.cuda
def test_card_path_equals_cpu_path(cuda_device):
    """On the card: CUDA-served answers equal the CPU plain path bit for
    bit, with one kernel launch per request (random full-width trees, no
    JAX needed)."""
    import chip_smoke as cs
    from lightgbm_tpu_torch import bin_dataset
    from lightgbm_tpu_torch.ops import traverse
    rng = np.random.RandomState(1)
    X, _ = cs.make_higgs_like(20_000, 28, 1)
    X = X.astype(np.float64)
    X[rng.rand(*X.shape) < 0.02] = np.nan
    model = model_from_arrays(cs.random_model_state(
        rng, bin_dataset(X, max_bin=255), 100, 255))
    gpu = Predictor(model, raw_score=True, quantize="int16")
    cpu = Predictor(model, raw_score=True, quantize="int16", device="cpu")
    before = traverse.launches
    for n in (1, 7, 256):
        np.testing.assert_array_equal(gpu.predict(X[:n]), cpu.predict(X[:n]))
    assert traverse.launches == before + 3


@pytest.mark.parametrize("fault", ["feature", "child", "two_parents",
                                   "leaves", "shape"])
def test_model_from_arrays_refuses_malformed_trees(binary, fault):
    """Trees carried across are checked before the kernel indexes with
    them: features, children and leaves in range, one parent per node."""
    state = state_from_booster(binary[0])
    tree = dict(state["trees"][0][0])
    if fault == "feature":
        tree["split_feature"] = tree["split_feature"] + 6
    elif fault == "child":
        tree["left_child"] = np.where(tree["left_child"] < 0, -99,
                                      tree["left_child"])
    elif fault == "two_parents":
        tree["right_child"] = tree["left_child"].copy()
    elif fault == "leaves":
        tree["num_leaves"] = state["num_leaves"] + 1
    else:
        tree["leaf_value"] = tree["leaf_value"][:-1]
    state["trees"] = [[tree]]
    with pytest.raises(ValueError):
        model_from_arrays(state)
