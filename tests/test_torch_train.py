"""Training parity: ``lightgbm_tpu_torch.train`` against
``lightgbm_tpu.train`` on the same numpy rows.

- One iteration with ``boost_from_average=False``: the first gradients are
  exactly +-0.5 and 0.25, so the model text is byte for byte the JAX
  package's and the scores are bitwise equal.  The same holds with
  sample weights of 1 and 2, and for one ``Booster.update(fobj=...)``
  step with exact custom gradients; scipy sparse rows train the dense
  rows' model.
- Ten iterations of higgs-like rows at 31 leaves and leaf_batch 4: train
  AUC within 1e-3 of JAX's and raw predictions within 1e-4 (the gradients
  go through ``exp``, whose last bit differs between the libraries).
- Quantized training (``use_quantized_grad``): one iteration with
  deterministic rounding gives JAX's model text byte for byte (the first
  gradients' scales are powers of two), with and without
  ``quant_train_renew_leaf``; with stochastic rounding two runs of one
  seed give one model text, and since the port's stream is a
  ``torch.Generator``'s and not ``jax.random``'s, its trees differ from
  JAX's while the train AUC stays within 5e-3 of JAX's after ten
  iterations.
- The port's model text loads in ``lightgbm_tpu.Booster(model_str=...)``
  and predicts the port's raw scores within 1e-6 (the JAX loader walks
  real-valued thresholds and sums in float64; the port sums the fp32
  pack in float32).
- A JAX model carried across with ``model_from_arrays`` predicts through
  the port's fp32 ``forest_scores`` within 1e-6 of JAX's
  ``Booster.predict(raw_score=True)`` (the JAX package sums small batches
  on its float64 host path) and bit for bit like its fp32 serve plan
  (tests/test_torch_serve.py).
- 4-bit bins: at max_bin 15 training packs the bins (``Booster`` reports
  ``packed4`` on its grower config, the device bins are (N, ceil(F/2))
  uint8); one exact-sum iteration's model text is byte-equal to the JAX
  package's and, but for the ``[tpu_4bit_bins: False]`` parameter line
  that records the option, to the same run with ``tpu_4bit_bins=false``,
  f32 and quantized.
- ``tpu_histogram_impl=flat_bf16`` trains (it used to raise), through the
  fused and the unfused wave: the values are rounded to bf16 once per
  tree; one exact-sum iteration gives the f32 run's model text but for
  the parameter line, and ten ordinary iterations stay within 1e-2
  holdout AUC of f32.
- max_bin 1023 (uint16 bins): one exact-sum iteration gives the JAX
  package's model text byte for byte, f32 and quantized; five ordinary
  iterations predict within 1e-4 of the JAX package's training on the
  same params, and the model text loads in ``lightgbm_tpu.Booster(
  model_str=...)`` and predicts within 1e-6; ``tpu_wave_kernel=fused``
  at max_bin 511 trains and gives the unfused run's model text.
- The param table holds every row of the JAX package's, and resolves
  params (the new keys and their aliases too) alike.  Keys are refused
  by value, not by name: the keys that change nothing the port trains
  (threads, layout hints, ``device_type``, the predict keys, keys that
  tune a feature refused by its own key) train at any value, and every
  other key at a non-default value raises ``NotImplementedError`` naming
  its ROADMAP item; a key outside the table is ignored with a warning,
  as the JAX package ignores it.
- ``max_bin_by_feature`` (15, 63, 255 and 1023 cycled over the features,
  so the bins are uint16) with a forced-bins file: one exact-sum
  iteration gives the JAX package's model text byte for byte, and the
  fused wave's (forced on the CPU: its plain version) too.
- Every unsupported param and ``resume_from`` raise
  ``NotImplementedError``; an EFB-bundled dataset trains the unbundled
  run's model text on exact gradients (since slice 16); the entries of
  those lists that train
  since slice 13 (lambdarank, bagging, GOSS, ``feature_fraction``,
  ``group_column``, ``cv``) are checked to train, and a categorical
  feature above ``max_cat_to_onehot`` bins trains its sorted
  many-vs-many splits (since slice 15; ``cat_l2``, ``cat_smooth``,
  ``max_cat_threshold`` and ``min_data_per_group`` change its trees;
  tests/test_torch_categorical.py holds them to the JAX package); ``init_model``
  continues training and
  ``Booster(model_str=...)`` loads (tests/test_torch_load_model.py holds
  both to the JAX package); without ``device`` on a machine with no
  card, ``train`` raises.

On the card (``cuda`` marker), one exact-sum iteration gives the CPU
model text byte for byte, f32 and quantized (deterministic rounding),
over packed bins, with bf16 values, at max_bin 1023 and with
``max_bin_by_feature``."""

import numpy as np
import pytest
import torch

from torch_port_util import (cuda_device, grown_data,  # noqa: F401
                             higgs_like, state_from_booster)

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.metrics import auc, binary_logloss


@pytest.fixture(scope="module")
def lgb():
    return pytest.importorskip("lightgbm_tpu")


@pytest.fixture(scope="module")
def grown():
    return grown_data()


@pytest.fixture(scope="module")
def higgs(lgb):
    """Ten iterations of higgs-like rows at 31 leaves and leaf_batch 4, by
    both packages: (X, y, JAX booster, port booster)."""
    X, y = higgs_like(6000, 28)
    params = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
              "tpu_leaf_batch": 4}
    jb = lgb.train(params, lgb.Dataset(X, label=y), 10)
    pb = lgt.train(params, lgt.Dataset(X, label=y), 10, device="cpu")
    return X, y, jb, pb


EXACT = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
         "boost_from_average": False, "tpu_leaf_batch": 4,
         "categorical_feature": "5", "max_cat_to_onehot": 8}


def _categorical_data():
    """A one-hot categorical column engineered to win splits."""
    rng = np.random.RandomState(13)
    n = 3 * 2560
    cat = rng.randint(0, 6, n).astype(np.float64)
    X = np.column_stack([cat, rng.randn(n, 3)])
    y = (((cat == 2.0) | (cat == 5.0)) ^ (X[:, 1] > 1.0)).astype(np.float64)
    return X, y


@pytest.mark.parametrize("data", ["grown", "categorical"])
def test_one_iteration_model_text_byte_equal(lgb, grown, data):
    X, y = grown
    params = EXACT
    if data == "categorical":
        X, y = _categorical_data()
        params = dict(EXACT, categorical_feature="0")
    jb = lgb.train(params, lgb.Dataset(X, label=y), 1)
    pb = lgt.train(params, lgt.Dataset(X, label=y), 1, device="cpu")
    text = pb.model_to_string()
    assert text == jb.model_to_string()
    assert ("cat_threshold=" in text) == (data == "categorical")
    np.testing.assert_array_equal(pb._gbdt.scores.numpy(),
                                  np.asarray(jb._gbdt.scores))
    assert pb.num_trees() == 1 and pb.current_iteration == 1
    np.testing.assert_array_equal(pb.feature_importance(),
                                  jb.feature_importance())


@pytest.mark.parametrize("wave_kernel", ["fused", "unfused"])
def test_profiler_ranges_mark_an_iteration(grown, wave_kernel):
    """One iteration under ``torch.profiler`` shows every range that
    chip_smoke.py's profile phase reads: the boosting steps once, the
    grower's wave steps once per wave."""
    from torch.profiler import ProfilerActivity, profile
    X, y = grown
    bst = lgt.Booster(dict(EXACT, tpu_wave_kernel=wave_kernel),
                      lgt.Dataset(X, label=y), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bst.update()
    names = [ev.name for ev in prof.events()]
    for once in ("gbdt/gradients", "gbdt/grow", "gbdt/score_update",
                 "gbdt/host_tree", "grower/root", "grower/row_leaf"):
        assert names.count(once) == 1, once
    waves = names.count("grower/wave")
    assert waves >= 30 // EXACT["tpu_leaf_batch"]
    assert names.count("grower/partition") == waves
    assert names.count("grower/payload_read") == waves


def test_weighted_iteration_and_sparse_input(lgb, grown):
    """Sample weights of 1 and 2 keep the first gradients exact: model
    text byte-equal to JAX's; scipy sparse rows train the dense model."""
    sp = pytest.importorskip("scipy.sparse")
    X, y = grown
    w = np.where(np.arange(len(y)) % 3 == 0, 2.0, 1.0)
    params = dict(EXACT, num_leaves=15)
    jb = lgb.train(params, lgb.Dataset(X, label=y, weight=w), 1)
    pb = lgt.train(params, lgt.Dataset(X, label=y, weight=w), 1,
                   device="cpu")
    assert pb.model_to_string() == jb.model_to_string()
    Xs = np.nan_to_num(X[:3000])
    Xs[np.abs(Xs) < 0.5] = 0.0
    dense = lgt.train(params, lgt.Dataset(Xs, label=y[:3000]), 2,
                      device="cpu")
    sparse = lgt.train(params, lgt.Dataset(sp.csr_matrix(Xs),
                                           label=y[:3000]), 2, device="cpu")
    assert sparse.model_to_string() == dense.model_to_string()
    np.testing.assert_array_equal(sparse.predict(sp.csr_matrix(Xs[:50])),
                                  dense.predict(Xs[:50]))


def test_serving_predictor_of_trained_model(higgs):
    """int16 serving of a port-trained model stays within the pack's
    error bound of the fp32 predict (plus float32 summation slack)."""
    from lightgbm_tpu_torch.models.tree import quantize_error_bound
    X, _, _, bst = higgs
    pred = bst.serving_predictor(quantize="int16", raw_score=True)
    got = pred.predict(X[:1000])
    want = bst.predict(X[:1000], raw_score=True)
    bound = quantize_error_bound(pred.plan._packs[0])
    assert np.abs(got - want).max() <= bound + 10 * 2.0 ** -23 * np.abs(
        want).max()


def test_custom_gradient_update_byte_equal(lgb, grown):
    """``update(fobj=...)`` with exact gradients, boost from average on:
    the folded init score and every tree match byte for byte."""
    X, y = grown
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
    sign = np.where(np.random.RandomState(9).rand(len(y)) > 0.5, 0.5, -0.5)

    def fobj(_score, _data):
        return sign.astype(np.float32), np.full(len(y), 0.25, np.float32)

    jb = lgb.Booster(params=params, train_set=lgb.Dataset(X, label=y))
    pb = lgt.Booster(params=params, train_set=lgt.Dataset(X, label=y),
                     device="cpu")
    for b in (jb, pb):
        b.update(fobj=fobj)
    assert pb.model_to_string() == jb.model_to_string()


def test_ten_iterations_auc_and_predictions(higgs):
    X, y, jb, pb = higgs
    assert pb.num_trees() == 10
    rj = jb.predict(X, raw_score=True)
    rp = pb.predict(X, raw_score=True)
    assert rp.dtype == np.float64 and rp.shape == (len(y),)
    np.testing.assert_allclose(rp, rj, rtol=0, atol=1e-4)
    assert abs(auc(y, rp) - auc(y, rj)) <= 1e-3
    assert auc(y, rp) > 0.7
    prob = pb.predict(X[:100])
    assert prob.dtype == np.float32
    np.testing.assert_allclose(prob, jb.predict(X[:100]), atol=1e-4)
    assert abs(binary_logloss(y, rp) - binary_logloss(y, rj)) <= 1e-4


def test_saved_model_loads_in_jax(lgb, higgs, tmp_path):
    X, _, _, pb = higgs
    path = tmp_path / "port_model.txt"
    pb.save_model(str(path))
    loaded = lgb.Booster(model_file=str(path))
    np.testing.assert_allclose(loaded.predict(X, raw_score=True),
                               pb.predict(X, raw_score=True), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(loaded.predict(X), pb.predict(X), rtol=0,
                               atol=1e-6)


def test_carried_jax_model_fp32_forest_scores(higgs):
    X, _, bst, _ = higgs
    model = lgt.model_from_arrays(state_from_booster(bst))
    got = model.predict_raw(X[:500], device="cpu")
    np.testing.assert_allclose(got, bst.predict(X[:500], raw_score=True),
                               rtol=0, atol=1e-6)


QUANT = dict(EXACT, use_quantized_grad=True, stochastic_rounding=False)


@pytest.mark.parametrize("renew", [False, True])
def test_quantized_iteration_model_text_byte_equal(lgb, grown, renew):
    X, y = grown
    params = dict(QUANT, quant_train_renew_leaf=renew)
    jb = lgb.train(params, lgb.Dataset(X, label=y), 1)
    pb = lgt.train(params, lgt.Dataset(X, label=y), 1, device="cpu")
    assert pb.model_to_string() == jb.model_to_string()
    np.testing.assert_array_equal(pb._gbdt.scores.numpy(),
                                  np.asarray(jb._gbdt.scores))
    # the quantized tree is not the f32 one
    f32 = lgt.train(EXACT, lgt.Dataset(X, label=y), 1, device="cpu")
    assert f32.model_to_string() != pb.model_to_string()


def test_stochastic_rounding_repeats_and_tracks_jax_auc(lgb):
    """Stochastic rounding: one seed, one model text; another seed,
    another model.  The port draws from ``torch.Generator`` streams (one
    per iteration, ``ops/quantize.py::quant_generator``), not from
    ``jax.random`` keys, so its trees are not JAX's, but its train AUC
    after ten iterations stays within 5e-3 of JAX's."""
    X, y = higgs_like(4000, 10, seed=3)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "tpu_leaf_batch": 4, "use_quantized_grad": True}
    runs = [lgt.train(dict(params, seed=s), lgt.Dataset(X, label=y), 10,
                      device="cpu") for s in (0, 0, 1)]
    texts = [b.model_to_string() for b in runs]
    assert texts[0] == texts[1] and texts[0] != texts[2]
    jb = lgb.train(params, lgb.Dataset(X, label=y), 10)
    assert jb.model_to_string() != texts[0]
    a_port = auc(y, runs[0].predict(X, raw_score=True))
    a_jax = auc(y, jb.predict(X, raw_score=True))
    assert abs(a_port - a_jax) <= 5e-3, (a_port, a_jax)


def _drop_param(text: str, line: str) -> str:
    """Model text without one ``[key: value]`` parameter line (the line
    that records an option the two runs differ in)."""
    assert text.count(f"\n{line}\n") == 1, line
    return text.replace(f"\n{line}\n", "\n")


def _data16():
    rng = np.random.RandomState(21)
    n = 3 * 2560
    X = np.round(rng.randn(n, 7) * 2)
    X[rng.rand(n) < 0.05, 2] = np.nan
    y = (X[:, 0] + X[:, 1] + rng.randn(n) > 0).astype(np.float64)
    return X, y


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "quantized"])
def test_max_bin_15_packs_bins_and_matches(lgb, quant):
    X, y = _data16()
    params = dict(QUANT if quant else EXACT, max_bin=15,
                  categorical_feature="")
    jb = lgb.train(params, lgb.Dataset(X, label=y), 1)
    pb = lgt.train(params, lgt.Dataset(X, label=y), 1, device="cpu")
    off = lgt.train(dict(params, tpu_4bit_bins=False),
                    lgt.Dataset(X, label=y), 1, device="cpu")
    assert pb._gbdt.grower_cfg.packed4 and jb._gbdt.grower_cfg.packed4
    assert not off._gbdt.grower_cfg.packed4
    assert pb._gbdt.bins_dev.shape == (len(y), 4)
    assert pb._gbdt.bins_dev.dtype == torch.uint8
    assert off._gbdt.bins_dev.shape == (len(y), 7)
    text = pb.model_to_string()
    assert text == jb.model_to_string()
    assert text == _drop_param(off.model_to_string(),
                               "[tpu_4bit_bins: False]")
    Xc, yc = higgs_like(3000, 4)                 # 255 bins: not packed
    coarse = lgt.train(dict(params, max_bin=255), lgt.Dataset(Xc, label=yc),
                       1, device="cpu")
    assert not coarse._gbdt.grower_cfg.packed4


@pytest.mark.parametrize("wave_kernel", ["auto", "fused"])
def test_flat_bf16_trains(grown, wave_kernel):
    """flat_bf16 used to raise NotImplementedError; it now trains with
    bf16 values through the unfused (auto) or fused wave."""
    X, y = grown
    params = dict(EXACT, tpu_histogram_impl="flat_bf16",
                  tpu_wave_kernel=wave_kernel)
    pb = lgt.train(params, lgt.Dataset(X, label=y), 1, device="cpu")
    assert pb._gbdt.grow.vals.dtype == torch.bfloat16
    f32 = lgt.train(dict(EXACT, tpu_wave_kernel=wave_kernel),
                    lgt.Dataset(X, label=y), 1, device="cpu")
    assert _drop_param(pb.model_to_string(),
                       "[tpu_histogram_impl: flat_bf16]") == \
        f32.model_to_string()
    # ordinary gradients: bf16 keeps 8 significant bits of each, which
    # flips near-tie splits, so the trees differ from f32's; holdout AUC
    # after ten iterations stays within 1e-2 of f32's (measured gaps on
    # these rows are a few 1e-3, either way)
    Xh, yh = higgs_like(30_000, 28, seed=5)
    ordinary = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
                "tpu_leaf_batch": 4, "tpu_wave_kernel": wave_kernel}
    runs = [lgt.train(dict(ordinary, **extra),
                      lgt.Dataset(Xh[:20_000], label=yh[:20_000]), 10,
                      device="cpu")
            for extra in ({"tpu_histogram_impl": "flat_bf16"}, {})]
    assert runs[0].model_to_string() != runs[1].model_to_string()
    aucs = [auc(yh[20_000:], b.predict(Xh[20_000:], raw_score=True))
            for b in runs]
    assert aucs[0] > 0.66 and abs(aucs[0] - aucs[1]) <= 1e-2, aucs


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "quantized"])
def test_max_bin_1023_iteration_model_text_byte_equal(lgb, grown, quant):
    X, y = grown
    params = dict(QUANT if quant else EXACT, max_bin=1023)
    jb = lgb.train(params, lgb.Dataset(X, label=y), 1)
    pb = lgt.train(params, lgt.Dataset(X, label=y), 1, device="cpu")
    assert pb._gbdt.bins_dev.dtype == torch.uint16
    assert pb.model_to_string() == jb.model_to_string()


def test_max_bin_1023_trains_loads_in_jax_and_tracks_jax(lgb):
    X, y = higgs_like(6000, 28, seed=3)
    params = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
              "tpu_leaf_batch": 4, "max_bin": 1023}
    pb = lgt.train(params, lgt.Dataset(X, label=y), 5, device="cpu")
    assert pb._gbdt.grower_cfg.num_bins > 256
    rp = pb.predict(X, raw_score=True)
    loaded = lgb.Booster(model_str=pb.model_to_string())
    np.testing.assert_allclose(loaded.predict(X, raw_score=True), rp,
                               rtol=0, atol=1e-6)
    jb = lgb.train(params, lgb.Dataset(X, label=y), 5)
    np.testing.assert_allclose(rp, jb.predict(X, raw_score=True), rtol=0,
                               atol=1e-4)


def test_fused_wave_above_256_bins_trains():
    """max_bin 511 with ``tpu_wave_kernel=fused`` trains on the CPU
    through the fused step's plain version, and gives the unfused run's
    model text but for the parameter line that records the option."""
    X, y = higgs_like(3000, 6)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "max_bin": 511}
    texts = {}
    for kernel in ("fused", "unfused"):
        bst = lgt.train(dict(params, tpu_wave_kernel=kernel),
                        lgt.Dataset(X, label=y), 3, device="cpu")
        assert bst._gbdt.bins_dev.dtype == torch.uint16
        assert bst.num_trees() == 3
        texts[kernel] = _drop_param(bst.model_to_string(),
                                    f"[tpu_wave_kernel: {kernel}]")
    assert texts["fused"] == texts["unfused"]


def test_config_table_matches_jax():
    """Every row of the JAX package's param table is in the port's with its
    type, default, aliases and bounds, and both resolve the same params
    alike, the loader's and the no-op keys and their aliases included."""
    from lightgbm_tpu import config as JC

    from lightgbm_tpu_torch import config as PC
    assert PC._PARAMS == JC._PARAMS
    params = {"n_estimators": 7, "eta": 0.3, "min_child_samples": 3,
              "reg_lambda": 2.0, "max_bins": 63, "verbose": -1,
              "objective": "xentropy", "boosting_type": "GBRT",
              "tpu_wave_kernel": "FUSED", "use_quantized_grad": "true",
              "num_grad_quant_bins": 8, "stochastic_rounding": "false",
              "quant_train_renew_leaf": 1, "n_iter_no_change": 4,
              "early_stopping_min_delta": 0.01, "first_metric_only": "true",
              "reg_sqrt": True, "alpha": 0.3, "fair_c": 2.0,
              "poisson_max_delta_step": 0.5, "tweedie_variance_power": 1.2,
              "output_freq": 5, "train_metric": True,
              "multi_error_top_k": 2, "auc_mu_weights": "0,1,1,0",
              "metrics": "l2,auc",
              "n_jobs": 8, "device": "GPU", "deterministic": "true",
              "force_col_wise": True, "has_header": "true",
              "label": "name:target", "weight": "2", "blacklist": "4,5",
              "query_column": "", "max_bin_by_feature": "15,63,255",
              "forcedbins_filename": "bins.json",
              "saved_feature_importance_type": 1, "model_out": "m.txt",
              "is_sparse": "false", "precise_float_parser": True,
              "gpu_device_id": 2, "raw_score": "true",
              "pred_early_stop_margin": 3.5, "bagging_fraction_seed": 9,
              "rate_drop": 0.3, "topk": 7, "mc_method": "Advanced",
              "two_round_loading": True, "is_save_binary": True,
              "hist_pool_size": 32.0, "ndcg_eval_at": "1,3,5",
              "label_gain": "0;1;3", "local_port": 123,
              "machine_list": "m.txt", "ckpt_interval": 4,
              "health_policy": "WARN", "stream_budget_mb": 64.0,
              "serve_compile_cache": "/cache", "telemetry_log": "t.jsonl"}
    for extra in ({}, {"objective": "quantile:0.25"},
                  {"objective": "softmax", "num_classes": 5},
                  {"objective": "ova", "num_class": 3}):
        jc, pc = JC.Config(dict(params, **extra)), PC.Config(
            dict(params, **extra))
        for name in JC._CANONICAL:
            assert getattr(pc, name) == getattr(jc, name), name
        assert pc.raw_params == jc.raw_params
        assert pc.num_model_per_iteration == jc.num_model_per_iteration


def test_every_param_key_sorted_once():
    """Each key of the table is read by training, accepted at any value
    (``_NO_OP_KEYS``), or refused at a non-default value naming its item
    (``_REFUSED_KEYS``): the two sets are disjoint and every refused key
    has a default the port trains at."""
    from lightgbm_tpu_torch.config import _CANONICAL, Config
    from lightgbm_tpu_torch.models.gbdt import (_NO_OP_KEYS, _REFUSED_KEYS,
                                                check_supported)
    assert _NO_OP_KEYS <= set(_CANONICAL)
    assert set(_REFUSED_KEYS) <= set(_CANONICAL)
    assert not _NO_OP_KEYS & set(_REFUSED_KEYS)
    check_supported(Config({key: _CANONICAL[key][2]
                            for key in _REFUSED_KEYS}))


#: one non-default value of each no-op key
NO_OP = {"num_threads": 8, "deterministic": True, "force_col_wise": True,
         "force_row_wise": True, "is_enable_sparse": False,
         "feature_pre_filter": False, "gpu_platform_id": 1,
         "gpu_device_id": 1, "gpu_use_dp": True, "num_gpu": 2,
         "output_model": "out.txt", "precise_float_parser": True,
         "device_type": "gpu", "predict_raw_score": True,
         "pred_early_stop": True, "num_iteration_predict": 3,
         "drop_rate": 0.2, "linear_lambda": 0.5, "extra_seed": 11,
         "tpu_hist_comm": "allreduce", "refit_decay_rate": 0.5}

#: keys that were no-ops until slice 13 and are now read by sampling and
#: ranking, and the sorted categorical keys read since slice 15: inert in
#: a binary run without sampling or categorical features
SORTED_CAT_KEYS = {"cat_l2": 3.0, "cat_smooth": 150.0, "max_cat_threshold": 3,
                   "min_data_per_group": 400}
INERT_HERE = {"bagging_seed": 9, "top_rate": 0.3, "lambdarank_norm": False,
              "tpu_device_goss": "on", "objective_seed": 2,
              **SORTED_CAT_KEYS}


def test_no_op_keys_train_and_change_nothing():
    """The keys that change nothing the port trains are accepted at any
    value and give the default run's trees (the model text differs only
    in the parameter lines that record them)."""
    from lightgbm_tpu_torch.models.gbdt import _NO_OP_KEYS
    assert set(NO_OP) <= _NO_OP_KEYS
    assert not set(INERT_HERE) & _NO_OP_KEYS
    X, y = higgs_like(1500, 4)
    params = {"objective": "binary", "verbosity": -1, "num_leaves": 7}
    want = lgt.train(params, lgt.Dataset(X, label=y), 2, device="cpu")
    got = lgt.train(dict(params, **NO_OP, **INERT_HERE),
                    lgt.Dataset(X, label=y), 2, device="cpu")
    trees = lambda b: b.model_to_string().split("end of trees")[0]
    assert trees(got) == trees(want)
    # a key outside the table is kept in the text and ignored
    odd = lgt.train(dict(params, my_app_key=3), lgt.Dataset(X, label=y), 2,
                    device="cpu")
    assert trees(odd) == trees(want)
    assert "[my_app_key: 3]" in odd.model_to_string()


@pytest.mark.parametrize("key", sorted(SORTED_CAT_KEYS))
def test_sorted_categorical_keys_change_trees(key):
    """Each sorted categorical key, inert without a categorical feature,
    changes the trees of a dataset with a 30-category feature."""
    rng = np.random.RandomState(3)
    n = 3000
    cat = rng.randint(0, 30, n)
    lift = rng.rand(30) < 0.5
    X = np.column_stack([cat, rng.randn(n, 2)]).astype(np.float64)
    y = (lift[cat] ^ (rng.rand(n) < 0.2)).astype(np.float64)
    params = {"objective": "binary", "verbosity": -1, "num_leaves": 15,
              "categorical_feature": "0", "min_data_per_group": 50}
    want = lgt.train(params, lgt.Dataset(X, label=y), 2, device="cpu")
    got = lgt.train(dict(params, **{key: SORTED_CAT_KEYS[key]}),
                    lgt.Dataset(X, label=y), 2, device="cpu")
    trees = lambda b: b.model_to_string().split("end of trees")[0]
    assert "num_cat=0" not in trees(want).split("Tree=1")[0]
    assert trees(got) != trees(want)


def test_saved_feature_importance_type_gain(lgb):
    X, y = higgs_like(1500, 4)
    params = {"objective": "binary", "verbosity": -1, "num_leaves": 7,
              "boost_from_average": False,
              "saved_feature_importance_type": 1}
    want = lgb.train(params, lgb.Dataset(X, label=y), 1).model_to_string()
    got = lgt.train(params, lgt.Dataset(X, label=y), 1,
                    device="cpu").model_to_string()
    imp = got.split("feature_importances:\n")[1].split("\n\n")[0]
    assert "." in imp and imp == want.split(
        "feature_importances:\n")[1].split("\n\n")[0]


def _forced_bins_file(tmp_path):
    import json
    path = str(tmp_path / "forced_bins.json")
    with open(path, "w") as fh:
        json.dump([{"feature": 0, "bin_upper_bound": [-1.0, 0.0, 0.5]},
                   {"feature": 7, "bin_upper_bound": [0.1, 0.3]}], fh)
    return path


#: max_bin_by_feature cycling 15, 63, 255 and 1023 over grown_data's 12
BY_FEATURE = [15, 63, 255, 1023] * 3


@pytest.mark.parametrize("wave_kernel", ["auto", "fused"])
def test_max_bin_by_feature_iteration_model_text_byte_equal(lgb, grown,
                                                            tmp_path,
                                                            wave_kernel):
    X, y = grown
    params = dict(EXACT, categorical_feature="", max_bin_by_feature=BY_FEATURE,
                  forcedbins_filename=_forced_bins_file(tmp_path))
    want = lgb.train(params, lgb.Dataset(X, label=y), 1).model_to_string()
    extra = {} if wave_kernel == "auto" else {"tpu_wave_kernel": "fused"}
    bst = lgt.train(dict(params, **extra), lgt.Dataset(X, label=y), 1,
                    device="cpu")
    assert bst._gbdt.bins_dev.dtype == torch.uint16
    nb = bst._gbdt.train_data.binned.num_bins_per_feature
    assert all(n <= m for n, m in zip(nb, BY_FEATURE)) and max(nb) > 256
    assert -1.0 in bst._gbdt.train_data.binned.mappers[0].upper_bounds
    text = bst.model_to_string()
    if wave_kernel == "fused":
        text = text.replace("[tpu_wave_kernel: fused]\n", "")
    assert text == want


UNSUPPORTED = [
    {"objective": "lambdarank"},
    {"boosting": "dart"},
    {"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1},
    {"bagging_fraction": 0.5, "bagging_freq": 1},
    {"data_sample_strategy": "goss"},
    {"feature_fraction": 0.5},
    {"feature_fraction_bynode": 0.5},
    {"extra_trees": True},
    {"monotone_constraints": [1, 0, 0, 0]},
    {"forcedsplits_filename": "splits.json"},
    {"cegb_penalty_split": 0.1},
    {"interaction_constraints": "[0,1],[2,3]"},
    {"feature_contri": [1.0, 0.5, 1.0, 1.0]},
    {"linear_tree": True},
    {"tree_learner": "data"},
    {"checkpoint_interval": 5},
    {"tpu_iter_pack": 4},
    {"two_round": True},
    {"input_model": "model.txt"},
    {"histogram_pool_size": 64},
]


#: a non-default value of each refused key, with the item it names
REFUSED = [({"save_binary": True}, "A1c"), ({"two_round": True}, "A1c"),
           ({"parser_config_file": "p.json"}, "A1c"),
           ({"histogram_pool_size": 64}, "A8.5"),
           ({"tpu_split_tile": 2}, "A8.5"),
           ({"pre_partition": True}, "A10"), ({"machines": "a:1,b:2"}, "A10"),
           ({"local_listen_port": 5000}, "A10"),
           ({"checkpoint_interval": 5}, "A11"), ({"snapshot_freq": 2}, "A11"),
           ({"tpu_health_policy": "warn"}, "A11"),
           ({"tpu_telemetry_log": "t.jsonl"}, "A11"),
           ({"tpu_stream_budget_mb": 64.0}, "A11"),
           ({"serve_max_queue": 8}, "A7c"),
           ({"tpu_native_predict_max_rows": 0}, "A7d"),
           ({"tpu_serve_compile_cache": "/c"}, "A7e"),
           ({"tpu_serve_request_log": "on"}, "A7f"),
           ({"input_model": "model.txt"}, "A9"),
           ({"group_column": "0"}, "A8.2")]
#: items of REFUSED that train since slices 13 and 17
PORTED_ITEMS = ("A8.2", "A8.5")


@pytest.mark.parametrize("extra,item", REFUSED,
                         ids=lambda v: "-".join(map(str, v))
                         if isinstance(v, dict) else v)
def test_refused_values_name_their_item(extra, item):
    X, y = higgs_like(300, 4)
    params = {"objective": "binary", "verbosity": -1, **extra}
    if item in PORTED_ITEMS:
        # group_column is read by the file parser (tests/
        # test_torch_parser.py); over arrays it is ignored, as in the JAX
        # package.  The histogram pool and the tiled scan train
        # (tests/test_torch_pool.py, test_torch_split_tile.py)
        b = lgt.train(params, lgt.Dataset(X, label=y), 1, device="cpu")
        assert b.num_trees() == 1
        return
    with pytest.raises(NotImplementedError, match=item):
        lgt.train(params, lgt.Dataset(X, label=y), 1, device="cpu")


#: entries of UNSUPPORTED that train since slices 13 and 17 (ROADMAP
#: A8.2, A8.3, A8.5)
PORTED = [{"objective": "lambdarank"},
          {"bagging_fraction": 0.5, "bagging_freq": 1},
          {"data_sample_strategy": "goss"}, {"feature_fraction": 0.5},
          {"histogram_pool_size": 64}]


@pytest.mark.parametrize("extra", UNSUPPORTED,
                         ids=lambda d: "-".join(map(str, d)))
def test_unsupported_params_raise(extra):
    rng = np.random.RandomState(0)
    X = rng.randn(300, 4)
    y = (X[:, 0] > 0).astype(np.float64)
    params = {"objective": "binary", "verbosity": -1, **extra}
    if extra in PORTED:
        # trains now: lambdarank over query groups, sampling over rows
        # and features, the histogram pool (tests/test_torch_ranking.py,
        # test_torch_sampling.py and test_torch_pool.py hold them to the
        # JAX package)
        group = np.full(30, 10) if extra.get("objective") else None
        label = np.clip(np.round(X[:, 0] + 1), 0, 3) if group is not None \
            else y
        b = lgt.train(params, lgt.Dataset(X, label=label, group=group), 2,
                      device="cpu")
        assert b.num_trees() == 2
        b.update()
        assert b.num_trees() == 3
        return
    with pytest.raises(NotImplementedError):
        b = lgt.train(params, lgt.Dataset(X, label=y), 1, device="cpu")
        b.update()


def test_unsupported_datasets_and_options_raise():
    rng = np.random.RandomState(1)
    n = 4000
    # mutually exclusive sparse columns: EFB bundles them (slice 16;
    # tests/test_torch_efb.py holds it to the JAX package).  On the first
    # iteration's exact gradients (no boost from average: +-0.5, 0.25)
    # the bundled model text is the unbundled run's but for the
    # parameter line that records enable_bundle
    base = rng.randint(0, 4, n)
    X = np.zeros((n, 8))
    for j in range(4):
        X[:, j] = (base == j) * rng.rand(n)
    X[:, 4:] = rng.randn(n, 4)
    y = (X[:, 4] + base > 1.5).astype(np.float64)
    params = {"objective": "binary", "verbosity": -1}
    exact = dict(params, boost_from_average=False)
    on = lgt.train(exact, lgt.Dataset(X, label=y), 1, device="cpu")
    assert on._gbdt.bundles is not None and on._gbdt.bundles.num_groups == 5
    off = lgt.train(dict(exact, enable_bundle=False),
                    lgt.Dataset(X, label=y), 1, device="cpu")
    assert off._gbdt.bundles is None
    assert on.model_to_string() == off.model_to_string().replace(
        "\n[enable_bundle: False]\n", "\n")
    Xc = np.column_stack([rng.randint(0, 12, n), rng.randn(n)])
    # a 12-category feature trains its sorted splits (slice 15)
    sc = lgt.train(dict(params, categorical_feature="0"),
                   lgt.Dataset(Xc, label=y), 1, device="cpu")
    assert sc.num_trees() == 1
    assert "num_cat=0" not in sc.model_to_string().split("end of trees")[0]
    with pytest.raises(NotImplementedError, match="A11"):
        lgt.train(params, lgt.Dataset(X, label=y), 1, device="cpu",
                  resume_from="ckpt")
    # cv trains (slice 13; tests/test_torch_cv.py holds it to the JAX
    # package's)
    Xd = X[:, 4:]
    res = lgt.cv(params, lgt.Dataset(Xd, label=y), 2, nfold=2, device="cpu")
    assert sorted(res) == ["valid binary_logloss-mean",
                           "valid binary_logloss-stdv"]
    # continued training and loading model text now work
    Xd = X[:, 4:]
    base = lgt.train(params, lgt.Dataset(Xd, label=y), 1, device="cpu")
    cont = lgt.train(params, lgt.Dataset(Xd, label=y), 1, device="cpu",
                     init_model=base)
    assert cont.num_trees() == 2 and cont.current_iteration == 2
    loaded = lgt.Booster(model_str=cont.model_to_string(), device="cpu")
    assert loaded.num_trees() == 2
    np.testing.assert_allclose(loaded.predict(Xd), cont.predict(Xd),
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="labels in"):
        lgt.train(params, lgt.Dataset(X[:, 4:], label=y * 2), 1,
                  device="cpu")


def test_train_without_device_raises_here(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.RandomState(2).randn(100, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        lgt.train({"objective": "binary", "verbosity": -1},
                  lgt.Dataset(X, label=(X[:, 0] > 0).astype(float)), 1)


@pytest.mark.cuda
def test_card_iteration_matches_cpu_model_text(grown, cuda_device):
    X, y = grown
    want = lgt.train(EXACT, lgt.Dataset(X, label=y), 1, device="cpu")
    got = lgt.train(EXACT, lgt.Dataset(X, label=y), 1, device=cuda_device)
    assert got.model_to_string() == want.model_to_string()
    assert torch.equal(got._gbdt.scores.cpu(), want._gbdt.scores)


@pytest.mark.cuda
def test_card_quantized_iteration_matches_cpu_model_text(grown, cuda_device):
    X, y = grown
    want = lgt.train(QUANT, lgt.Dataset(X, label=y), 1, device="cpu")
    got = lgt.train(QUANT, lgt.Dataset(X, label=y), 1, device=cuda_device)
    assert got.model_to_string() == want.model_to_string()
    assert torch.equal(got._gbdt.scores.cpu(), want._gbdt.scores)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "quantized"])
def test_card_packed4_iteration_matches_cpu_model_text(cuda_device, quant):
    X, y = _data16()
    params = dict(QUANT if quant else EXACT, max_bin=15,
                  categorical_feature="")
    want = lgt.train(params, lgt.Dataset(X, label=y), 1, device="cpu")
    got = lgt.train(params, lgt.Dataset(X, label=y), 1, device=cuda_device)
    assert got._gbdt.grower_cfg.packed4
    assert got._gbdt.bins_dev.shape == (len(y), 4)
    assert got.model_to_string() == want.model_to_string()


@pytest.mark.cuda
@pytest.mark.parametrize("wave_kernel", ["auto", "fused"])
def test_card_bf16_iteration_matches_cpu_model_text(grown, cuda_device,
                                                    wave_kernel):
    X, y = grown
    params = dict(EXACT, tpu_histogram_impl="flat_bf16",
                  tpu_wave_kernel=wave_kernel)
    want = lgt.train(params, lgt.Dataset(X, label=y), 1, device="cpu")
    got = lgt.train(params, lgt.Dataset(X, label=y), 1, device=cuda_device)
    assert got.model_to_string() == want.model_to_string()


@pytest.mark.cuda
def test_card_max_bin_by_feature_iteration_matches_cpu_model_text(
        grown, cuda_device, tmp_path):
    """Features of 15, 63, 255 and 1,023 bins in one uint16 matrix, with
    forced bounds: the fused wave's uint16 mode on the card gives the CPU
    model text."""
    X, y = grown
    params = dict(EXACT, categorical_feature="", max_bin_by_feature=BY_FEATURE,
                  forcedbins_filename=_forced_bins_file(tmp_path))
    want = lgt.train(params, lgt.Dataset(X, label=y), 1, device="cpu")
    got = lgt.train(params, lgt.Dataset(X, label=y), 1, device=cuda_device)
    assert got._gbdt.bins_dev.dtype == torch.uint16
    assert got.model_to_string() == want.model_to_string()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "quantized"])
def test_card_max_bin_1023_iteration_matches_cpu_model_text(grown,
                                                            cuda_device,
                                                            quant):
    X, y = grown
    params = dict(QUANT if quant else EXACT, max_bin=1023)
    want = lgt.train(params, lgt.Dataset(X, label=y), 1, device="cpu")
    got = lgt.train(params, lgt.Dataset(X, label=y), 1, device=cuda_device)
    assert got._gbdt.bins_dev.dtype == torch.uint16
    assert got.model_to_string() == want.model_to_string()
