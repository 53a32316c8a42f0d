"""Generate tests/fixtures/torch_sampling_ref.json: the JAX package's
results for row / feature sampling, ``cv`` and learning to rank at the
geometries chip_smoke.py drives them (phases 43-47).

The card's machine has no JAX, so the numbers come from this script, run
once with the JAX package on the CPU:

    JAX_PLATFORMS=cpu python tools/gen_torch_sampling_fixture.py

- Sampling: ``bench.make_higgs_like(250,000, 28, seed 0)`` (the first
  200,000 rows train, the last 50,000 are held out) with
  tests/fixtures/bench_auc.json's params plus ``tpu_leaf_batch`` 16, 100
  iterations: bagging 0.7 every iteration with ``feature_fraction`` 0.8;
  GOSS with ``tpu_device_goss`` auto (the device sampler) and off (the
  host sampler); GOSS under ``use_quantized_grad``.  Each run records the
  holdout AUC after every iteration (a valid set, so every run takes the
  per-round path, as the port does).  The two runs whose masks the port
  draws as the JAX package does (bagging + ff, host GOSS) also run at
  ``bagging_seed`` = ``feature_fraction_seed`` = 1 to 8, and record each
  seed's last holdout AUC and their mean: one run's AUC moves by ~1e-3
  with the float32 summation order alone (the card's kernels sum in
  another order than the CPU), so the card is held to the mean.
- ``cv``: the 200,000 training rows, the same params, 5 stratified folds
  x 20 rounds, metric auc, seed 0: every round's ``valid auc-mean`` /
  ``-stdv``.
- Ranking: ``make_msltr_like(144,000, 137, 120, seed 0)`` (bench.py's
  generator, copied here without its disk cache): the first 1,000
  queries (120,000 rows) train, the last 200 (24,000 rows) are held out;
  bench.py's ``run_ltr_rung`` params (lambdarank, 255 leaves, learning
  rate 0.1, max_bin 255, min_data_in_leaf 0, min_sum_hessian_in_leaf 100,
  tpu_leaf_batch 16) with metric ndcg at eval_at 1, 3, 5 on the holdout:
  lambdarank 15 iterations, rank_xendcg 10.

Each seeded run also records its holdout AUC after every iteration
(``holdout_auc_history_by_seed``), so the card may run fewer iterations
and be held to the mean at the same iteration.  ``--seed-histories``
adds those histories to an existing fixture: it reruns only the seeded
runs, requires each run's last AUC to equal the stored one bit for bit,
and leaves every other value as it is (~30 min on 8 CPU cores).

chip_smoke.py carries copies of ``make_higgs_like`` and
``make_msltr_like``; keep them in step with this file.
"""

import argparse
import json
import os
import platform
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_TRAIN, N_VALID, F, SEED = 200_000, 50_000, 28, 0
CV_FOLDS, CV_ROUNDS = 5, 20
LTR_QUERIES, LTR_VALID_QUERIES, LTR_GROUP, LTR_F = 1_000, 200, 120, 137
EVAL_AT = [1, 3, 5]

#: (run name, extra params); 100 iterations each
SAMPLING_RUNS = [
    ("bagging_ff", {"bagging_fraction": 0.7, "bagging_freq": 1,
                    "feature_fraction": 0.8}),
    ("goss_device", {"data_sample_strategy": "goss",
                     "tpu_device_goss": "auto"}),
    ("goss_host", {"data_sample_strategy": "goss", "tpu_device_goss": "off"}),
    ("goss_quantized", {"data_sample_strategy": "goss",
                        "use_quantized_grad": True}),
]
SAMPLING_ITERS = 100
#: the runs also made at each of SAMPLING_SEEDS
SEEDED_RUNS = ("bagging_ff", "goss_host")
SAMPLING_SEEDS = tuple(range(1, 9))

#: (run name, objective, iterations)
RANKING_RUNS = [("lambdarank", "lambdarank", 15),
                ("rank_xendcg", "rank_xendcg", 10)]


def make_higgs_like(n, f, seed=0):
    """bench.make_higgs_like's draws, without its disk cache."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    w = rng.randn(f) / np.sqrt(f)
    logits = X @ w + 0.5 * np.sin(X[:, 0] * 2) * X[:, 1]
    p = 1 / (1 + np.exp(-logits))
    y = (rng.rand(n) < p).astype(np.float64)
    return X, y


def make_msltr_like(n, f, group, seed=0):
    """bench.make_msltr_like's draws, without its disk cache: fixed-size
    query groups, graded relevance 0-4 skewed to low grades."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    w = rng.randn(f) / np.sqrt(f)
    util = X @ w + 0.3 * rng.randn(n)
    cuts = np.quantile(util, [0.60, 0.80, 0.90, 0.97])
    y = np.searchsorted(cuts, util).astype(np.float64)
    groups = np.full(n // group, group, np.int64)
    rem = n - groups.sum()
    if rem:
        groups = np.concatenate([groups, [rem]])
    return X, y, groups


def bench_params():
    with open(os.path.join(ROOT, "tests", "fixtures", "bench_auc.json")) as fh:
        params = dict(json.load(fh)["params"])
    params.pop("num_iterations")
    params["tpu_leaf_batch"] = 16
    return params


def ltr_params(objective):
    return {"objective": objective, "num_leaves": 255, "learning_rate": 0.1,
            "max_bin": 255, "min_data_in_leaf": 0,
            "min_sum_hessian_in_leaf": 100.0, "verbosity": -1,
            "tpu_leaf_batch": 16, "metric": "ndcg", "eval_at": EVAL_AT}


def cpu_name():
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_sampling_ref.json")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed-histories", action="store_true",
                    help="add the seeded runs' per-iteration holdout AUCs "
                         "to the existing fixture, every other value kept")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import lightgbm_tpu as lgb
    t_all = time.perf_counter()
    X, y = make_higgs_like(N_TRAIN + N_VALID, F, SEED)
    Xt, Xv, yt, yv = X[:N_TRAIN], X[N_TRAIN:], y[:N_TRAIN], y[N_TRAIN:]
    base = dict(bench_params(), metric="auc")

    def sampled_run(params):
        ds = lgb.Dataset(Xt, label=yt)
        hist = {}
        t0 = time.perf_counter()
        bst = lgb.train(params, ds, SAMPLING_ITERS,
                        valid_sets=[lgb.Dataset(Xv, label=yv, reference=ds)],
                        valid_names=["holdout"],
                        callbacks=[lgb.record_evaluation(hist)])
        return (bst.num_trees(), [float(v) for v in hist["holdout"]["auc"]],
                time.perf_counter() - t0)

    def seeded(params):
        """The runs at each of SAMPLING_SEEDS: (last AUCs, histories)."""
        last, histories = [], []
        for seed in SAMPLING_SEEDS:
            _t, hs, sec = sampled_run(dict(
                params, bagging_seed=seed, feature_fraction_seed=seed))
            last.append(hs[-1])
            histories.append(hs)
            print(params.get("data_sample_strategy", "bagging"), "seed",
                  seed, hs[-1], f"{sec:.1f}s", flush=True)
        return last, histories

    if args.seed_histories:
        with open(FIXTURE) as fh:
            out = json.load(fh)
        for name in SEEDED_RUNS:
            run = out["sampling"][name]
            last, histories = seeded(run["params"])
            if last != run["holdout_auc_by_seed"]:
                raise SystemExit(f"{name}: the seeded runs' last AUCs {last} "
                                 f"differ from the fixture's "
                                 f"{run['holdout_auc_by_seed']}")
            run["holdout_auc_history_by_seed"] = histories
        with open(FIXTURE, "w") as fh:
            json.dump(out, fh, indent=1)
        print("->", FIXTURE, f"{time.perf_counter() - t_all:.1f}s")
        return

    sampling = {}
    for name, extra in SAMPLING_RUNS:
        params = dict(base, **extra)
        trees, history, seconds = sampled_run(params)
        sampling[name] = {"params": params, "iterations": SAMPLING_ITERS,
                          "trees": trees, "holdout_auc": history[-1],
                          "history": history, "cpu_seconds": seconds}
        print(name, history[-1], f"{seconds:.1f}s", flush=True)
        if name in SEEDED_RUNS:
            by_seed, histories = seeded(params)
            sampling[name].update(seeds=list(SAMPLING_SEEDS),
                                  holdout_auc_by_seed=by_seed,
                                  holdout_auc_history_by_seed=histories,
                                  holdout_auc_mean=float(np.mean(by_seed)))

    t0 = time.perf_counter()
    res = lgb.cv(dict(base), lgb.Dataset(Xt, label=yt), CV_ROUNDS,
                 nfold=CV_FOLDS, stratified=True, shuffle=True, seed=SEED)
    cv = {"params": dict(base), "nfold": CV_FOLDS, "rounds": CV_ROUNDS,
          "stratified": True, "seed": SEED,
          "auc_mean": [float(v) for v in res["valid auc-mean"]],
          "auc_stdv": [float(v) for v in res["valid auc-stdv"]],
          "cpu_seconds": time.perf_counter() - t0}
    print("cv", cv["auc_mean"][-1], cv["auc_stdv"][-1],
          f"{cv['cpu_seconds']:.1f}s", flush=True)

    nq = LTR_QUERIES + LTR_VALID_QUERIES
    Xr, yr, groups = make_msltr_like(nq * LTR_GROUP, LTR_F, LTR_GROUP, SEED)
    nt = int(groups[:LTR_QUERIES].sum())
    ranking = {}
    for name, objective, iters in RANKING_RUNS:
        params = ltr_params(objective)
        ds = lgb.Dataset(Xr[:nt], label=yr[:nt], group=groups[:LTR_QUERIES])
        dv = lgb.Dataset(Xr[nt:], label=yr[nt:],
                         group=groups[LTR_QUERIES:], reference=ds)
        hist = {}
        t0 = time.perf_counter()
        bst = lgb.train(params, ds, iters, valid_sets=[dv],
                        valid_names=["holdout"],
                        callbacks=[lgb.record_evaluation(hist)])
        seconds = time.perf_counter() - t0
        ndcg = {f"ndcg@{k}": float(hist["holdout"][f"ndcg@{k}"][-1])
                for k in EVAL_AT}
        ranking[name] = {"params": params, "iterations": iters,
                         "trees": bst.num_trees(), "holdout": ndcg,
                         "cpu_seconds": seconds}
        print(name, ndcg, f"{seconds:.1f}s", flush=True)

    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    out = {
        "description": "the JAX package's holdout metrics for row / feature "
                       "sampling, cv and learning to rank at chip_smoke.py's "
                       "geometries (see tools/gen_torch_sampling_fixture.py)",
        "data": {"generator": "bench.make_higgs_like's draws",
                 "seed": SEED, "n_train": N_TRAIN, "n_valid": N_VALID,
                 "n_features": F},
        "ltr_data": {"generator": "bench.make_msltr_like's draws",
                     "seed": SEED, "queries": LTR_QUERIES,
                     "valid_queries": LTR_VALID_QUERIES,
                     "group": LTR_GROUP, "n_features": LTR_F,
                     "n_train": nt, "n_valid": int(groups[LTR_QUERIES:].sum()),
                     "eval_at": EVAL_AT},
        "jax_commit": commit,
        "cpu": cpu_name(),
        "cpu_seconds": time.perf_counter() - t_all,
        "sampling": sampling,
        "cv": cv,
        "ranking": ranking,
    }
    with open(FIXTURE, "w") as fh:
        json.dump(out, fh, indent=1)
    print("->", FIXTURE, f"{out['cpu_seconds']:.1f}s")


if __name__ == "__main__":
    main()
