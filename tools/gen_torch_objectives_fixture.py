"""Generate tests/fixtures/torch_objectives_ref.json: the JAX package's
holdout metrics for every non-ranking objective at the bench config.

The PyTorch port's smoke run on the card (chip_smoke.py, phases 32-37)
holds its regression, multiclass and other objectives to these numbers.
The card's machine has no JAX, so the numbers come from this script,
run once with the JAX package on the CPU:

    JAX_PLATFORMS=cpu python tools/gen_torch_objectives_fixture.py

Data: ``objective_data`` replays ``bench.make_higgs_like(250,000, 28,
seed 0)``'s draws, so X is the bench's X.  With ``t`` its logit and ``u``
its uniform draw (the binary label is ``u < sigmoid(t)``):

- regression family (l2, l1, huber, fair, quantile, mape): ``t + u - 0.5``;
- multiclass (softmax and one-vs-all), 4 classes:
  ``digitize(t - logit(u), [-1, 0, 1])`` with ``u`` clipped to
  [1e-12, 1 - 1e-12], so class >= 2 exactly where the binary label is 1;
- gamma: ``exp(t) * e`` with ``e = -log(1 - u)`` (an Exp(1) draw);
  poisson and tweedie: ``floor(exp(t) * e)`` (counts, zeros included);
- cross_entropy and cross_entropy_lambda: ``sigmoid(t)``.

The first 200,000 rows train and the last 50,000 are held out, with
tests/fixtures/bench_auc.json's params plus ``tpu_leaf_batch`` 16.  Each
run records its holdout metrics after every iteration (the valid set's
f32 scores, as ``record_evaluation`` sees them).  chip_smoke.py carries a
copy of ``objective_data``; keep the two in step.
"""

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
NUM_CLASS = 4

#: (run name, objective, extra params, iterations, metrics)
RUNS = [
    ("l2", "regression", {}, 100, ["l2"]),
    ("l2_quantized", "regression", {"use_quantized_grad": True}, 100,
     ["l2"]),
    ("l1", "regression_l1", {}, 20, ["l1"]),
    ("multiclass", "multiclass", {"num_class": NUM_CLASS}, 100,
     ["multi_logloss", "multi_error"]),
    ("huber", "huber", {}, 10, ["huber"]),
    ("fair", "fair", {}, 10, ["fair"]),
    ("poisson", "poisson", {}, 10, ["poisson"]),
    ("quantile", "quantile", {}, 10, ["quantile"]),
    ("mape", "mape", {}, 10, ["mape"]),
    ("gamma", "gamma", {}, 10, ["gamma"]),
    ("tweedie", "tweedie", {}, 10, ["tweedie"]),
    ("multiclassova", "multiclassova", {"num_class": NUM_CLASS}, 10,
     ["multi_logloss", "multi_error"]),
    ("cross_entropy", "cross_entropy", {}, 10, ["cross_entropy"]),
    ("cross_entropy_lambda", "cross_entropy_lambda", {}, 10,
     ["cross_entropy_lambda"]),
]


def objective_data(n, f, seed=0):
    """(X, labels by label family): make_higgs_like(n, f, seed)'s X and
    the labels above, from the same draws."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    w = rng.randn(f) / np.sqrt(f)
    t = X @ w + 0.5 * np.sin(X[:, 0] * 2) * X[:, 1]
    u = rng.rand(n)
    uc = np.clip(u, 1e-12, 1 - 1e-12)
    e = -np.log1p(-uc)
    scale = np.exp(t)
    counts = np.floor(scale * e)
    labels = {
        "regression": t + u - 0.5,
        "multiclass": np.digitize(t - np.log(uc / (1 - uc)),
                                  [-1.0, 0.0, 1.0]).astype(np.float64),
        "gamma": scale * e,
        "count": counts,
        "probability": 1.0 / (1.0 + np.exp(-t)),
    }
    return X, labels


#: objective -> its label family in ``objective_data``
LABEL_OF = {
    "regression": "regression", "regression_l1": "regression",
    "huber": "regression", "fair": "regression", "quantile": "regression",
    "mape": "regression", "multiclass": "multiclass",
    "multiclassova": "multiclass", "gamma": "gamma", "poisson": "count",
    "tweedie": "count", "cross_entropy": "probability",
    "cross_entropy_lambda": "probability",
}


def base_params():
    with open(os.path.join(ROOT, "tests", "fixtures", "bench_auc.json")) as fh:
        params = dict(json.load(fh)["params"])
    params.pop("num_iterations")
    params.pop("objective")
    params["tpu_leaf_batch"] = 16
    return params


def cpu_name():
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import lightgbm_tpu as lgb
    X, labels = objective_data(N_TRAIN + N_VALID, F, SEED)
    Xt, Xv = X[:N_TRAIN], X[N_TRAIN:]
    base = base_params()
    runs = {}
    for name, objective, extra, iters, metrics in RUNS:
        y = labels[LABEL_OF[objective]]
        yt, yv = y[:N_TRAIN], y[N_TRAIN:]
        params = dict(base, objective=objective, metric=metrics, **extra)
        ds = lgb.Dataset(Xt, label=yt)
        hist = {}
        t0 = time.perf_counter()
        bst = lgb.train(params, ds, iters,
                        valid_sets=[lgb.Dataset(Xv, label=yv, reference=ds)],
                        valid_names=["holdout"],
                        callbacks=[lgb.record_evaluation(hist)])
        seconds = time.perf_counter() - t0
        history = {m: [float(v) for v in hist["holdout"][m]]
                   for m in metrics}
        runs[name] = {"objective": objective, "params": params,
                      "iterations": iters, "trees": bst.num_trees(),
                      "label": LABEL_OF[objective],
                      "holdout": {m: h[-1] for m, h in history.items()},
                      "history": history, "cpu_seconds": seconds}
        print(name, runs[name]["holdout"], f"{seconds:.1f}s", flush=True)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    out = {
        "description": "the JAX package's holdout metrics for every "
                       "non-ranking objective at the bench config (see "
                       "tools/gen_torch_objectives_fixture.py)",
        "data": {"generator": "tools/gen_torch_objectives_fixture.py::"
                              "objective_data (bench.make_higgs_like's "
                              "draws)",
                 "seed": SEED, "n_train": N_TRAIN, "n_valid": N_VALID,
                 "n_features": F, "num_class": NUM_CLASS},
        "jax_commit": commit,
        "cpu": cpu_name(),
        "runs": runs,
    }
    path = os.path.join(ROOT, "tests", "fixtures", "torch_objectives_ref.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print("->", path)


if __name__ == "__main__":
    main()
