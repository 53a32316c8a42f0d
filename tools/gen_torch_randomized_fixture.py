"""Generate tests/fixtures/torch_randomized_ref.json: the JAX package's
holdout AUCs under ``extra_trees`` and ``feature_fraction_bynode`` at the
geometry chip_smoke.py's phase 60 trains them.

The card's machine has no JAX, so the numbers come from this script, run
once with the JAX package on the CPU:

    JAX_PLATFORMS=cpu python tools/gen_torch_randomized_fixture.py

Data and params are phase 10's: ``bench.make_higgs_like(250,000, 28,
seed 0)`` (the first 200,000 rows train, the last 50,000 are held out),
tests/fixtures/bench_auc.json's params plus ``tpu_leaf_batch`` 16.  Three
configurations, each at seeds k = 1-4 with ``extra_seed`` =
``feature_fraction_seed`` = k: ``extra_trees``; ``feature_fraction_bynode``
0.5; ``extra_trees`` under ``use_quantized_grad`` with
``stochastic_rounding`` false.  Each run takes ``ITERATIONS`` iterations
(50: the bench's 100 cut for this CPU's time) and records its last
holdout AUC; each configuration the seeds' mean and sample standard
deviation s.

The port draws its per-node randomness from a host ``torch.Generator``,
the JAX package from ``jax.random``: no one run can be compared, only the
mean over seeds.  The bar the card is held to is written here, before any
card run: the port's mean over the same four seeds within ``max(floor,
3 s / sqrt(4))`` of the JAX mean, ``floor`` 1e-3 in f32 and 3e-3
quantized (the bars of phase 10's AUCs).
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
ITERATIONS = 50
SEEDS = (1, 2, 3, 4)
#: (run name, extra params, the bar's floor)
RUNS = [
    ("extra_trees", {"extra_trees": True}, 1e-3),
    ("bynode", {"feature_fraction_bynode": 0.5}, 1e-3),
    ("extra_trees_quantized", {"extra_trees": True,
                               "use_quantized_grad": True,
                               "stochastic_rounding": False}, 3e-3),
]


def make_higgs_like(n, f, seed=0):
    """bench.make_higgs_like's draws, without its disk cache."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    w = rng.randn(f) / np.sqrt(f)
    logits = X @ w + 0.5 * np.sin(X[:, 0] * 2) * X[:, 1]
    p = 1 / (1 + np.exp(-logits))
    y = (rng.rand(n) < p).astype(np.float64)
    return X, y


def bench_params():
    with open(os.path.join(ROOT, "tests", "fixtures", "bench_auc.json")) as fh:
        params = dict(json.load(fh)["params"])
    params.pop("num_iterations")
    params["tpu_leaf_batch"] = 16
    return params


def bar(std, floor, n):
    """The card's bar: ``max(floor, 3 s / sqrt(n))``."""
    return max(floor, 3.0 * std / np.sqrt(n))


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
    t_all = time.perf_counter()
    X, y = make_higgs_like(N_TRAIN + N_VALID, F, SEED)
    Xt, Xv, yt, yv = X[:N_TRAIN], X[N_TRAIN:], y[:N_TRAIN], y[N_TRAIN:]
    base = dict(bench_params(), metric="auc")
    runs = {}
    for name, extra, floor in RUNS:
        aucs, secs = [], []
        for seed in SEEDS:
            params = dict(base, **extra, extra_seed=seed,
                          feature_fraction_seed=seed)
            ds = lgb.Dataset(Xt, label=yt)
            hist = {}
            t0 = time.perf_counter()
            lgb.train(params, ds, ITERATIONS,
                      valid_sets=[lgb.Dataset(Xv, label=yv, reference=ds)],
                      valid_names=["holdout"],
                      callbacks=[lgb.record_evaluation(hist)])
            secs.append(time.perf_counter() - t0)
            aucs.append(float(hist["holdout"]["auc"][-1]))
            print(name, seed, aucs[-1], f"{secs[-1]:.1f}s", flush=True)
        std = float(np.std(aucs, ddof=1))
        runs[name] = {"extra": extra, "seeds": list(SEEDS),
                      "holdout_auc_by_seed": aucs,
                      "holdout_auc_mean": float(np.mean(aucs)),
                      "holdout_auc_std": std, "bar_floor": floor,
                      "bar": bar(std, floor, len(SEEDS)),
                      "cpu_seconds": secs}
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    out = {
        "description": "the JAX package's holdout AUCs under extra_trees and "
                       "feature_fraction_bynode at chip_smoke.py phase 60's "
                       "geometry (see tools/gen_torch_randomized_fixture.py)",
        "data": {"generator": "bench.make_higgs_like's draws",
                 "seed": SEED, "n_train": N_TRAIN, "n_valid": N_VALID,
                 "n_features": F},
        "params": dict(base),
        "iterations": ITERATIONS,
        "cut": "50 iterations, not the bench's 100: the CPU run's time",
        "bar_rule": "the port's mean holdout AUC over the same seeds within "
                    "max(bar_floor, 3 * holdout_auc_std / sqrt(len(seeds))) "
                    "of holdout_auc_mean",
        "jax_commit": commit,
        "cpu": cpu_name(),
        "cpu_seconds": time.perf_counter() - t_all,
        "runs": runs,
    }
    path = os.path.join(ROOT, "tests", "fixtures",
                        "torch_randomized_ref.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print("->", path, f"{out['cpu_seconds']:.1f}s")


if __name__ == "__main__":
    main()
