"""Generate tests/fixtures/torch_categorical_ref.json: the JAX package's
holdout AUCs on the categorical data chip_smoke.py trains in phase 48.

The card's machine has no JAX, so the numbers come from this script, run
once with the JAX package on the CPU:

    JAX_PLATFORMS=cpu python tools/gen_torch_categorical_fixture.py

The rows are ``chip_smoke.make_airline_like(250,000, seed 0)`` (imported
from there, so the recipe is one): the 28 higgs-like columns plus two
300-category airports, a 20-category carrier and a 12-category month; the
first 200,000 rows train, the last 50,000 are held out.  The params are
tests/fixtures/bench_auc.json's (255 leaves, max_bin 255, learning rate
0.1, min_sum_hessian_in_leaf 100, 100 iterations) plus ``tpu_leaf_batch``
16, the categorical keys at their defaults (the airports and the carrier
take the sorted many-vs-many scan, the month one-hot).  Three runs: f32,
quantized (``use_quantized_grad``, ``stochastic_rounding`` false) and
f32 at ``max_cat_to_onehot`` 256 (every categorical feature one-hot).
Each records its last holdout AUC, its seconds and the largest category
set of its trees.
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

N_TRAIN, N_VALID, SEED = 200_000, 50_000, 0
ITERS = 100
#: (run name, extra params)
RUNS = [("f32", {}),
        ("quantized", {"use_quantized_grad": True,
                       "stochastic_rounding": False}),
        ("onehot", {"max_cat_to_onehot": 256})]


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import lightgbm_tpu as lgb
    from chip_smoke import AIRLINE_COLUMNS, make_airline_like
    with open(os.path.join(ROOT, "tests", "fixtures", "bench_auc.json")) as fh:
        bench = json.load(fh)
    params = dict(bench["params"], tpu_leaf_batch=16, metric="auc")
    params.pop("num_iterations")
    X, y, cat_cols = make_airline_like(N_TRAIN + N_VALID, SEED)
    Xt, yt, Xv, yv = X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:], y[N_TRAIN:]
    out = {"description": (
        "the JAX package's holdout AUCs on chip_smoke.make_airline_like "
        "(see tools/gen_torch_categorical_fixture.py)"),
        "data": {"generator": "chip_smoke.make_airline_like", "seed": SEED,
                 "n_train": N_TRAIN, "n_valid": N_VALID,
                 "categorical_columns": cat_cols,
                 "columns": [list(c) for c in AIRLINE_COLUMNS]},
        "params": params, "iterations": ITERS, "runs": {}}
    ds = lgb.Dataset(Xt, label=yt, categorical_feature=cat_cols)
    for name, extra in RUNS:
        hist = {}
        t0 = time.perf_counter()
        bst = lgb.train(dict(params, **extra), ds, ITERS,
                        valid_sets=[lgb.Dataset(Xv, label=yv, reference=ds)],
                        valid_names=["holdout"],
                        callbacks=[lgb.record_evaluation(hist)])
        seconds = time.perf_counter() - t0
        sizes = [int(np.asarray(t.cat_mask[i]).sum())
                 for t in bst._gbdt.host_trees()[0]
                 for i in range(t.num_leaves - 1) if bool(t.is_cat[i])]
        history = [float(v) for v in hist["holdout"]["auc"]]
        out["runs"][name] = {"extra": extra, "holdout_auc": history[-1],
                             "history": history, "cpu_seconds": seconds,
                             "max_set_size": max(sizes, default=0),
                             "categorical_nodes": len(sizes)}
        print(name, history[-1], f"{seconds:.1f}s", max(sizes, default=0),
              flush=True)
    rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=ROOT,
                         capture_output=True, text=True).stdout.strip()
    out["made_with"] = {"commit": rev, "python": platform.python_version(),
                        "machine": platform.machine()}
    path = os.path.join(ROOT, "tests", "fixtures",
                        "torch_categorical_ref.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")
    print("wrote", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
