"""Generate tests/fixtures/torch_efb_ref.json: the JAX package's holdout
AUCs and bundle layout on the one-hot data chip_smoke.py trains in phase
52 (exclusive feature bundling).

The card's machine has no JAX, so the numbers come from this script, run
once with the JAX package on the CPU:

    JAX_PLATFORMS=cpu python tools/gen_torch_efb_fixture.py

The rows are ``chip_smoke.make_onehot_airline_like(250,000, seed 0)``
(imported from there, so the recipe is one): the 28 higgs-like columns
plus the airports, carrier and month one-hot encoded, 660 features; the
first 200,000 rows train, the last 50,000 are held out.  The params are
tests/fixtures/bench_auc.json's (255 leaves, max_bin 255, learning rate
0.1, min_sum_hessian_in_leaf 100) plus ``tpu_leaf_batch`` 16, with
``enable_bundle`` at its default (on), for 50 iterations.  Three runs:
f32, quantized (``use_quantized_grad``, ``stochastic_rounding`` false)
and f32 with ``enable_bundle`` false.
Each records its holdout AUC after every iteration and its seconds; the
file also holds the bundle layout (column count, bins per column, the
SHA-256 of the bundled matrix's bytes) and the binning and bundling
seconds.

    JAX_PLATFORMS=cpu python tools/gen_torch_efb_fixture.py \
        --unbundled-model build/efb_jax_unbundled.json

runs only the unbundled run and writes its model text and holdout AUC
history to that path instead (the fixture is left as it is), for
``tools/torch_efb_gap.py --jax`` to find where the port's trees part
from the JAX package's.
"""

import argparse

import hashlib
import json
import os
import platform
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_TRAIN, N_VALID, SEED = 200_000, 50_000, 0
ITERS = 50
#: (run name, extra params)
RUNS = [("f32", {}),
        ("quantized", {"use_quantized_grad": True,
                       "stochastic_rounding": False}),
        ("unbundled", {"enable_bundle": False})]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--unbundled-model", default=None,
                    help="write the unbundled run's model text and AUC "
                         "history here instead of the fixture")
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import lightgbm_tpu as lgb
    from chip_smoke import make_onehot_airline_like
    with open(os.path.join(ROOT, "tests", "fixtures", "bench_auc.json")) as fh:
        bench = json.load(fh)
    params = dict(bench["params"], tpu_leaf_batch=16, metric="auc")
    params.pop("num_iterations")
    X, y = make_onehot_airline_like(N_TRAIN + N_VALID, SEED)
    Xt, yt, Xv, yv = X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:], y[N_TRAIN:]
    ds = lgb.Dataset(Xt, label=yt)
    t0 = time.perf_counter()
    ds.construct(params)
    binning_s = time.perf_counter() - t0
    out = {"description": (
        "the JAX package's holdout AUCs and EFB bundle layout on "
        "chip_smoke.make_onehot_airline_like (see "
        "tools/gen_torch_efb_fixture.py)"),
        "data": {"generator": "chip_smoke.make_onehot_airline_like",
                 "seed": SEED, "n_train": N_TRAIN, "n_valid": N_VALID,
                 "n_features": int(X.shape[1])},
        "params": params, "iterations": ITERS, "binning_s": binning_s,
        "runs": {}}
    runs = ([r for r in RUNS if r[0] == "unbundled"] if args.unbundled_model
            else RUNS)
    for name, extra in runs:
        hist = {}
        t0 = time.perf_counter()
        bst = lgb.train(dict(params, **extra), ds, ITERS,
                        valid_sets=[lgb.Dataset(Xv, label=yv, reference=ds)],
                        valid_names=["holdout"],
                        callbacks=[lgb.record_evaluation(hist)])
        seconds = time.perf_counter() - t0
        fb = bst._gbdt.bundles
        if fb is not None and "bundles" not in out:
            td = bst._gbdt.train_data
            t1 = time.perf_counter()
            from lightgbm_tpu.binning import build_bundles
            build_bundles(td.binned)
            out["bundling_s"] = time.perf_counter() - t1
            out["bundles"] = {
                "num_groups": fb.num_groups,
                "group_bins": [int(b) for b in fb.group_bins],
                "multi_member": int(sum(
                    (fb.feat_group == g).sum() > 1
                    for g in range(fb.num_groups))),
                "bins_dtype": str(fb.bins.dtype),
                "bins_sha256": hashlib.sha256(
                    fb.bins.tobytes()).hexdigest()}
        history = [float(v) for v in hist["holdout"]["auc"]]
        out["runs"][name] = {"extra": extra, "holdout_auc": history[-1],
                             "history": history, "cpu_seconds": seconds,
                             "trees": bst.num_trees()}
        print(name, history[-1], f"{seconds:.1f}s", flush=True)
        if args.unbundled_model:
            with open(args.unbundled_model, "w") as fh:
                json.dump({"params": dict(params, **extra),
                           "history": history,
                           "model": bst.model_to_string()}, fh)
            print("wrote", args.unbundled_model)
            return 0
    rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=ROOT,
                         capture_output=True, text=True).stdout.strip()
    out["made_with"] = {"commit": rev, "python": platform.python_version(),
                        "machine": platform.machine()}
    path = os.path.join(ROOT, "tests", "fixtures", "torch_efb_ref.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")
    print("wrote", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
