"""How far the port's seeded sampling runs sit from the JAX package's at a
given iteration: chip_smoke.py phase 43's bagging + feature_fraction and
host-GOSS configurations, each at tests/fixtures/torch_sampling_ref.json's
seeds, trained for ``--iterations`` and held, as a mean over the seeds,
to the fixture's mean at that iteration (its
``holdout_auc_history_by_seed``).

    python tools/torch_sampling_gap.py --iterations 50 --device cpu \\
        --threads 4 --runs goss_host

On the card (the default device) it takes phase 43's own geometry; on
the CPU it draws other float32 sums, so its gap is one more sample of
the same seed noise, not the card's.  One JSON line a run, then one a
configuration with the mean gap and phase 43's bar.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iterations", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", type=int, default=None,
                    help="torch host threads (default torch's own)")
    ap.add_argument("--runs", nargs="+", default=["bagging_ff", "goss_host"])
    args = ap.parse_args(argv)

    import torch
    import chip_smoke as cs
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.metrics import auc
    if args.threads:
        torch.set_num_threads(args.threads)
    with open(os.path.join(ROOT, cs.SAMPLING_FIXTURE)) as fh:
        ref = json.load(fh)
    bars = {name: bar for name, _extra, _mode, bar in cs.SAMPLING_RUNS}
    fix = cs.load_bench_fixture(ROOT)
    rows = cs.bench_rows(fix)
    X, y = rows
    nt = fix["data"]["n_train"]
    ds, _ = cs.bench_dataset(fix, rows, fix["params"]["max_bin"])
    dev = torch.device(args.device)
    it = args.iterations
    for name in args.runs:
        want = ref["sampling"][name]
        params = {k: v for k, v in want["params"].items()
                  if k not in ("metric", "num_iterations")}
        got, jax = [], []
        for seed, hist in zip(want["seeds"],
                              want["holdout_auc_history_by_seed"]):
            t0 = time.perf_counter()
            bst = lgt.train(dict(params, bagging_seed=seed,
                                 feature_fraction_seed=seed), ds, it,
                            device=dev)
            got.append(float(auc(y[nt:], bst.predict(X[nt:]))))
            jax.append(hist[it - 1])
            print(json.dumps({"run": name, "seed": seed, "iterations": it,
                              "holdout_auc": got[-1], "jax": jax[-1],
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        print(json.dumps({"run": name, "device": str(dev), "iterations": it,
                          "mean": float(np.mean(got)),
                          "jax_mean": float(np.mean(jax)),
                          "mean_gap": float(np.mean(got) - np.mean(jax)),
                          "bar": bars[name]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
