#!/usr/bin/env python3
"""Time the port's training against another checkout of it, in turns.

    python3 tools/torch_train_ab.py --other ROOT [--label NAME]
                                    [--iters 100]

ROOT is another commit's tree (``git archive <commit> | tar -x -C
build/parent``; ``build/`` is git-ignored).  Each turn runs in its own
process that imports ``lightgbm_tpu_torch`` from one tree (other, this,
this, other) and trains ``chip_smoke.py``'s bench runs on the same
seeded rows (``tests/fixtures/bench_auc.json``: 200,000 rows x 28
features, 255 leaves, tpu_leaf_batch 16): f32 and quantized at max_bin
255, and f32 through the fused uint16 wave at max_bin 1023.  Each turn
prints one JSON line: seconds an iteration (host clock, synchronized),
binning seconds and holdout AUC; the last line gathers them by tree.

Needs one CUDA card (each tree builds its own kernels) and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: name -> (extra params, max_bin)
RUNS = {"f32": ({}, 255), "quantized": ({"use_quantized_grad": True}, 255),
        "max_bin_1023_fused_f32": ({}, 1023)}


def _chip_smoke():
    """This tree's chip_smoke module (its data generator and fixture
    reader; it imports the port only inside its functions)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: str, label: str, iters: int) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.metrics import auc
    assert os.path.dirname(os.path.dirname(
        os.path.abspath(lgt.__file__))) == os.path.abspath(tree)
    cs = _chip_smoke()
    fix = cs.load_bench_fixture(ROOT)
    X, y = cs.bench_rows(fix)
    nt = fix["data"]["n_train"]
    out = {"label": label, "tree": tree, "iterations": iters,
           "s_per_iteration": {}, "binning_s": {}, "holdout_auc": {}}
    datasets = {}
    for name, (extra, max_bin) in RUNS.items():
        params = dict(fix["params"], tpu_leaf_batch=16, max_bin=max_bin,
                      **extra)
        params.pop("num_iterations")
        if max_bin not in datasets:
            t0 = time.perf_counter()
            ds = lgt.Dataset(X[:nt], label=y[:nt])
            ds.construct(params)
            datasets[max_bin] = ds
            out["binning_s"][str(max_bin)] = time.perf_counter() - t0
        lgt.train(params, datasets[max_bin], 2, device="cuda")  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = lgt.train(params, datasets[max_bin], iters, device="cuda")
        torch.cuda.synchronize()
        out["s_per_iteration"][name] = (time.perf_counter() - t0) / iters
        out["holdout_auc"][name] = auc(y[nt:], bst.predict(
            X[nt:], raw_score=True))
        del bst
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--label", default="other")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.label, args.iters)),
              flush=True)
        return 0
    other = os.path.abspath(args.other)
    results = []
    for tree, label in ((other, args.label), (ROOT, "this"), (ROOT, "this"),
                        (other, args.label)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--other", other,
             "--worker", tree, "--label", label, "--iters", str(args.iters)],
            capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    summary = {"nvidia_smi": smi, "turns": [r["label"] for r in results]}
    for label in (args.label, "this"):
        runs = [r for r in results if r["label"] == label]
        summary[label] = {name: [r["s_per_iteration"][name] for r in runs]
                          for name in RUNS}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
