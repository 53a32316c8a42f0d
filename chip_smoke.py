#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Drives the port's main path — quantized serving through the hand-written
CUDA traversal kernel — at the full width of the bench's headline ensemble
(binary, 28 features, max_bin 255, 500 trees of 255 leaves; weights random
from the seed), and holds every result against an independent reference:

1. device: the card, its power limit and the CUDA version;
2. build: the kernels, built with nvcc from ops/csrc (seconds, and the
   ptxas register / shared-memory report);
3. model: a higgs-like matrix binned by the port, 500 random trees, int16
   and int8 packs; and a small categorical model;
4. kernel vs its plain PyTorch version on the card, bitwise, for both
   models and both packs at N in {1, 33, 4096, 65536};
5. device binning vs the port's host binning, bitwise, on 65,536 rows with
   NaN, zero-as-missing and categorical edge values;
6. serving: Predictor requests of 1, 7, 256, 4096 and 65,536 rows, each
   equal bit for bit to a vectorized numpy walk of the same pack, one
   transformed request within 1e-6 of the float32 sigmoid, and exactly one
   kernel launch per request;
7. timing: kernel and plain-version times with CUDA events, and the bound.

Each phase prints one JSON line; any mismatch raises, so the process exits
non-zero without the final ``{"ok": true, ...}`` line.  Exits non-zero when
no CUDA device is visible, or when the port's package is not beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12      # H100 SXM non-tensor 32-bit rate (data sheet)
TRAVERSE_REPLACES = ("lightgbm_tpu/ops/pallas_traverse.py:179 "
                     "(fused_traverse_call)")
TRAVERSE_SOURCE = "lightgbm_tpu_torch/ops/csrc/traverse.cu"


# --------------------------------------------------------------- data, model
def make_higgs_like(n, f, seed=0):
    """bench.py's higgs-like generator (without its disk cache)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    w = rng.randn(f) / np.sqrt(f)
    logits = X @ w + 0.5 * np.sin(X[:, 0] * 2) * X[:, 1]
    p = 1 / (1 + np.exp(-logits))
    y = (rng.rand(n) < p).astype(np.float64)
    return X, y


def random_tree(rng, num_leaves, num_bins, cat_features, max_bins):
    """One leaf-wise tree: each split takes a random leaf, a random feature
    and a random bin below that feature's bin count (a random left set for
    a categorical feature), a random default_left, leaves from N(0, 0.1)."""
    m = num_leaves - 1
    sf = np.zeros(m, np.int32)
    sb = np.zeros(m, np.int32)
    dl = np.zeros(m, bool)
    ic = np.zeros(m, bool)
    cat_mask = np.zeros((m, max_bins), bool)
    lc = np.zeros(m, np.int32)
    rc = np.zeros(m, np.int32)
    parent, side = [-1], [0]           # per leaf: its parent node and side
    for k in range(m):
        j = rng.randint(k + 1)
        feat = rng.randint(len(num_bins))
        nb = int(num_bins[feat])
        sf[k] = feat
        if feat in cat_features:
            ic[k] = True
            cat_mask[k, :nb] = rng.rand(nb) < 0.5
        else:
            sb[k] = rng.randint(max(nb - 1, 1))
        dl[k] = rng.rand() < 0.5
        if parent[j] >= 0:
            (lc if side[j] == 0 else rc)[parent[j]] = k
        lc[k], rc[k] = ~j, ~(k + 1)
        parent[j], side[j] = k, 0
        parent.append(k)
        side.append(1)
    return {"split_feature": sf, "split_bin": sb, "default_left": dl,
            "is_cat": ic, "cat_mask": cat_mask, "left_child": lc,
            "right_child": rc, "leaf_value": rng.normal(0, 0.1, num_leaves),
            "num_leaves": num_leaves}


def random_model_state(rng, binned, num_trees, num_leaves, cat_features=()):
    from lightgbm_tpu_torch.binning import mappers_to_arrays
    trees = [random_tree(rng, num_leaves, binned.num_bins_per_feature,
                         set(cat_features), binned.max_num_bins)
             for _ in range(num_trees)]
    return {"mappers": mappers_to_arrays(binned.mappers), "trees": [trees],
            "init_scores": np.array([rng.normal(0, 0.5)]), "num_class": 1,
            "objective": "binary", "sigmoid": 1.0, "num_leaves": num_leaves}


def categorical_data(rng, n):
    """6 features; 1 and 4 categorical with vocabularies of about 40."""
    X = rng.randn(n, 6)
    X[:, 1] = rng.randint(0, 40, n)
    X[:, 4] = rng.randint(0, 45, n)
    X[rng.rand(n, 6) < 0.03] = np.nan
    return X


def walk_pack_numpy(pack, bins, nan_bins):
    """Independent vectorized numpy walk of a quantized pack (the algorithm
    of tests/test_serve_quantize.py::_walk_pack_numpy, over all rows at
    once).  Returns (int64 quanta sums, total node visits)."""
    sf = pack["split_feature"].cpu().numpy().astype(np.int64)
    sb = pack["split_bin"].cpu().numpy().astype(np.int64)
    dl = pack["default_left"].cpu().numpy()
    ic = pack["is_cat"].cpu().numpy()
    cb = pack["cat_bits"].cpu().numpy().astype(np.int64)
    lc = pack["left_child"].cpu().numpy().astype(np.int64)
    rc = pack["right_child"].cpu().numpy().astype(np.int64)
    lq = pack["leaf_q"].cpu().numpy().astype(np.int64)
    bins = np.asarray(bins, np.int64)
    nan_bins = np.asarray(nan_bins, np.int64)
    n = bins.shape[0]
    acc = np.zeros(n, np.int64)
    visits = 0
    for ti in range(sf.shape[0]):
        rows = np.arange(n)
        node = np.zeros(n, np.int64)
        while rows.size:
            visits += rows.size
            nd = node
            f = sf[ti, nd]
            col = bins[rows, f]
            go_left = np.where(
                ic[ti, nd], ((cb[ti, nd, col >> 3] >> (col & 7)) & 1) > 0,
                np.where(col == nan_bins[f], dl[ti, nd], col <= sb[ti, nd]))
            nxt = np.where(go_left, lc[ti, nd], rc[ti, nd])
            leaf = nxt < 0
            acc[rows[leaf]] += lq[ti, ~nxt[leaf]]
            rows, node = rows[~leaf], nxt[~leaf]
    return acc, visits


def device_binning_rows(binned, X, rng, n):
    """n rows drawn from X, with edge values planted: bound values, +-0.0,
    NaN, tiny values around the zero-as-missing window, and for
    categorical features fractions, negatives, unseen and >= 2^31 values."""
    rows = X[rng.randint(0, X.shape[0], n)].astype(np.float64)
    edge_num = [0.0, -0.0, np.nan, 1e-36, -1e-36, 1e-35, -1e-35, 5e-324,
                -5e-324, 1e300, -1e300]
    edge_cat = [3.7, -0.5, -0.0, -3.0, 777.0, 2.0 ** 31 + 5, 2.0 ** 31 - 1,
                1e300, np.nan, 0.999, 39.0, 40.0]
    for j, m in enumerate(binned.mappers):
        if m.is_categorical:
            pool = np.asarray(edge_cat + list(m.categories[:5]), np.float64)
        else:
            pool = np.asarray(edge_num + list(m.upper_bounds[:-1][:50]),
                              np.float64)
        pick = rng.rand(n) < 0.2
        rows[pick, j] = pool[rng.randint(0, len(pool), int(pick.sum()))]
    return rows


# ------------------------------------------------------------------ helpers
def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def cuda_time_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def request_breakdown(pred, X, rng, n=65_536, repeats=5):
    """Host-clock split of one dense request's steps, replayed one by one
    with a device sync after each (median over ``repeats``): the inf scan,
    the bit view and ladder pad, the host-to-device copy, device binning,
    the traversal and dequantization, and the copy back with init scores
    — next to the whole ``Predictor.predict`` call."""
    import torch
    from lightgbm_tpu_torch.models.tree import forest_scores_quantized
    from lightgbm_tpu_torch.serve.device_binning import (bin_rows_device,
                                                         float_bits)
    from lightgbm_tpu_torch.serve.predictor import _reject_inf_rows
    plan = pred.plan
    rows = X[rng.randint(0, X.shape[0], n)]
    steps = {k: [] for k in ("inf_scan", "bits_and_pad", "h2d", "binning",
                             "traverse", "d2h_and_init", "predict_total")}
    for _ in range(repeats):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        _reject_inf_rows(rows)
        t.append(time.perf_counter())
        bits, _padded = plan._pad(float_bits(rows), n)
        t.append(time.perf_counter())
        dbits = torch.from_numpy(bits).to(plan.device)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        bins = bin_rows_device(plan._tables, dbits)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        scores = forest_scores_quantized(plan._packs, bins, plan._nan_bins)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        plan._finish(scores, n)
        t.append(time.perf_counter())
        pred.predict(rows)
        t.append(time.perf_counter())
        for k, a, b in zip(steps, t[:-1], t[1:]):
            steps[k].append((b - a) * 1e3)
    return {"rows": n, **{k: float(np.median(v)) for k, v in steps.items()}}


# -------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the data and the random weights")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lightgbm_tpu_torch import Predictor, bin_dataset, model_from_arrays
    from lightgbm_tpu_torch.models.tree import (_ensemble_sum_q, pack_nbytes,
                                                quantize_stack_trees)
    from lightgbm_tpu_torch.ops import _build, traverse
    from lightgbm_tpu_torch.serve.device_binning import (bin_rows_device,
                                                         build_bin_tables,
                                                         float_bits)
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    rng = np.random.RandomState(args.seed)

    # 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    _build.load_library()
    info = _build.build_info
    emit({"phase": "build", "seconds": info["seconds"],
          "built": info["built"], "sources": info["sources"],
          "ptxas": [ln.strip() for ln in info["ptxas"].splitlines()
                    if ln.strip()]})

    # 3. models
    t0 = time.perf_counter()
    X, _y = make_higgs_like(200_000, 28, args.seed)
    X = X.astype(np.float64)
    X[rng.rand(*X.shape) < 0.02] = np.nan
    binned = bin_dataset(X, max_bin=255)
    state = random_model_state(rng, binned, 500, 255)
    model = model_from_arrays(state)
    Xc = categorical_data(rng, 20_000)
    binned_c = bin_dataset(Xc, max_bin=255, categorical_features=[1, 4])
    model_c = model_from_arrays(
        random_model_state(rng, binned_c, 50, 31, cat_features=(1, 4)))
    models = {"full": (model, binned, X), "categorical": (model_c, binned_c,
                                                          Xc)}
    packs = {}
    for name, (mdl, bnd, _x) in models.items():
        trees = mdl.host_trees()[0]
        for mode in ("int16", "int8"):
            packs[name, mode] = quantize_stack_trees(
                trees, mdl.cfg.num_leaves, bnd.max_num_bins, mode, dev)
    full16 = packs["full", "int16"]
    emit({"phase": "model", "seconds": time.perf_counter() - t0,
          "rows": int(X.shape[0]), "features": int(X.shape[1]),
          "max_num_bins": int(binned.max_num_bins), "trees": 500,
          "leaves": 255, "depth": full16["depth"],
          "pack_bytes_int16": pack_nbytes(full16),
          "pack_bytes_int8": pack_nbytes(packs["full", "int8"]),
          "categorical_model": {"trees": 50, "leaves": 31,
                                "categorical_features": [1, 4]}})

    # 4. kernel vs plain version, bitwise
    checks = []
    for (name, mode), pack in packs.items():
        _mdl, bnd, xs = models[name]
        nanb = torch.as_tensor(bnd.nan_bins, dtype=torch.int32, device=dev)
        for n in (1, 33, 4096, 65536):
            idx = rng.randint(0, xs.shape[0], n)
            bins = torch.from_numpy(bnd.apply(xs[idx]).astype(np.int32)).to(
                dev)
            got = traverse.fused_class_sums(pack, bins, nanb)
            want = _ensemble_sum_q(pack, bins, nanb)
            torch.cuda.synchronize()
            require(torch.equal(got, want),
                    f"kernel != plain version: {name} {mode} N={n}")
            checks.append(f"{name}/{mode}/{n}")
    emit({"phase": "kernel_vs_plain", "bitwise": True, "cases": checks})

    # 5. device binning vs host binning, bitwise
    zam_x = rng.randn(20_000, 3)
    zam_x[rng.rand(20_000, 3) < 0.3] = 0.0
    binned_z = bin_dataset(zam_x, max_bin=255, zero_as_missing=True)
    cases = {}
    for name, (bnd, xs) in {"full": (binned, X), "categorical": (binned_c, Xc),
                            "zero_as_missing": (binned_z, zam_x)}.items():
        rows = device_binning_rows(bnd, xs, rng, 65_536)
        tables = build_bin_tables(bnd.mappers, dev)
        got = bin_rows_device(tables, torch.from_numpy(float_bits(rows)).to(
            dev)).cpu().numpy()
        want = bnd.apply(rows).astype(np.int32)
        require(np.array_equal(got, want),
                f"device binning != host binning ({name}): "
                f"{int((got != want).sum())} cells differ")
        cases[name] = int(rows.shape[0])
    emit({"phase": "device_binning", "bitwise": True, "rows": cases})

    # 6. serving through the entry points, one kernel launch per request
    pred = Predictor(model, quantize="int16", raw_score=True)
    pred_p = Predictor(model, quantize="int16")
    plan_pack = pred.plan._packs[0]
    scale = np.float32(plan_pack["scale"])
    nan_bins = binned.nan_bins
    requests = []
    traverse.launches = 0
    answers = []
    for n in (1, 7, 256, 4096, 65_536):
        rows = X[rng.randint(0, X.shape[0], n)]
        t1 = time.perf_counter()
        out = pred.predict(rows)
        requests.append({"rows": n, "ms": (time.perf_counter() - t1) * 1e3})
        answers.append((rows, out))
    rows_p = X[rng.randint(0, X.shape[0], 4096)]
    t1 = time.perf_counter()
    prob = pred_p.predict(rows_p)
    requests.append({"rows": 4096, "ms": (time.perf_counter() - t1) * 1e3,
                     "transformed": True})
    torch.cuda.synchronize()
    serve_launches = traverse.launches
    require(serve_launches == len(requests),
            f"{serve_launches} kernel launches for {len(requests)} requests")
    init = model.init_scores[0]
    for rows, out in answers:
        acc, _ = walk_pack_numpy(plan_pack, binned.apply(rows), nan_bins)
        want = (acc.astype(np.int32).astype(np.float32) * scale).astype(
            np.float64) + init
        require(out.shape == want.shape and np.array_equal(out, want),
                f"served raw scores != numpy walk at N={rows.shape[0]}")
    acc, _ = walk_pack_numpy(plan_pack, binned.apply(rows_p), nan_bins)
    raw32 = ((acc.astype(np.int32).astype(np.float32) * scale).astype(
        np.float64) + init).astype(np.float32)
    want_p = 1.0 / (1.0 + np.exp(-raw32))
    err_p = float(np.abs(prob - want_p).max())
    require(err_p <= 1e-6, f"served probabilities off by {err_p}")
    emit({"phase": "serve", "requests": requests, "launches": serve_launches,
          "raw_bitwise": True, "prob_max_abs_err": err_p,
          "metrics": pred.metrics_snapshot()})

    # 7. timing at the serving shape
    timing = {}
    pack_bytes = pack_nbytes(full16)
    nanb = torch.as_tensor(nan_bins, dtype=torch.int32, device=dev)
    host_bins = binned.apply(X).astype(np.int32)
    for n in (65_536, 1_048_576):
        idx = rng.randint(0, X.shape[0], n)
        bins = torch.from_numpy(host_bins[idx]).to(dev)
        ms = cuda_time_ms(lambda: traverse.fused_class_sums(full16, bins,
                                                            nanb),
                          iters=20 if n <= 65_536 else 5)
        nbytes = bins.numel() * 4 + pack_bytes + n * 4
        entry = {"kernel_ms": ms, "bytes": nbytes,
                 "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        if n <= 65_536:
            _acc, visits = walk_pack_numpy(full16, host_bins[idx], nan_bins)
            entry["node_visits"] = visits
            entry["ops_ms"] = visits / SCALAR_OPS_PER_S * 1e3
            entry["plain_ms"] = cuda_time_ms(
                lambda: _ensemble_sum_q(full16, bins, nanb), iters=2,
                warmup=1)
            entry["max_abs_err"] = int((traverse.fused_class_sums(
                full16, bins, nanb) - _ensemble_sum_q(
                    full16, bins, nanb)).abs().max())
        timing[str(n)] = entry
    emit({"phase": "timing", "trees": 500, "leaves": 255, "features": 28,
          "pack_bytes": pack_bytes, "launches_per_request": 1,
          "nvidia_smi": smi, "shapes": timing,
          "request_breakdown_ms": request_breakdown(pred, X, rng)})

    t65 = timing["65536"]
    bound_ms = max(t65["bytes_ms"], t65["ops_ms"])
    emit({"kernels": [{
        "name": "traverse", "route": "cuda", "source": TRAVERSE_SOURCE,
        "replaces": TRAVERSE_REPLACES, "matches_plain": True,
        "launches": serve_launches, "max_abs_err": t65["max_abs_err"],
        "ms": t65["kernel_ms"], "plain_ms": t65["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": ("bytes" if t65["bytes_ms"] >= t65["ops_ms"]
                     else "operations"),
        "library_ms": None, "rows": 65_536}]})
    print(f"wall_s={time.perf_counter() - t_start:.1f}", flush=True)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
