"""How far exclusive feature bundling moves the port's holdout AUC on the
one-hot data of chip_smoke.py's phase 52, over several data seeds, and
(with ``--jax``) where the port's unbundled trees part from the JAX
package's on that data.

    python tools/torch_efb_gap.py --seeds 0 1 2 3 4 \\
        --jax build/efb_jax_unbundled.json --out chiprun_out/efb_gap.json

For each seed: ``chip_smoke.make_onehot_airline_like(250,000, seed)``,
the first 200,000 rows binned once, then the f32 run bundled
(``enable_bundle`` at its default) and unbundled at the params of
tests/fixtures/torch_efb_ref.json for its 50 iterations, on the card
(``--device cpu`` with a small ``--rows`` rehearses it here).  Each line
gives both holdout AUC histories and the final gap, bundled minus
unbundled: what phase 52's bundled-vs-unbundled bar is set from.

``--jax`` reads the JAX package's unbundled model text and AUC history
on seed 0 (``JAX_PLATFORMS=cpu python tools/gen_torch_efb_fixture.py
--unbundled-model build/efb_jax_unbundled.json``, on the CPU) and
reports the first tree and node whose split differs from the port's
seed-0 unbundled run, with both splits' gains: whether the two part at
a near-tie; where they part in tree 0, its splits' float64 gains on
the leaf's rows and how the heaviest root bin of the port's split
feature sums in float32, row by row (the CPU order) and by the kernel.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def parse_trees(text):
    """Model text -> a list of per-tree dicts of numpy arrays (the
    ``key=v v v`` lines of each ``Tree=`` block)."""
    trees = []
    cur = None
    for line in text.splitlines():
        if line.startswith("Tree="):
            cur = {}
            trees.append(cur)
        elif cur is not None and "=" in line:
            key, val = line.split("=", 1)
            if key in ("split_feature", "threshold", "split_gain",
                       "decision_type", "leaf_value", "left_child",
                       "right_child", "internal_count"):
                cur[key] = np.array(val.split(), np.float64)
        elif line.startswith("end of trees"):
            break
    return trees


def first_parting(text_a, text_b, names=("port", "jax")):
    """The first (tree, node) whose split feature, threshold or decision
    type differ between two model texts, with both splits and their gains
    (under ``names``); and how far the leaf values of the trees before it
    differ."""
    pt, jt = parse_trees(text_a), parse_trees(text_b)
    leaf_rel = 0.0
    for t, (a, b) in enumerate(zip(pt, jt)):
        m = min(len(a.get("split_feature", ())),
                len(b.get("split_feature", ())))
        for j in range(m):
            if any(a[k][j] != b[k][j] for k in
                   ("split_feature", "threshold", "decision_type")):
                ga, gb = float(a["split_gain"][j]), float(b["split_gain"][j])
                return {
                    "tree": t, "node": j, "equal_nodes_before": j,
                    names[0]: {"feature": int(a["split_feature"][j]),
                               "threshold": float(a["threshold"][j]),
                               "gain": ga,
                               "count": float(a["internal_count"][j])},
                    names[1]: {"feature": int(b["split_feature"][j]),
                               "threshold": float(b["threshold"][j]),
                               "gain": gb,
                               "count": float(b["internal_count"][j])},
                    "gain_rel_gap": abs(ga - gb) / max(abs(gb), 1e-30),
                    "earlier_trees_leaf_value_max_rel_diff": leaf_rel}
        if len(a.get("split_feature", ())) != len(b.get("split_feature", ())):
            return {"tree": t, "node": m, "note": "node counts differ"}
        la, lb = a["leaf_value"], b["leaf_value"]
        leaf_rel = max(leaf_rel, float(np.max(
            np.abs(la - lb) / np.maximum(np.abs(lb), 1e-30))))
    return None


def node_rows(tree, node, X):
    """The rows (bool mask) that reach internal ``node`` of a parsed tree:
    ``x <= threshold`` goes left on its path (numerical splits only; the
    data hold no NaN)."""
    lc, rc = tree["left_child"].astype(int), tree["right_child"].astype(int)
    parent = {}
    for i in range(len(lc)):
        for c, left in ((lc[i], True), (rc[i], False)):
            if c >= 0:
                parent[c] = (i, left)
    mask = np.ones(X.shape[0], bool)
    n = node
    while n in parent:
        p, left = parent[n]
        go = X[:, int(tree["split_feature"][p])] <= tree["threshold"][p]
        mask &= go if left else ~go
        n = p
    return mask, parent.get(node)


def explain_parting(port_tree, jax_tree, node, X, y, bins, dev):
    """Tree 0's parting node, in float64 on its rows: the port's split and
    the JAX package's split of the same leaf (its child of the same
    parent), with iteration 0's gradients (p0 - y and p0 (1 - p0), p0 the
    mean label: binary logloss boosted from the average); and the port's
    split feature's heaviest root bin summed three ways: float64, float32
    in row order (``histogram_segment``, the plain version the CPU growers
    use, the JAX package's CPU order too) and by the kernel on ``dev``."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (histogram_from_vals,
                                                  histogram_segment)
    rows, up = node_rows(port_tree, node, X)
    p, left = up
    k = int((jax_tree["left_child"] if left else jax_tree["right_child"])[p])
    p0 = float(np.mean(y))
    g64 = p0 - y.astype(np.float64)
    h64 = np.full(len(y), p0 * (1.0 - p0))

    def split(tree, j):
        f, t = int(tree["split_feature"][j]), float(tree["threshold"][j])
        go = X[:, f] <= t
        sums = [(g64[rows & s].sum(), h64[rows & s].sum(), int((rows & s).sum()))
                for s in (go, ~go)]
        (gl, hl, nl), (gr, hr, nr) = sums
        gain = gl * gl / hl + gr * gr / hr - (gl + gr) ** 2 / (hl + hr)
        return {"node": j, "feature": f, "threshold": t,
                "text_gain": float(tree["split_gain"][j]),
                "float64_gain": gain, "left_rows": nl, "right_rows": nr,
                "left_hess": hl, "right_hess": hr}
    out = {"leaf_rows": int(rows.sum()), "port": split(port_tree, node),
           "jax_same_leaf": split(jax_tree, k) if k >= 0 else None}
    f = out["port"]["feature"]
    col = bins[:, f]
    heavy = int(np.bincount(col).argmax())
    r = col == heavy
    g32 = np.float32(p0) - y.astype(np.float32)
    h32 = np.full(len(y), np.float32(p0) * np.float32(1.0 - p0), np.float32)
    vals = torch.stack([torch.from_numpy(g32), torch.from_numpy(h32),
                        torch.ones(len(y))], dim=-1)
    seg = histogram_segment(torch.from_numpy(np.ascontiguousarray(
        col[:, None])), vals, num_bins=int(col.max()) + 1)[0, heavy]
    bias = {"feature": f, "bin": heavy, "rows": int(r.sum()),
            "float64_grad": float(g32[r].astype(np.float64).sum()),
            "float64_hess": float(h32[r].astype(np.float64).sum()),
            "row_order_f32": [float(seg[0]), float(seg[1])]}
    if dev.type == "cuda":
        kern = histogram_from_vals(
            torch.from_numpy(np.ascontiguousarray(bins)).to(dev),
            vals.to(dev), num_bins=int(bins.max()) + 1)[f, heavy].cpu()
        bias["kernel_f32"] = [float(kern[0]), float(kern[1])]
    out["heaviest_root_bin"] = bias
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--rows", type=int, default=None,
                    help="train rows (default the fixture's 200,000); a "
                         "quarter as many are held out")
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jax", default=None,
                    help="the JAX package's unbundled run on seed 0")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args(argv)

    import torch
    import lightgbm_tpu_torch as lgt
    from chip_smoke import make_onehot_airline_like, nvidia_smi_line
    with open(os.path.join(ROOT, "tests", "fixtures",
                           "torch_efb_ref.json")) as fh:
        ref = json.load(fh)
    params = dict(ref["params"])
    nt = args.rows or ref["data"]["n_train"]
    nv = ref["data"]["n_valid"] if args.rows is None else nt // 4
    iters = args.iterations or ref["iterations"]
    dev = torch.device(args.device)
    lines = [{"device": (nvidia_smi_line() if dev.type == "cuda"
                         else "cpu"),
              "params": params, "train_rows": nt, "holdout_rows": nv,
              "iterations": iters}]
    print(json.dumps(lines[0]), flush=True)
    for seed in args.seeds:
        X, y = make_onehot_airline_like(nt + nv, seed)
        ds = lgt.Dataset(X[:nt], label=y[:nt])
        valid = lgt.Dataset(X[nt:], label=y[nt:], reference=ds)
        t0 = time.perf_counter()
        ds.construct(dict(params))
        rec = {"seed": seed, "binning_s": time.perf_counter() - t0}
        texts = {}
        for name, extra in (("bundled", {}),
                            ("unbundled", {"enable_bundle": False})):
            hist = {}
            t0 = time.perf_counter()
            bst = lgt.train(dict(params, **extra), ds, iters, device=dev,
                            valid_sets=[valid], valid_names=["holdout"],
                            callbacks=[lgt.record_evaluation(hist)])
            rec[f"{name}_s"] = time.perf_counter() - t0
            rec[f"{name}_columns"] = int(bst._gbdt.bins_dev.shape[1])
            rec[f"{name}_history"] = [float(v)
                                      for v in hist["holdout"]["auc"]]
            texts[name] = bst.model_to_string()
        bh, uh = rec["bundled_history"], rec["unbundled_history"]
        rec["gap"] = bh[-1] - uh[-1]
        rec["max_abs_gap_over_iterations"] = float(np.max(np.abs(
            np.subtract(bh, uh))))
        if seed == 0 and args.jax:
            with open(args.jax) as fh:
                jax_run = json.load(fh)
            jh = jax_run["history"][:iters]
            rec["jax_unbundled_history"] = jh
            rec["port_minus_jax_unbundled"] = uh[len(jh) - 1] - jh[-1]
            same = [abs(a - b) <= 1e-9 for a, b in zip(uh, jh)]
            rec["first_iteration_auc_differs"] = (
                same.index(False) if not all(same) else None)
            rec["parting"] = first_parting(texts["unbundled"],
                                           jax_run["model"])
            if rec["parting"] and rec["parting"]["tree"] == 0:
                rec["parting_float64"] = explain_parting(
                    parse_trees(texts["unbundled"])[0],
                    parse_trees(jax_run["model"])[0],
                    rec["parting"]["node"], X[:nt], y[:nt],
                    ds.construct().binned.bins, dev)
            rec["bundled_vs_unbundled_parting"] = first_parting(
                texts["bundled"], texts["unbundled"],
                ("bundled", "unbundled"))
        lines.append(rec)
        print(json.dumps(rec), flush=True)
    gaps = [r["gap"] for r in lines[1:]]
    summary = {"gaps": gaps, "max_abs_gap": float(np.max(np.abs(gaps)))}
    lines.append(summary)
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            for rec in lines:
                fh.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
