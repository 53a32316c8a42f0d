"""Time the port's EFB bundling (``lightgbm_tpu_torch/binning.py::
build_bundles``) against another checkout's, on chip_smoke.py's phase-52
data: ``make_onehot_airline_like(250,000, seed 0)``'s first 200,000 rows,
660 features, binned once at max_bin 255.

    git archive <commit> | tar -x -C build/parent
    python tools/torch_bundles_ab.py [--other build/parent] [--repeat 2]

Prints one JSON line: the binning seconds, each tree's bundling seconds
(alternating, this tree first), and whether both form the same
multi-member bundles (an older checkout returns the member lists; this
one returns ``FeatureBundles``).  Runs on the host CPU: bundling is host
numpy.
"""

import argparse
import importlib.util
import json
import os
import platform
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def load_binning(checkout: str, name: str):
    """``lightgbm_tpu_torch/binning.py`` of ``checkout`` as module
    ``name`` (its relative import of ``utils.log`` resolves to this
    tree's package)."""
    path = os.path.join(checkout, "lightgbm_tpu_torch", "binning.py")
    spec = importlib.util.spec_from_file_location(
        f"lightgbm_tpu_torch.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def members(result):
    """Sorted multi-member bundles of either return form."""
    if result is None:
        return None
    if isinstance(result, list):
        return sorted(sorted(b) for b in result)
    groups = [np.nonzero(result.feat_group == g)[0].tolist()
              for g in range(result.num_groups)]
    return sorted(sorted(g) for g in groups if len(g) > 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", default=None,
                    help="another checkout's root (e.g. build/parent)")
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args()
    from chip_smoke import make_onehot_airline_like
    import lightgbm_tpu_torch.binning as here
    X, _y = make_onehot_airline_like(250_000, 0)
    X = X[:200_000]
    t0 = time.perf_counter()
    binned = here.bin_dataset(X, max_bin=255)
    binning_s = time.perf_counter() - t0
    trees = {"this": here}
    if args.other:
        trees["other"] = load_binning(args.other, "_other_binning")
    seconds = {k: [] for k in trees}
    found = {}
    for _ in range(args.repeat):
        for name, mod in trees.items():
            t0 = time.perf_counter()
            found[name] = mod.build_bundles(binned)
            seconds[name].append(time.perf_counter() - t0)
    fb = found["this"]
    out = {"rows": int(X.shape[0]), "features": int(X.shape[1]),
           "binning_s": binning_s, "bundling_s": seconds,
           "columns": fb.num_groups if fb is not None else None,
           "cpu": platform.processor() or platform.machine()}
    if args.other:
        out["same_bundles"] = (members(found["this"])
                               == members(found["other"]))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
