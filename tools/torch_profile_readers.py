"""Read one ``torch.profiler`` session of the port's training both ways
and show that the two readers give the same numbers.

``chip_smoke.py`` reads its profiles from the raw kineto events
(``chip_smoke.profiler_events``); ``prof.events()`` is torch's own
reader, which builds a Python tree of every event first.  This script
trains ``chip_smoke.make_airline_like``'s rows (phase 51's data and
params: sorted many-vs-many categorical splits at the bench params) for
3 iterations, profiles 5 more, and reads that one session with each
reader through ``chip_smoke.read_profile``: the host ms per iteration of
every ``gbdt/*`` / ``grower/*`` range and the device-busy share must
agree to 1e-9 relative.  It prints the card's name and power limit, then
one JSON line with both readings, their seconds and event counts, and
exits 1 where they disagree.  Needs a CUDA card:

    python tools/torch_profile_readers.py [--rows 250000]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def tree_events(prof):
    """``chip_smoke.profiler_events``' tuples, read through
    ``prof.events()``."""
    return [(ev.name, "cuda" in str(ev.device_type).lower(),
             ev.time_range.start, ev.time_range.end) for ev in prof.events()]


def close(a, b, rel=1e-9):
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-30)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=250_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    import lightgbm_tpu_torch as lgt
    if not torch.cuda.is_available():
        print("torch_profile_readers: no CUDA device visible", file=sys.stderr)
        return 2
    print(cs.nvidia_smi_line())
    dev = torch.device("cuda")
    with open(os.path.join(ROOT, cs.CAT_FIXTURE)) as fh:
        params = dict(json.load(fh)["params"])
    X, y, cats = cs.make_airline_like(args.rows, args.seed)
    nt = args.rows * 4 // 5
    ds = lgt.Dataset(X[:nt], label=y[:nt], categorical_feature=cats)
    ds.construct(params)
    warmup, iters = 3, 5
    prof, wall = cs.profile_training(params, ds, dev, warmup, iters)
    readings = {}
    for name, reader in (("raw", cs.profiler_events), ("tree", tree_events)):
        t0 = time.perf_counter()
        events = reader(prof)
        sec = time.perf_counter() - t0
        readings[name] = {"read_s": sec, "events": len(events),
                          "device_events": sum(e[1] for e in events),
                          **cs.read_profile(events, wall, warmup, iters)}
    a, b = (readings[k] for k in ("raw", "tree"))
    ra, rb = (r["range_host_ms_per_iteration"] for r in (a, b))
    same = (set(ra) == set(rb) and all(close(ra[k], rb[k]) for k in ra)
            and close(a["device_busy_share"], b["device_busy_share"])
            and close(a["device_busy_ms_per_iteration"],
                      b["device_busy_ms_per_iteration"]))
    print(json.dumps({"tool": "torch_profile_readers", "rows": args.rows,
                      "same": same, "readings": readings}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
