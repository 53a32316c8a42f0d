"""Time the port's sorted categorical merge alone on the card: one
``ops/wave.py::merge_sorted_payload`` call on a wave's children.

The shape is one wave of phase 48's training at leaf_batch 16: 32
children, 32 features of which ``--sorted`` take the sorted scan, 255
bins, the bench's ``min_sum_hessian_in_leaf`` 100.  The histograms are
exact sums (integer counts, gradients in halves, hessians in quarters),
so the card's payload must equal the CPU's bit for bit.  It prints the
card's name and power limit, then one JSON line: the host ms per call
(synchronised wall clock over 20 calls after 3 warm-up calls), the
device ms per call from CUDA events, and the device launches of one call
as ``torch.profiler`` records them (``chip_smoke.profiler_events``).
Needs a CUDA card:

    python tools/torch_sorted_merge_bench.py [--sorted 4]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

K, F, B = 32, 32, 255


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sorted", type=int, default=4)
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from lightgbm_tpu_torch.ops.split import SplitConfig
    from lightgbm_tpu_torch.ops.wave import (PAYLOAD_SCALARS,
                                             merge_sorted_payload)
    if not torch.cuda.is_available():
        print("torch_sorted_merge_bench: no CUDA device visible",
              file=sys.stderr)
        return 2
    print(cs.nvidia_smi_line())
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    cnt = torch.randint(0, 400, (K, F, B), generator=g).float()
    grad = torch.randint(-400, 400, (K, F, B), generator=g) * 0.5
    hist = torch.stack([grad * (cnt > 0), cnt * 0.25, cnt], -1)
    stats = torch.zeros(K, 8)
    stats[:, :3] = hist[:, 0].sum(1)
    stats[:, 3] = -stats[:, 0] / (stats[:, 1] + 1)
    stats[:, 5] = 1.0
    pay = torch.zeros(K, PAYLOAD_SCALARS + B)
    pay[:, 0] = float("-inf")
    feats = torch.arange(F - args.sorted, F)
    kw = dict(features=feats, num_bins_per_feature=torch.full((F,), B),
              feature_mask=torch.ones(F, dtype=torch.bool),
              cfg=SplitConfig(min_data_in_leaf=0,
                              min_sum_hessian_in_leaf=100.0))
    sub = hist.index_select(1, feats)
    want = merge_sorted_payload(pay, sub, stats, **kw)
    on = lambda t: t.to(dev) if torch.is_tensor(t) else t
    dkw = {k: on(v) for k, v in kw.items()}
    dpay, dsub, dstats = on(pay), on(sub), on(stats)
    run = lambda: merge_sorted_payload(dpay, dsub, dstats, **dkw)
    got = run().cpu()
    equal = torch.equal(got, want)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.calls):
        run()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / args.calls * 1e3
    event_ms = cs.cuda_time_ms(run, args.calls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    launches = sum(on_dev for _, on_dev, _, _ in cs.profiler_events(prof))
    print(json.dumps({"tool": "torch_sorted_merge_bench", "children": K,
                      "features": F, "sorted_features": args.sorted,
                      "bins": B, "equal_to_cpu": equal,
                      "host_ms_per_call": host_ms,
                      "event_ms_per_call": event_ms,
                      "device_launches_per_call": launches,
                      "wins": int((got[:, 4] > 0.5).sum())}))
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
