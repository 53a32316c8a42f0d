#!/usr/bin/env python3
"""Hold the port's training kernels against another build of them.

    python3 tools/torch_kernel_ab.py --other-csrc DIR [--label NAME]

Builds the CUDA sources in DIR (another commit's
``lightgbm_tpu_torch/ops/csrc``, unpacked with ``git archive``, or a
variant of this tree's) into a second library with the same C interface,
then runs both libraries through the same wrappers on the same seeded
inputs, in every mode of the histogram kernel (``ops/histogram_flat.py``)
and the fused-wave kernel (``ops/wave.py``) that both libraries have
(uint16 bins at B = 1,023; a wave mode the other library lacks is
skipped with a line that says so):

- equality: the histograms, the waves' child histograms and payloads,
  bit for bit (or the largest difference), on random values;
- time: CUDA events, mean of 20 launches (5 at 10.5M rows), in turns
  other, this, this, other, at the shapes of ``chip_smoke.py``'s timing
  phases (uint16 waves also at W = 1 x 12,500, the scan's fewest blocks,
  f32 at B = 511 and int8 at B = 2,047); and each wave's three launches
  by kernel name under ``torch.profiler``;
- code: where the toolkit has ``cuobjdump``, whether each kernel both
  libraries hold compiled to the same SASS instructions.

Needs one CUDA card and nvcc.  Prints one JSON line per case.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

#: the modes over uint8 and packed4 bins (the ones every build since the
#: fifth slice has), then over uint16 bins (the histogram's since the
#: seventh slice, the wave's since the eighth)
HIST_MODES = ("f32", "bf16", "int8", "f32_packed4", "bf16_packed4",
              "int8_packed4")
ALL_MODES = HIST_MODES + cs.U16_MODES


def build_other(csrc, label):
    """The sources in ``csrc`` built into their own library, bound with
    the port's ctypes signatures (those of its entry points it has: an
    older build lacks the uint16 ones)."""
    import ctypes
    from lightgbm_tpu_torch.ops import _build
    srcs = sorted(glob.glob(os.path.join(os.path.abspath(csrc), "*.cu")))
    if not srcs:
        raise SystemExit(f"no .cu sources in {csrc}")
    out_dir = os.path.join(_build.BUILD_DIR, f"ab_{label}")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "liblgbt_kernels.so")
    _build._compile(srcs, out_dir, lib_path)
    lib = ctypes.CDLL(lib_path)
    _build._bind(lib, only_present=True)
    return lib


@contextlib.contextmanager
def using(lib):
    """The wrappers launch from ``lib`` inside the block."""
    from lightgbm_tpu_torch.ops import _build
    _build.load_library()
    saved = _build._lib
    _build._lib = lib
    try:
        yield
    finally:
        _build._lib = saved


def diff(a, b):
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return {"equal": False, "reason": f"{a.dtype}{tuple(a.shape)} vs "
                f"{b.dtype}{tuple(b.shape)}"}
    eq = bool(torch.equal(a, b))
    d = (a.double() - b.double()).abs()
    d = d[torch.isfinite(d)]
    return {"equal": eq, "max_abs_diff": float(d.max()) if d.numel() else 0.0}


def sass_by_kernel(lib_path):
    """Each kernel's SASS instructions in the library at ``lib_path``
    (``cuobjdump -sass``), keyed by its mangled name less the per-build
    tag of the anonymous namespace; None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    kernels, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}",
                         "", m.group(1))
            kernels[cur] = []
            continue
        m = re.search(r"\*/\s+(.*?)\s*;", line)
        if cur is not None and m:
            kernels[cur].append(m.group(1))
    return kernels


def in_turns(fn, other, iters):
    """Mean ms of ``fn`` with the other library and this one, in turns
    other, this, this, other."""
    t = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        with using(other) if who == "other" else contextlib.nullcontext():
            t[who].append(cs.cuda_time_ms(fn, iters=iters))
    return {k: sum(v) / len(v) for k, v in t.items()}


def stage_ms_pair(fn, other):
    """Each library's device ms per launch by kernel name."""
    out = {}
    for who in ("other", "this"):
        with using(other) if who == "other" else contextlib.nullcontext():
            out[who] = cs.kernel_stage_ms(fn)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other-csrc", required=True)
    ap.add_argument("--label", default="other")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-large", action="store_true",
                    help="skip the 10.5M-row histograms")
    ap.add_argument("--modes", default=",".join(ALL_MODES),
                    help="comma-separated modes (default: all nine)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device visible", file=sys.stderr)
        return 2
    from lightgbm_tpu_torch.ops import histogram_flat as HF
    from lightgbm_tpu_torch.ops import wave as WV
    from lightgbm_tpu_torch.ops.split import SplitConfig
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    other = build_other(args.other_csrc, args.label)
    smi = cs.nvidia_smi_line()
    cs.emit({"phase": "ab_device", "nvidia_smi": smi,
             "kind": torch.cuda.get_device_name(0), "label": args.label,
             "other_csrc": args.other_csrc})
    from lightgbm_tpu_torch.ops import _build
    this_sass = sass_by_kernel(_build.load_library()._name)
    other_sass = sass_by_kernel(other._name)
    if this_sass is None or other_sass is None:
        cs.emit({"phase": "ab_sass", "compared": False,
                 "reason": "no cuobjdump"})
    else:
        both = sorted(set(this_sass) & set(other_sass))
        cs.emit({"phase": "ab_sass", "compared": True,
                 "kernels_in_both": len(both),
                 "same": [k for k in both if this_sass[k] == other_sass[k]],
                 "differ": [k for k in both
                            if this_sass[k] != other_sass[k]],
                 "only_this": sorted(set(this_sass) - set(other_sass))})
    sizes_h = (1, 20_000, 200_000) + (() if args.no_large else (10_500_000,))
    modes = args.modes.split(",")
    for mode in modes:
        packed4 = mode.endswith("packed4")
        for n in sizes_h:
            if mode.endswith("uint16"):
                b = cs.WIDE_MAX_BIN
                bins = cs.device_bins(gen, n, 28, b, dev)
            else:
                bins, b = cs.mode_bins(gen, n, 28, mode, dev)
            vals = cs.mode_vals(gen, n, mode, dev, exact=False)
            kw = dict(num_bins=b, packed4=packed4, features=28 if packed4
                      else 0)
            fn = lambda: HF.histogram_flat(bins, vals, **kw)
            with using(other):
                want = fn()
            got = fn()
            torch.cuda.synchronize()
            rec = {"phase": "ab_histogram", "mode": mode, "rows": n,
                   "bins": b, **diff(got, want)}
            if n >= 200_000:
                rec["ms"] = in_turns(fn, other, 20 if n <= 200_000 else 5)
                rec["stage_ms"] = stage_ms_pair(fn, other)
            cs.emit(rec)
            del bins, vals, got, want
        torch.cuda.empty_cache()
    cfg = SplitConfig(min_data_in_leaf=0, min_sum_hessian_in_leaf=1.0,
                      lambda_l2=0.5, max_cat_to_onehot=4)
    timing = list(cs.WAVE_TIMING_SIZES)
    for mode in modes:
        packed4 = mode.endswith("packed4")
        wide = mode.endswith("uint16")
        if wide and not hasattr(other, "lgbt_wave_u16"):
            cs.emit({"phase": "ab_wave", "mode": mode, "skipped":
                     "the other library has no uint16 wave"})
            continue
        scales = None
        if mode.startswith("int8"):
            r = torch.rand(2, generator=gen, device=dev) * 0.02 + 1e-3
            scales = (float(r[0]), float(r[1]), 1.0)
        b = cs.WIDE_MAX_BIN if wide else 16 if packed4 else 255
        # name: (sizes, inactive slots, bins, timed)
        waves = {k: (sizes, inactive, b, False)
                 for k, (sizes, inactive) in cs.CHECK_WAVES.items()}
        waves["timing"] = (timing, (), b, True)
        if wide:
            waves["timing_W1"] = (timing[:1], (), b, True)
            extra = {"f32_uint16": 511, "int8_uint16": 2047}.get(mode)
            if extra:
                waves[f"timing_B{extra}"] = (timing, (), extra, True)
        for name, (sizes, inactive, b, timed) in waves.items():
            inp = cs.wave_case(gen, dev, sizes, exact=False, b=b,
                               inactive=inactive, scales=scales,
                               mode=mode.split("_")[0] if wide else mode)
            fn = lambda: WV.fused_wave_call(cfg=cfg, **inp)
            with using(other):
                h0, p0 = fn()
            h1, p1 = fn()
            torch.cuda.synchronize()
            rec = {"phase": "ab_wave", "mode": mode, "wave": name,
                   "slots": len(sizes), "rows": sum(sizes), "bins": b,
                   "hist": diff(h1, h0), "payload": diff(p1, p0)}
            if timed:
                rec["ms"] = in_turns(fn, other, 20)
                rec["stage_ms"] = stage_ms_pair(fn, other)
            cs.emit(rec)
            del inp, h0, p0, h1, p1
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
