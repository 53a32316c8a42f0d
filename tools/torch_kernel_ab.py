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

The int8 modes are also timed at W = 1 and 4 x 12,500 and on hot-bin
rows (``chip_smoke.I8_HOT_PATTERNS``); an other library of the first
int8 design (slices 1-9) runs under the chunking its own wrappers used
(at least 2,048 rows a chunk), any other under this tree's.  The
traversal kernel (``ops/csrc/traverse.cu``) is held against the other
library's at the serving width (500 trees of 255 leaves, F = 28, int16
and int8 packs) at 1, 4,096, 65,536 and 1,048,576 rows: bit for bit,
in turns, and device ms by launch; an other library of the first design
(``lgbt_traverse_sums``) is launched as its wrapper launched it.

Needs one CUDA card and nvcc.  Prints one JSON line per case.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
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


class NoNodeTable:
    """A library built before the wave kernel took a node table (slices
    1-17) behind this tree's wave entry points: the node table argument
    (``_build.NODE_ARG``) is dropped, and must be None (the default path,
    the one this tool times)."""

    def __init__(self, lib):
        from lightgbm_tpu_torch.ops._build import NODE_ARG, SIGNATURES
        self._lib = lib
        self._name = lib._name
        for name, i in NODE_ARG.items():
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = SIGNATURES[name][:i] + SIGNATURES[name][i + 1:]

    def __getattr__(self, name):
        from lightgbm_tpu_torch.ops._build import NODE_ARG
        fn = getattr(self._lib, name)
        if name not in NODE_ARG:
            return fn
        i = NODE_ARG[name]

        def call(*args):
            if args[i] is not None:
                raise ValueError(f"{self._name} takes no node table")
            return fn(*args[:i], *args[i + 1:])
        return call


class FirstDesignInt8(NoNodeTable):
    """A library of slices 1-9 behind this tree's int8 entry points: its
    kernels chose their own block layout (the ``fpb`` and ``tile``
    arguments are dropped) and added into a zeroed output with global
    atomics, so its histograms take no chunk-partial scratch (the
    ``partial`` argument is dropped) and its waves take W smaller-sibling
    histograms as scratch (allocated here); every other entry point is
    the library's own, its waves without the node table (NoNodeTable)."""

    @staticmethod
    def _hist(args):
        """A histogram's arguments without fpb, tile (7, 8) and partial
        (3rd from the end)."""
        return (*args[:7], *args[9:-3], *args[-2:])

    @staticmethod
    def _wave(args):
        """A wave's arguments without fpb and tile (9, 10) and the node
        table (14)."""
        return (*args[:9], *args[11:14], *args[15:])

    def __init__(self, lib):
        from lightgbm_tpu_torch.ops._build import SIGNATURES
        super().__init__(lib)
        for name in ("lgbt_histogram_i8", "lgbt_histogram_i8_u16",
                     "lgbt_wave_i8", "lgbt_wave_i8_u16"):
            drop = self._wave if "wave" in name else self._hist
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = list(drop(SIGNATURES[name]))

    def lgbt_histogram_i8(self, *args):
        return self._lib.lgbt_histogram_i8(*self._hist(args))

    def lgbt_histogram_i8_u16(self, *args):
        return self._lib.lgbt_histogram_i8_u16(*self._hist(args))

    def _siblings(self, args):
        """The wave's arguments without fpb and tile, and with ``small``
        (4th from the end) replaced by W * F * B * 3 int32 (f, nbins and w
        are arguments 3, 4 and 6), kept alive on the instance."""
        import torch
        if args[14] is not None:
            raise ValueError(f"{self._name} takes no node table")
        args = self._wave(args)
        f, nbins, w = args[3], args[4], args[6]
        self._small = torch.empty(w * f * nbins * 3, dtype=torch.int32,
                                  device="cuda")
        return (*args[:-4], self._small.data_ptr(), *args[-3:])

    def lgbt_wave_i8(self, *args):
        return self._lib.lgbt_wave_i8(*self._siblings(args))

    def lgbt_wave_i8_u16(self, *args):
        return self._lib.lgbt_wave_i8_u16(*self._siblings(args))


def build_other(csrc, label):
    """The sources in ``csrc`` built into their own library, bound with
    the port's ctypes signatures (those of its entry points it has: an
    older build lacks the uint16 ones; one of the first traversal and
    int8 design, slices 1-9, is wrapped in FirstDesignInt8, one whose
    wave takes no node table, slices 10-17, in NoNodeTable)."""
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
    if hasattr(lib, "lgbt_traverse_sums"):
        return FirstDesignInt8(lib)
    if not hasattr(lib, "lgbt_wave_node_table"):
        return NoNodeTable(lib)
    return lib


def first_design_int8_rows():
    """The int8 chunking of the wrappers of slices 3-9: chunks of at least
    2,048 rows, a histogram in at most 264 chunks, a wave's siblings
    together in at most 1,024."""
    from lightgbm_tpu_torch.ops import histogram_flat as HF
    return {
        "histogram": lambda rows, *_: HF.chunking(
            rows, min_rows=2048, max_chunks=264)[0],
        "wave": lambda rows, *_: HF.chunking(rows, min_rows=2048)[0]}


@contextlib.contextmanager
def using(lib):
    """The wrappers launch from ``lib`` inside the block (a library of
    the first int8 design under its own wrappers' int8 chunking)."""
    from lightgbm_tpu_torch.ops import _build
    from lightgbm_tpu_torch.ops import histogram_flat as HF
    from lightgbm_tpu_torch.ops import wave as WV
    _build.load_library()
    saved = _build._lib, HF.int8_chunk_rows, WV.int8_chunk_rows
    _build._lib = lib
    if isinstance(lib, FirstDesignInt8):
        rows = first_design_int8_rows()
        HF.int8_chunk_rows, WV.int8_chunk_rows = (rows["histogram"],
                                                  rows["wave"])
    try:
        yield
    finally:
        _build._lib, HF.int8_chunk_rows, WV.int8_chunk_rows = saved


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


def hot_histograms(mode, other, gen, dev, n=200_000):
    """An int8 mode's histogram at n rows on hot-bin rows (each of
    ``chip_smoke.I8_HOT_PATTERNS``): bit for bit the other library's,
    timed in turns."""
    import torch
    from lightgbm_tpu_torch.ops import histogram_flat as HF
    from lightgbm_tpu_torch.ops.histogram import pack_bins4
    packed4 = mode.endswith("packed4")
    b = cs.WIDE_MAX_BIN if mode.endswith("uint16") else 16 if packed4 \
        else 255
    for pattern in cs.I8_HOT_PATTERNS:
        bins = cs.hot_bins(cs.device_bins(gen, n, 28, b, dev), pattern, b)
        if packed4:
            bins = pack_bins4(bins)
        vals = cs.device_levels(gen, n, dev)
        fn = lambda: HF.histogram_flat(bins, vals, num_bins=b,
                                       packed4=packed4,
                                       features=28 if packed4 else 0)
        with using(other):
            want = fn()
        got = fn()
        torch.cuda.synchronize()
        cs.emit({"phase": "ab_histogram", "mode": mode, "rows": n,
                 "bins": b, "pattern": pattern, **diff(got, want),
                 "ms": in_turns(fn, other, 20),
                 "stage_ms": stage_ms_pair(fn, other)})
        del bins, vals, got, want


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


def serving_packs(dev, seed=0):
    """chip_smoke.py's serving model at full width (500 random trees of
    255 leaves over 28 higgs-like features, 2% NaN, binned to 255 bins):
    its int16 and int8 packs, the binned rows and the NaN bins."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch import bin_dataset, model_from_arrays
    from lightgbm_tpu_torch.models.tree import quantize_stack_trees
    rng = np.random.RandomState(seed)
    X, _ = cs.make_higgs_like(20_000, 28, seed)
    X = X.astype(np.float64)
    X[rng.rand(*X.shape) < 0.02] = np.nan
    binned = bin_dataset(X, max_bin=255)
    model = model_from_arrays(cs.random_model_state(rng, binned, 500, 255))
    trees = model.host_trees()[0]
    packs = {mode: quantize_stack_trees(trees, 255, binned.max_num_bins,
                                        mode, dev)
             for mode in ("int16", "int8")}
    nanb = torch.as_tensor(binned.nan_bins, dtype=torch.int32, device=dev)
    return packs, binned.apply(X).astype(np.int32), nanb


def first_design_traverse(lib, pack, bins, nan_bins):
    """The traversal launch of slices 1-9 (``lgbt_traverse_sums``: a
    thread per row over the pack's node arrays, blocks of 128 rows, the
    tree axis split until there are 8 blocks an SM)."""
    import torch
    fn = lib.lgbt_traverse_sums
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p,
                                             ctypes.c_int64]
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    n, f = bins.shape
    t, m = pack["split_feature"].shape
    sms = torch.cuda.get_device_properties(bins.device).multi_processor_count
    split = max(1, min(t, -(-sms * 8 // max(-(-n // 128), 1))))
    tpb = max(-(-t // split), -(-t // 65535), 1)
    split = -(-t // tpb)
    out = (torch.zeros if split > 1 else torch.empty)(
        n, dtype=torch.int32, device=bins.device)
    leaf = pack["leaf_q"]
    err = fn(bins.data_ptr(), nan_bins.data_ptr(),
             *[pack[k].data_ptr() for k in (
                 "split_feature", "split_bin", "default_left", "is_cat",
                 "cat_bits", "left_child", "right_child")],
             leaf.data_ptr(), 8 * leaf.element_size(), out.data_ptr(), n, f,
             t, m, int(pack["cat_bits"].shape[2]), int(leaf.shape[1]),
             int(pack["depth"]), tpb, 128,
             torch.cuda.current_stream(bins.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"first-design traverse launch: CUDA error {err}")
    return out


def traverse_ab(other, dev, gen):
    """The traversal kernel against the other library's, at the serving
    width, int16 and int8 packs."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops import traverse
    packs, host_bins, nanb = serving_packs(dev)
    rng = np.random.RandomState(1)
    first = hasattr(other, "lgbt_traverse_sums")
    for mode, pack in packs.items():
        for n in (1, 4096, 65_536, 1_048_576):
            bins = torch.from_numpy(host_bins[rng.randint(
                0, host_bins.shape[0], n)]).to(dev)
            this_fn = lambda: traverse.fused_class_sums(pack, bins, nanb)
            if first:
                other_fn = lambda: first_design_traverse(other, pack, bins,
                                                         nanb)
            else:
                def other_fn():
                    with using(other):
                        return traverse.fused_class_sums(pack, bins, nanb)
            want, got = other_fn(), this_fn()
            torch.cuda.synchronize()
            iters = 5 if n > 65_536 else 20
            t = {"other": [], "this": []}
            for who in ("other", "this", "this", "other"):
                t[who].append(cs.cuda_time_ms(
                    other_fn if who == "other" else this_fn, iters=iters))
            cs.emit({"phase": "ab_traverse", "pack": mode, "rows": n,
                     "trees": int(pack["leaf_q"].shape[0]),
                     "other_first_design": first, **diff(got, want),
                     "ms": {k: sum(v) / len(v) for k, v in t.items()},
                     "device_ms": {
                         "other": cs.named_kernel_ms(other_fn, "traverse"),
                         "this": cs.named_kernel_ms(this_fn, "traverse")}})
            del bins, want, got


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other-csrc", required=True)
    ap.add_argument("--label", default="other")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-large", action="store_true",
                    help="skip the 10.5M-row histograms")
    ap.add_argument("--modes", default=",".join(ALL_MODES),
                    help="comma-separated modes (default: all nine)")
    ap.add_argument("--no-traverse", action="store_true",
                    help="skip the traversal kernel")
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
    if not args.no_traverse:
        traverse_ab(other, dev, gen)
    sizes_h = (1, 20_000, 200_000) + (() if args.no_large else (10_500_000,))
    modes = [m for m in args.modes.split(",") if m]
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
        if mode.startswith("int8"):
            hot_histograms(mode, other, gen, dev)
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
        if mode.startswith("int8"):
            for w in (1, 4):
                waves[f"timing_W{w}"] = (timing[:w], (), b, True)
            for p in cs.I8_HOT_PATTERNS:
                waves[f"timing_{p}"] = (timing, (), b, True)
        for name, (sizes, inactive, b, timed) in waves.items():
            pattern = name[len("timing_"):]
            edit = (cs.lane_pattern(pattern, b)
                    if pattern in cs.I8_HOT_PATTERNS else None)
            inp = cs.wave_case(gen, dev, sizes, exact=False, b=b,
                               inactive=inactive, scales=scales,
                               mode=mode.split("_")[0] if wide else mode,
                               edit=edit)
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
