"""PredictPlan: a model slice frozen into device-resident serving state.

The port of the JAX package's ``serve/plan.py``.  A plan holds, on its
device:

- the per-class tree packs, built once from the host trees: the fp32 pack
  (``quantize="off"``, walked by torch ops, ``models/tree.py::
  forest_scores``) or a quantized pack (int16/int8, through the CUDA
  traversal kernel),
- the binning tables (bound sort keys, categorical vocabularies, NaN /
  zero-as-missing routing — serve/device_binning.py),
- the NaN routing of the traversal,

and serves dense rows (raw f64 bits -> device bins -> traversal kernel ->
per-class scores) and pre-binned rows (the sparse-input path).  Row counts
are padded onto the bucket ladder, as in the JAX package.  Init scores are
added on the host in f64 after the fetch.

Plans are cached per (model identity, iteration slice, model state,
ladder, pack mode, traversal, device); the cache keeps hit / miss / build
/ eviction counters.  Not ported: the persistent compile cache
(``serve/compile_cache.py``), which has no counterpart while the port's
kernels are built once per process.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from ..models.tree import (forest_scores, forest_scores_quantized,
                           fp32_pack_nbytes, pack_nbytes,
                           quantize_stack_trees, stack_trees)
from ..utils.device import resolve_device
from ..utils.log import Log
from .bucketing import BucketLadder
from .device_binning import (bin_rows_device, build_bin_tables, float_bits,
                             tables_nbytes)

class PredictPlan:
    """Frozen, device-resident predict state for one model slice."""

    def __init__(self, model, start_iteration: int, end_iteration: int,
                 ladder: Optional[BucketLadder] = None,
                 quantize: Optional[str] = None,
                 traverse: Optional[str] = None,
                 device=None):
        self.device = resolve_device(device)
        binned = model.train_data.binned
        self._model_ref = weakref.ref(model)
        self.start_iteration = int(start_iteration)
        self.end_iteration = int(end_iteration)
        self.num_class = int(model.num_class)
        self.num_features = int(binned.num_features)
        self.init_scores = np.asarray(model.init_scores, np.float64).copy()
        self.ladder = ladder or BucketLadder()
        self.quantize_mode = _resolve_quantize(model, quantize, warn=True)
        self.traverse_mode = _resolve_traverse(model, traverse)
        tables = build_bin_tables(binned.mappers, self.device)
        if tables is None:
            raise ValueError("device binning unavailable for this dataset")
        self._tables = tables
        trees_by_class = model.host_trees(self.start_iteration,
                                          self.end_iteration)
        self.num_trees = sum(len(t) for t in trees_by_class)
        self._nan_bins = torch.as_tensor(binned.nan_bins, dtype=torch.int32,
                                         device=self.device)
        if self.quantize_mode == "off":
            packs = [stack_trees(trees, model.cfg.num_leaves,
                                 binned.max_num_bins, self.device)
                     if trees else None for trees in trees_by_class]
            nbytes = fp32_pack_nbytes
        else:
            packs = [quantize_stack_trees(trees, model.cfg.num_leaves,
                                          binned.max_num_bins,
                                          self.quantize_mode, self.device)
                     if trees else None for trees in trees_by_class]
            nbytes = pack_nbytes
            if any(p is None and trees
                   for p, trees in zip(packs, trees_by_class)):
                raise ValueError(
                    f"tpu_serve_quantize={self.quantize_mode} needs "
                    "num_leaves/bins/features <= 32767; serve this model "
                    "with quantize='off'")
        self._packs = packs
        # resident device bytes: the tree packs alone, and with the bin
        # tables and NaN routing
        self.pack_bytes = sum(nbytes(p) for p in packs if p is not None)
        self.plan_bytes = (self.pack_bytes + tables_nbytes(tables)
                           + self._nan_bins.numel() * 4)
        self.built_state = (int(model.iter_), int(model.num_trees))

    def is_for(self, model) -> bool:
        return self._model_ref() is model

    # ------------------------------------------------------------ prediction
    def _pad(self, a: np.ndarray, n: int):
        padded = self.ladder.bucket(n)
        if padded == n:
            return a, padded
        return np.pad(a, ((0, padded - n), (0, 0))), padded

    def _finish(self, scores: torch.Tensor, n: int) -> np.ndarray:
        out = scores.cpu().numpy().astype(np.float64)[:n]
        out += self.init_scores[None, :]
        return out

    def _scores(self, bins: torch.Tensor) -> torch.Tensor:
        if self.quantize_mode == "off":
            return forest_scores(self._packs, bins, self._nan_bins)
        return forest_scores_quantized(self._packs, bins, self._nan_bins)

    def raw_scores(self, X, metrics=None) -> np.ndarray:
        """(N, K) f64 raw scores (init scores included) for dense rows:
        the host takes a bit view and pads to the ladder rung; binning,
        traversal and dequantization run on the plan's device."""
        X = np.asarray(X)
        n = X.shape[0]
        if X.ndim != 2 or X.shape[1] != self.num_features:
            raise ValueError(
                f"plan expects (N, {self.num_features}) rows, got {X.shape}")
        if n == 0:
            return np.zeros((0, self.num_class), np.float64) \
                + self.init_scores[None, :]
        bits, padded = self._pad(float_bits(X), n)
        bits = torch.from_numpy(bits).to(self.device)
        bins = bin_rows_device(self._tables, bits)
        scores = self._scores(bins)
        if metrics is not None:
            metrics.observe_batch(n, padded)
        return self._finish(scores, n)

    def raw_scores_binned(self, bins: np.ndarray, metrics=None) -> np.ndarray:
        """(N, K) f64 raw scores from pre-binned rows (the sparse-input
        path: host binning straight from CSC, device traversal)."""
        bins = np.asarray(bins)
        n = bins.shape[0]
        if n == 0:
            return np.zeros((0, self.num_class), np.float64) \
                + self.init_scores[None, :]
        bins, padded = self._pad(bins, n)
        bins = torch.from_numpy(bins.astype(np.int32)).to(self.device)
        scores = self._scores(bins)
        if metrics is not None:
            metrics.observe_batch(n, padded)
        return self._finish(scores, n)

    def warmup(self, max_rows: int) -> int:
        """Run the dense path once at every ladder rung up to
        ``bucket(max_rows)`` (builds the kernels and allocator pools ahead
        of traffic); returns the number of rungs warmed."""
        rungs = self.ladder.rungs_upto(max_rows)
        for m in rungs:
            self.raw_scores(np.zeros((m, self.num_features)))
        return len(rungs)


def _resolve_quantize(model, quantize: Optional[str],
                      warn: bool = False) -> str:
    """Effective pack mode: the explicit kwarg wins, else the model's
    ``tpu_serve_quantize``; unknown spellings mean off."""
    if quantize is None:
        quantize = getattr(model.cfg, "tpu_serve_quantize", "off")
    quantize = str(quantize).lower()
    if quantize not in ("off", "int16", "int8"):
        if warn:
            Log.warning(f"serve: unknown tpu_serve_quantize={quantize!r} "
                        "(expected off|int16|int8); using off")
        return "off"
    return quantize


def _resolve_traverse(model, traverse: Optional[str]) -> str:
    """auto and fused both mean the traversal kernel (on a CUDA device;
    its plain version on the CPU).  unfused, the JAX package's separate
    XLA walk, has no counterpart in the port."""
    if traverse is None:
        traverse = getattr(model.cfg, "tpu_traverse_kernel", "auto")
    traverse = str(traverse).lower()
    if traverse in ("auto", "fused"):
        return "fused"
    if traverse == "unfused":
        raise NotImplementedError(
            "tpu_traverse_kernel=unfused has no counterpart in the port: "
            "a CUDA tensor always goes through the traversal kernel")
    raise ValueError(f"unknown tpu_traverse_kernel={traverse!r} "
                     "(expected auto|fused|unfused)")


# ---------------------------------------------------------------- plan cache
_CACHE: "OrderedDict[tuple, PredictPlan]" = OrderedDict()
_CACHE_LOCK = threading.Lock()
_CACHE_CAP = 8
_STATS = {"hits": 0, "misses": 0, "builds": 0, "evictions": 0}


def _stale_locked(key, plan) -> bool:
    """An entry is stale when its model was garbage-collected or has moved
    past the keyed (iter_, num_trees) state."""
    model = plan._model_ref()
    if model is None:
        return True
    return (int(model.iter_), int(model.num_trees)) != key[3:5]


def _sweep_dead_locked() -> None:
    for k in [k for k, p in _CACHE.items() if _stale_locked(k, p)]:
        del _CACHE[k]
        _STATS["evictions"] += 1


def _resolve_slice(model, num_iteration: Optional[int],
                   start_iteration: int):
    n = int(model.iter_)
    start = max(int(start_iteration), 0)
    end = n if num_iteration is None else min(n, start + int(num_iteration))
    return start, max(end, start)


def plan_for_model(model, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   ladder: Optional[BucketLadder] = None,
                   quantize: Optional[str] = None,
                   traverse: Optional[str] = None,
                   device=None) -> PredictPlan:
    """Fetch (or build) the cached PredictPlan for a model slice.  The key
    carries the model's identity and state, the slice and every option,
    so a quantized plan and another device's plan of the same model are
    distinct entries.  Plans build under the cache lock, so concurrent
    misses on one key build once."""
    ladder = ladder or BucketLadder()
    dev = resolve_device(device)
    start, end = _resolve_slice(model, num_iteration, start_iteration)
    if traverse is None:
        traverse = getattr(model.cfg, "tpu_traverse_kernel", "auto")
    key = (id(model), start, end, int(model.iter_), int(model.num_trees),
           ladder, _resolve_quantize(model, quantize),
           str(traverse).lower(), str(dev))
    with _CACHE_LOCK:
        plan = _CACHE.get(key)
        if plan is not None and plan.is_for(model):
            _STATS["hits"] += 1
            _CACHE.move_to_end(key)
            _sweep_dead_locked()
            return plan
        _STATS["misses"] += 1
        plan = PredictPlan(model, start, end, ladder=ladder,
                           quantize=quantize, traverse=traverse, device=dev)
        _STATS["builds"] += 1
        _CACHE[key] = plan
        _CACHE.move_to_end(key)
        _sweep_dead_locked()
        while len(_CACHE) > _CACHE_CAP:
            _CACHE.popitem(last=False)
            _STATS["evictions"] += 1
    return plan


def cache_stats() -> Dict[str, int]:
    """Hit/miss/build/eviction counters plus the live cache footprint:
    ``size`` (entries) and ``bytes`` (resident device bytes)."""
    with _CACHE_LOCK:
        return dict(_STATS, size=len(_CACHE),
                    bytes=sum(p.plan_bytes for p in _CACHE.values()))


def clear_plan_cache() -> None:
    with _CACHE_LOCK:
        _CACHE.clear()
        for k in _STATS:
            _STATS[k] = 0
