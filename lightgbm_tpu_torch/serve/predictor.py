"""Serving front end: :class:`Predictor`, batched predicts over a frozen
plan, with metrics.

The port of the JAX package's ``serve/predictor.py::Predictor.predict``:
dense rows are binned on the device, scipy sparse rows on the host
(straight from CSC) and traversed on the device; raw scores are summed per
class with the init scores, then the objective's output transform runs in
float32 exactly as the JAX package runs it (f64 raw -> float32 ->
transform).  Inputs carrying ``inf`` are rejected: the binning contract
reserves non-finite values for NaN-as-missing.

A device fault raises.  Not ported yet: the JAX package's one-shot host
fallback, the MicroBatcher, request tracing and SLO gauges.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..binning import _is_sparse
from .bucketing import BucketLadder
from .metrics import ServeMetrics
from .plan import plan_for_model


def _reject_inf_rows(X: np.ndarray) -> None:
    """NaN means missing and is welcome; ``inf`` has no bin ordering, so
    Inf-laden rows are the caller's bug."""
    if np.isinf(X).any():
        rows = np.unique(np.nonzero(np.isinf(X))[0])[:8]
        raise ValueError(
            f"input rows {rows.tolist()} contain inf values; the binning "
            "contract accepts NaN (missing) but not inf — clean or clip "
            "the feature pipeline upstream")


class Predictor:
    """Long-lived inference handle for one model slice (reference
    ``Predictor``, ``src/application/predictor.cpp``: extract traversal
    state once, then only traverse)."""

    def __init__(self, model, *, raw_score: bool = False,
                 num_iteration: Optional[int] = None,
                 start_iteration: int = 0,
                 ladder: Optional[BucketLadder] = None,
                 quantize: Optional[str] = None,
                 traverse: Optional[str] = None,
                 device=None):
        """``device`` defaults to the CUDA card (raising if there is none);
        ``"cpu"`` runs the plain PyTorch path on the host."""
        if not hasattr(model, "train_data"):
            raise ValueError("Predictor needs a model with its bin mappers "
                             "(see convert.model_from_arrays); a text-loaded "
                             "model carries none: use Booster.predict")
        if getattr(model, "base_model", None) is not None:
            raise ValueError(
                "Predictor does not serve a continuation booster (its base "
                "model walks raw values, not bins): use Booster.predict")
        self._model = model
        self._raw_score = bool(raw_score)
        self._num_iteration = num_iteration
        self._start_iteration = max(int(start_iteration), 0)
        self._options = dict(ladder=ladder, quantize=quantize,
                             traverse=traverse, device=device)
        self.plan = plan_for_model(model, num_iteration, start_iteration,
                                   **self._options)
        self.metrics = ServeMetrics()

    def _maybe_refresh_plan(self) -> None:
        """A model mutated since the plan was built must never serve the
        stale pack: re-resolve through the cache."""
        m = self._model
        if (int(m.iter_), int(m.num_trees)) != self.plan.built_state:
            self.plan = plan_for_model(m, self._num_iteration,
                                       self._start_iteration, **self._options)

    def predict(self, X) -> np.ndarray:
        """Scores for a batch of rows, recorded in the serving metrics.
        Accepts dense arrays (device binning) or scipy sparse (host
        binning from CSC, device traversal)."""
        t0 = time.perf_counter()
        self._maybe_refresh_plan()
        if _is_sparse(X):
            if X.shape[1] != self.plan.num_features:
                raise ValueError(
                    f"plan expects (N, {self.plan.num_features}) rows, "
                    f"got {X.shape}")
            bins = self._model.train_data.binned.apply(X)
            raw = self.plan.raw_scores_binned(bins, metrics=self.metrics)
        else:
            X = np.asarray(X, np.float64)
            if X.ndim == 1:
                X = X.reshape(1, -1)
            if X.shape[1] != self.plan.num_features:
                raise ValueError(
                    f"plan expects (N, {self.plan.num_features}) rows, "
                    f"got {X.shape}")
            _reject_inf_rows(X)
            raw = self.plan.raw_scores(X, metrics=self.metrics)
        out = raw[:, 0] if self.plan.num_class == 1 else raw
        obj = getattr(self._model, "objective", None)
        if not self._raw_score and obj is not None:
            # f64 raw -> float32 -> transform in float32, on the plan's
            # device, as the JAX package's Booster.predict runs it
            score = torch.from_numpy(out).to(torch.float32).to(
                self.plan.device)
            out = obj.convert_output(score).cpu().numpy()
        self.metrics.observe_request(X.shape[0], time.perf_counter() - t0)
        return out

    def warmup(self, max_rows: int = 1024) -> int:
        """Run every ladder rung up to ``max_rows`` ahead of traffic."""
        return self.plan.warmup(max_rows)

    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot(plan=self.plan)
