"""Serving metrics: the per-request counters ``Predictor.predict`` records.

The port of the part of the JAX package's ``serve/metrics.py`` that the
predict path feeds: requests, rows, batches, padded rows and request
latency (p50/p99 over a bounded reservoir of the latest requests, plus the
exact mean).  The registry mirrors, per-tenant labels, request tracing and
SLO gauges are still to be ported.  Pure host bookkeeping.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

import numpy as np

from .plan import cache_stats


class ServeMetrics:
    """Thread-safe request/latency accounting for one Predictor."""

    def __init__(self, reservoir: int = 4096):
        self._lock = threading.Lock()
        self._latencies = deque(maxlen=reservoir)   # seconds
        self._batch_sizes = deque(maxlen=reservoir)
        self._latency_sum = 0.0
        self.requests = 0
        self.rows = 0
        self.batches = 0
        self.padded_rows = 0

    def observe_request(self, rows: int, seconds: float) -> None:
        with self._lock:
            self.requests += 1
            self.rows += int(rows)
            self._latencies.append(float(seconds))
            self._latency_sum += float(seconds)

    def observe_batch(self, rows: int, padded_to: int) -> None:
        with self._lock:
            self.batches += 1
            self._batch_sizes.append(int(rows))
            self.padded_rows += max(int(padded_to) - int(rows), 0)

    def latency_quantiles_ms(self) -> Dict[str, Optional[float]]:
        with self._lock:
            lat = np.asarray(self._latencies, np.float64)
            mean = self._latency_sum / self.requests if self.requests else None
        if lat.size == 0:
            return {"p50_ms": None, "p99_ms": None, "mean_ms": None}
        p50, p99 = np.percentile(lat, (50, 99))
        return {"p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3,
                "mean_ms": mean * 1e3}

    def snapshot(self, plan=None) -> Dict:
        """One flat dict of the counters; ``plan`` adds its pack format,
        resident bytes and the process-wide plan-cache counters."""
        with self._lock:
            bs = np.asarray(self._batch_sizes, np.float64)
            out = {
                "requests": self.requests,
                "rows": self.rows,
                "batches": self.batches,
                "padded_rows": self.padded_rows,
                "mean_batch_rows": float(bs.mean()) if bs.size else None,
            }
        out.update(self.latency_quantiles_ms())
        out["plan_bytes"] = None if plan is None else int(plan.plan_bytes)
        out["quantize"] = None if plan is None else plan.quantize_mode
        out["traverse"] = None if plan is None else plan.traverse_mode
        out["plan_cache"] = None if plan is None else cache_stats()
        return out
