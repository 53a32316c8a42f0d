"""Hierarchical wall-clock timers, marked in ``torch.profiler`` traces.

The port's copy of the JAX package's ``utils/timer.py`` (reference
``Common::Timer`` / ``FunctionTimer``, ``utils/common.h:973-1057``): named
spans aggregated per name, with the total seconds and the count of each
(``durations``, ``counts``, ``snapshot``).
A :class:`FunctionTimer` span also opens a ``torch.profiler``
``record_function`` range of its name, where the JAX package opens a
``jax.profiler.TraceAnnotation``.  The text-file parser, binning, the
model loader and continued training's fold time their steps here
(``io/parse``, ``dataset/bin``, ``model/load``,
``train/fold_init_score``; ``chip_smoke.py`` reports them).

Thread-safe: starts are kept per ``(thread, name)`` as a stack, so
nested spans of one name on one thread close innermost first.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Tuple


class Timer:
    def __init__(self):
        self._lock = threading.Lock()
        self.durations: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)
        # (thread ident, name) -> stack of perf_counter starts
        self._starts: Dict[Tuple[int, str], List[float]] = {}

    def start(self, name: str) -> None:
        t = time.perf_counter()
        key = (threading.get_ident(), name)
        with self._lock:
            self._starts.setdefault(key, []).append(t)

    def stop(self, name: str) -> None:
        t = time.perf_counter()
        key = (threading.get_ident(), name)
        with self._lock:
            stack = self._starts.get(key)
            if not stack:
                return   # unmatched stop (or a different thread's start)
            t0 = stack.pop()
            if not stack:
                del self._starts[key]
            self.durations[name] += t - t0
            self.counts[name] += 1

    def snapshot(self) -> List[Tuple[str, float, int]]:
        """``(name, total_seconds, count)`` rows, longest first."""
        with self._lock:
            return sorted(((n, self.durations[n], self.counts[n])
                           for n in self.durations),
                          key=lambda row: -row[1])

    def reset(self) -> None:
        with self._lock:
            self.durations.clear()
            self.counts.clear()
            self._starts.clear()


global_timer = Timer()


class FunctionTimer:
    """Context-manager span: host timer + ``torch.profiler`` range."""

    def __init__(self, name: str, timer: Optional[Timer] = None):
        self.name = name
        self.timer = timer or global_timer
        self._range = None

    def __enter__(self):
        from torch.profiler import record_function
        self.timer.start(self.name)
        self._range = record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        self.timer.stop(self.name)
        return False
