"""Shape-bucketed batching: pad row counts onto a small geometric ladder
(the JAX package's ``serve/bucketing.py``, verbatim).

Padding the row axis up to ``base * ratio^k`` bounds the population of
distinct batch shapes at O(log max_batch) while wasting at most a
``ratio`` factor of compute on the padded rows.
"""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """Geometric row-count ladder: ``base, base*ratio, base*ratio^2, ...``.

    Above ``exact_above`` rows, batches get their EXACT shape instead of a
    rung: batches that large are bulk scoring jobs, not the repeated
    small-request traffic the ladder exists for."""

    base: int = 32
    ratio: int = 2
    exact_above: int = 1 << 20

    def __post_init__(self):
        if self.base < 1 or self.ratio < 2:
            raise ValueError("BucketLadder needs base >= 1 and ratio >= 2")

    def bucket(self, n: int) -> int:
        """Smallest rung >= n (n itself for n <= 0 -> base; exact for
        n > exact_above)."""
        if n > self.exact_above:
            return n
        m = self.base
        while m < n:
            m *= self.ratio
        return m

    def rungs_upto(self, n: int) -> List[int]:
        """Every rung <= bucket(n), e.g. for warmup (capped at the first
        rung covering ``exact_above``)."""
        out = [self.base]
        while out[-1] < min(n, self.exact_above):
            out.append(out[-1] * self.ratio)
        return out

    def max_compiles(self, max_rows: int) -> int:
        """Upper bound on distinct padded shapes for batches <= max_rows."""
        return len(self.rungs_upto(max_rows))
