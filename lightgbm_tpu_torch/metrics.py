"""Binary evaluation metrics, host numpy float64.

The port's copy of the JAX package's ``metrics.py`` binary metrics:
``binary_logloss`` (reference ``BinaryLoglossMetric``) and ``auc``
(reference ``AUCMetric``, tied scores counting half).  Each maps
``(label, raw_score, weight)`` to a float.  The port evaluates no valid
sets during training yet (ROADMAP); callers score predictions with these.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _avg(values: np.ndarray, weight: Optional[np.ndarray]) -> float:
    if weight is None:
        return float(np.mean(values))
    return float(np.sum(values * weight) / np.sum(weight))


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def binary_logloss(label, score, weight=None, sigmoid: float = 1.0) -> float:
    p = np.clip(_sigmoid(sigmoid * np.asarray(score, np.float64)), 1e-15,
                1 - 1e-15)
    y = (np.asarray(label) > 0).astype(np.float64)
    loss = -(y * np.log(p) + (1 - y) * np.log(1 - p))
    return _avg(loss, weight)


def auc(label, score, weight=None) -> float:
    y = (np.asarray(label) > 0).astype(np.float64)
    w = np.ones_like(y) if weight is None else np.asarray(weight, np.float64)
    order = np.argsort(score, kind="mergesort")
    y, w, s = y[order], w[order], np.asarray(score)[order]
    pos_w = y * w
    neg_w = (1 - y) * w
    # equal-score runs share their rank: ascending scan, each positive beats
    # the negatives strictly below it and ties count half
    boundaries = np.nonzero(np.diff(s))[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [len(s)]])
    cum_neg = 0.0
    total = 0.0
    for st, en in zip(starts, ends):
        p = pos_w[st:en].sum()
        n = neg_w[st:en].sum()
        total += p * (cum_neg + n / 2.0)
        cum_neg += n
    total_pos = pos_w.sum()
    total_neg = neg_w.sum()
    if total_pos == 0 or total_neg == 0:
        return 1.0
    return float(total / (total_pos * total_neg))
