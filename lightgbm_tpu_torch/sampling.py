"""Row sampling (bagging, GOSS) and per-tree feature sampling.

The port of the JAX package's ``sampling.py`` (reference
``SampleStrategy`` with ``BaggingSampleStrategy`` and ``GOSSStrategy``,
``ColSampler``).  Sampling is a multiplicative row mask: out-of-bag rows
get weight 0 (their gradient, hessian and count leave every histogram)
and GOSS's sampled rows the amplification ``(1 - top_rate) /
other_rate``.

- :class:`SampleStrategy` draws the host masks from
  ``np.random.RandomState(bagging_seed)``, the JAX package's stream draw
  for draw: plain bagging (``rng.choice`` of ``int(N * fraction)``
  rows), balanced positive / negative bagging, by-query bagging, the
  resample cadence of ``bagging_freq``, and the host GOSS mask (a stable
  argsort of ``|g * h|``, the same ``rng.choice`` of the rest).
- :class:`FeatureSampler` draws each tree's ``feature_fraction`` subset
  from ``RandomState(feature_fraction_seed)``.
- :func:`goss_mask_device` is GOSS on the rows' device: the exact top-k
  by ``|g * h|`` (a stable descending sort: ties go to the lower row, as
  ``jax.lax.top_k`` breaks them) and the rest drawn uniformly from a
  ``torch.Generator`` (:func:`goss_generator`, seeded from
  ``(bagging_seed, iteration)``; the JAX package folds the iteration into
  ``PRNGKey(bagging_seed)``, so the draws are its in law, not in bits).

At ``other_rate = 0`` (GOSS keeps only the top rows) the port does not
sample for the first ``int(1 / learning_rate)`` iterations, as reference
LightGBM's ``GOSSStrategy::Bagging`` does at every rate: at iteration 0
every row's ``|g * h|`` takes one of a label's two values, so the top
rows are all of one label and no split has a gain.  The JAX package
samples from iteration 0 and grows no tree there; at other rates the
port keeps its schedule.

The iteration pack's in-scan samplers (``bagging_mask_device``,
``feature_mask_device``) wait for the pack (ROADMAP A8.11).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import Config
from .ops.quantize import _splitmix64


class SampleStrategy:
    """The per-iteration row mask (1.0 in bag, 0.0 out, the GOSS
    amplification for sampled rest rows)."""

    def __init__(self, cfg: Config, num_data: int,
                 label: Optional[np.ndarray] = None,
                 query_boundaries: Optional[np.ndarray] = None):
        self.cfg = cfg
        self.num_data = num_data
        self.label = label
        self.query_boundaries = query_boundaries
        self.rng = np.random.RandomState(cfg.bagging_seed)
        self.is_goss = cfg.data_sample_strategy == "goss"
        balanced = (cfg.pos_bagging_fraction < 1.0
                    or cfg.neg_bagging_fraction < 1.0)
        self.is_bagging = (not self.is_goss) and (
            (cfg.bagging_fraction < 1.0 and cfg.bagging_freq > 0) or balanced)
        self.is_balanced = balanced and not self.is_goss
        self._cached: Optional[np.ndarray] = None

    def needs_resample(self, iteration: int) -> bool:
        if self.is_goss:
            return True
        if not self.is_bagging:
            return False
        freq = max(self.cfg.bagging_freq, 1)
        return iteration % freq == 0 or self._cached is None

    def goss_warmup(self, iteration: int) -> bool:
        """True where GOSS keeps every row: the first ``int(1 /
        learning_rate)`` iterations at ``other_rate = 0`` (reference
        ``goss.hpp``; see the module docstring)."""
        cfg = self.cfg
        return (self.is_goss and cfg.other_rate <= 0.0
                and iteration < int(1.0 / cfg.learning_rate))

    def mask(self, iteration: int, grad: Optional[np.ndarray] = None,
             hess: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
        """The (N,) f32 mask of ``iteration``, or None (every row)."""
        if self.is_goss:
            if self.goss_warmup(iteration):
                return None
            return self._goss_mask(grad, hess)
        if not self.is_bagging:
            return None
        if self.needs_resample(iteration):
            self._cached = self._bagging_mask()
        return self._cached

    def _bagging_mask(self) -> np.ndarray:
        cfg = self.cfg
        n = self.num_data
        mask = np.zeros(n, np.float32)
        if cfg.bagging_by_query and self.query_boundaries is not None:
            nq = len(self.query_boundaries) - 1
            take = self.rng.rand(nq) < cfg.bagging_fraction
            for qi in np.nonzero(take)[0]:
                mask[self.query_boundaries[qi]:
                     self.query_boundaries[qi + 1]] = 1.0
            return mask
        if self.is_balanced and self.label is not None:
            pos = self.label > 0
            r = self.rng.rand(n)
            mask[pos & (r < cfg.pos_bagging_fraction)] = 1.0
            mask[~pos & (r < cfg.neg_bagging_fraction)] = 1.0
            return mask
        k = int(n * cfg.bagging_fraction)
        idx = self.rng.choice(n, size=k, replace=False)
        mask[idx] = 1.0
        return mask

    def goss_constants(self):
        """(top_k, other_k, amplification), shared by the host and device
        GOSS masks (reference ``goss.hpp:30-60``)."""
        cfg = self.cfg
        n = self.num_data
        top_k = max(int(n * cfg.top_rate), 1)
        other_k = int(n * cfg.other_rate)
        amp = ((1.0 - cfg.top_rate) / cfg.other_rate
               if cfg.other_rate > 0 else 0.0)
        return top_k, other_k, amp

    def _goss_mask(self, grad: np.ndarray, hess: np.ndarray) -> np.ndarray:
        """Host GOSS: the top ``top_rate`` of the rows by ``|g * h|``, and
        ``other_rate`` of the rest sampled and amplified."""
        cfg = self.cfg
        n = self.num_data
        score = np.abs(grad * hess)
        top_k, other_k, _amp = self.goss_constants()
        order = np.argsort(-score, kind="stable")
        mask = np.zeros(n, np.float32)
        mask[order[:top_k]] = 1.0
        rest = order[top_k:]
        if len(rest) > 0 and other_k > 0 and cfg.other_rate > 0:
            pick = self.rng.choice(len(rest), size=min(other_k, len(rest)),
                                   replace=False)
            mask[rest[pick]] = (1.0 - cfg.top_rate) / cfg.other_rate
        return mask


def goss_generator(seed: int, iteration: int,
                   device: torch.device) -> torch.Generator:
    """The device GOSS draws of one iteration: a ``torch.Generator`` on
    ``device`` seeded from ``(bagging_seed, iteration)``, as
    ``ops/quantize.py::quant_generator`` seeds its stream (a different
    salt, so the two streams never coincide)."""
    x = _splitmix64(((int(seed) & 0xFFFFFFFF) << 32
                     | (int(iteration) & 0xFFFFFFFF)) ^ 0x474F5353)
    gen = torch.Generator(device=device)
    gen.manual_seed(x)
    return gen


def goss_mask_device(grad_sum: torch.Tensor, hess_sum: torch.Tensor,
                     generator: torch.Generator, top_k: int, other_k: int,
                     amplify: float) -> torch.Tensor:
    """GOSS on the rows' device (reference ``goss.hpp:30-60``): the (N,)
    f32 mask keeping the exact top ``top_k`` rows by ``|g * h|`` (ties to
    the lower row) at 1, ``other_k`` of the rest drawn uniformly at
    ``amplify``, every other row at 0."""
    n = grad_sum.shape[0]
    dev = grad_sum.device
    score = torch.abs(grad_sum * hess_sum)
    order = torch.argsort(score, descending=True, stable=True)
    mask = torch.zeros(n, dtype=torch.float32, device=dev)
    mask[order[:top_k]] = 1.0
    if other_k > 0:
        u = torch.rand(n, generator=generator, device=dev)
        u = torch.where(mask > 0.0, torch.full_like(u, -1.0), u)
        sel = torch.argsort(u, descending=True, stable=True)[:other_k]
        # a rest smaller than other_k falls back onto excluded rows: drop
        sel = sel[u[sel] >= 0.0]
        mask[sel] = float(np.float32(amplify))
    return mask


class FeatureSampler:
    """``feature_fraction`` per tree (reference ``ColSampler``,
    ``col_sampler.hpp``).  Interaction constraints are refused by
    ``models/gbdt.py::check_supported`` (ROADMAP A8.7)."""

    def __init__(self, cfg: Config, num_features: int):
        self.cfg = cfg
        self.num_features = num_features
        self.rng = np.random.RandomState(cfg.feature_fraction_seed)

    def tree_mask(self, iteration: int) -> np.ndarray:
        """The (F,) bool mask of ``iteration``'s tree: ``ceil(F *
        feature_fraction)`` features drawn without replacement (the JAX
        package's ``rng.choice`` over every feature, draw for draw)."""
        f, frac = self.num_features, self.cfg.feature_fraction
        mask = np.zeros(f, bool)
        if frac >= 1.0:
            mask[:] = True
            return mask
        k = max(int(np.ceil(f * frac)), 1)
        mask[self.rng.choice(np.arange(f), size=k, replace=False)] = True
        return mask
