"""Learning-to-rank objectives: LambdaRank NDCG and RankXENDCG.

The port of the JAX package's ``ranking.py`` (reference
``src/objective/rank_objective.hpp``).  Queries are padded once, on the
host, to a (Q, S) matrix of document rows (``_pad_queries``; -1 marks a
padding slot), and each iteration's gradients are torch ops on the
scores' device over that matrix:

- :class:`LambdaRankNDCG`: a stable in-query argsort ranks the documents
  (padding at ``-inf`` sorts last, equal scores keep their slot order, as
  ``jnp.argsort`` does), the truncated pair set is a dense (Q, T, S)
  tensor (T = ``lambdarank_truncation_level``, at most S; each pair
  counted once), lambdas and hessians carry the delta-NDCG weight and,
  with ``lambdarank_norm``, each query's normalization.  With positions
  (unbiased LTR) every score is offset by its position's learned bias,
  which takes a Newton step an iteration.
- :class:`RankXENDCG`: the per-query softmax cross entropy against gain
  targets perturbed by uniform gammas, drawn each iteration from a CPU
  ``torch.Generator`` seeded from ``objective_seed`` and copied to the
  scores' device, so one seed gives the same gammas on the CPU and on the
  card, as a ``jax.random`` key gives the same bits on every backend (the
  JAX package splits a ``PRNGKey``: the gammas are its in law, not in
  bits).

No float atomics: every document sits in one slot of the (Q, S) matrix
and in at most one of the top-T slots, so the per-slot sums are written
with unique-index assignments into two (N,) vectors that are then added
(the JAX package's two scatter-adds, in its order), and the position-bias
sums run on the host in row order (``np.add.at`` in float32, the JAX
package's ``segment_sum`` order).  Two runs give the same gradients bit
for bit on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from .objectives import ObjectiveFunction


def default_label_gain(max_label: int = 31) -> np.ndarray:
    """2^i - 1 (reference config.cpp default label_gain)."""
    return (np.power(2.0, np.arange(max_label + 1)) - 1.0).astype(np.float64)


def _pad_queries(group: np.ndarray):
    """Group sizes -> (doc_idx (Q, S) int64 padded with -1, boundaries)."""
    sizes = np.asarray(group, np.int64)
    q = len(sizes)
    s = int(sizes.max()) if q else 0
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    doc_idx = np.full((q, s), -1, np.int64)
    for i in range(q):
        doc_idx[i, : sizes[i]] = np.arange(bounds[i], bounds[i + 1])
    return doc_idx, bounds


def _gather_scores(score, doc_idx, valid):
    """(Q, S) scores of the padded matrix, ``-inf`` at padding."""
    sc = score[doc_idx.clamp(min=0)]
    return torch.where(valid, sc, torch.full_like(sc, float("-inf")))


def _scatter_slots(n: int, doc_idx, keep, values):
    """(N,) vector holding ``values`` at the rows ``doc_idx`` where
    ``keep``: each row appears at most once, so an assignment."""
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    out[doc_idx[keep]] = values[keep]
    return out


def lambdarank_grads(score, doc_idx, valid, qgain, inv_max_dcg, *,
                     trunc: int, sigmoid: float, norm: bool):
    """(grad, hess) of LambdaRank NDCG for (N,) f32 ``score`` (the JAX
    package's ``LambdaRankNDCG._grad_fn``)."""
    n = score.shape[0]
    q, s = doc_idx.shape
    dev = score.device
    sc = _gather_scores(score, doc_idx, valid)
    order = torch.argsort(-sc, dim=1, stable=True)       # (Q, S) slots
    rank_of = torch.empty_like(order)                      # slot -> rank
    rank_of.scatter_(1, order, torch.arange(s, device=dev).expand(q, s))
    disc = 1.0 / torch.log2(torch.arange(s, dtype=torch.float32,
                                         device=dev) + 2.0)
    doc_disc = disc[rank_of]
    top_slots = order[:, :trunc]                           # (Q, T)
    gather = lambda a: torch.take_along_dim(a, top_slots, dim=1)
    sc_i, gain_i, disc_i, valid_i = (gather(sc), gather(qgain),
                                     gather(doc_disc), gather(valid))
    d_gain = gain_i[:, :, None] - qgain[:, None, :]        # (Q, T, S)
    d_score = sc_i[:, :, None] - sc[:, None, :]
    d_disc = torch.abs(disc_i[:, :, None] - doc_disc[:, None, :])
    # each pair once: j ranked strictly below i (the reference loops i in
    # [0, trunc), j in (i, count))
    i_rank = torch.arange(trunc, device=dev)[None, :, None]
    pair_ok = (valid_i[:, :, None] & valid[:, None, :]
               & (torch.abs(d_gain) > 0) & (rank_of[:, None, :] > i_rank))
    high = d_gain > 0
    s_hl = torch.where(high, d_score, -d_score)
    delta_ndcg = torch.abs(d_gain) * d_disc * inv_max_dcg[:, None, None]
    p = 1.0 / (1.0 + torch.exp(sigmoid * s_hl))            # low beats high
    lam = -sigmoid * p * delta_ndcg
    hes = sigmoid * sigmoid * p * (1.0 - p) * delta_ndcg
    zero = torch.zeros((), device=dev)
    lam = torch.where(pair_ok, lam, zero)
    hes = torch.where(pair_ok, hes, zero)
    sign = torch.where(high, 1.0, -1.0)
    lam_i = torch.sum(torch.where(high, lam, -lam), dim=2)   # (Q, T)
    hes_i = torch.sum(hes, dim=2)
    lam_j = -torch.sum(sign * lam, dim=1)                     # (Q, S)
    hes_j = torch.sum(hes, dim=1)
    if norm:
        # the reference's |lambda| sum over both pair endpoints
        # (rank_objective.hpp:178)
        sum_abs = 2.0 * torch.sum(torch.abs(lam), dim=(1, 2)) + 1e-20
        scale = torch.where(sum_abs > 0, torch.log2(1.0 + sum_abs) / sum_abs,
                            torch.ones_like(sum_abs))[:, None]
    else:
        scale = torch.ones((q, 1), dtype=torch.float32, device=dev)
    idx_top = torch.take_along_dim(doc_idx, top_slots, dim=1)
    grad = (_scatter_slots(n, idx_top, valid_i, lam_i * scale)
            + _scatter_slots(n, doc_idx, valid, lam_j * scale))
    hess = (_scatter_slots(n, idx_top, valid_i, hes_i * scale)
            + _scatter_slots(n, doc_idx, valid, hes_j * scale))
    return grad, hess


def xendcg_grads(score, gammas, doc_idx, valid, phi_base):
    """(grad, hess) of XE-NDCG for (N,) f32 ``score`` and (Q, S)
    ``gammas`` (the JAX package's ``_xendcg_grads``)."""
    n = score.shape[0]
    sc = _gather_scores(score, doc_idx, valid)
    zero = torch.zeros((), device=score.device)
    rho = torch.where(valid, torch.softmax(sc, dim=1), zero)
    phi = torch.where(valid, phi_base - gammas, zero)
    phi_sum = torch.sum(phi, dim=1, keepdim=True)
    p = torch.where(phi_sum > 0, phi / torch.clamp(phi_sum, min=1e-20), zero)
    lam = rho - p
    hes = torch.clamp(rho * (1.0 - rho), min=1e-16)
    return (_scatter_slots(n, doc_idx, valid, lam),
            _scatter_slots(n, doc_idx, valid, hes))


class LambdaRankNDCG(ObjectiveFunction):
    """Pairwise LambdaRank with delta-NDCG weights (reference
    ``LambdarankNDCG::GetGradientsForOneQuery``)."""

    def init(self, label, weight, device, group=None, position=None):
        super().init(label, weight, device)
        if group is None:
            raise ValueError("lambdarank requires query/group information")
        cfg = self.cfg
        self.pos_ids = None
        if position is not None:
            # unbiased LTR (rank_objective.hpp:43-86, 296-333)
            _, pos_ids = np.unique(np.asarray(position), return_inverse=True)
            self.pos_ids_host = pos_ids.astype(np.int64)
            self.num_positions = int(pos_ids.max()) + 1
            self.pos_ids = torch.as_tensor(self.pos_ids_host, device=device)
            self.pos_bias = np.zeros(self.num_positions, np.float32)
            self.pos_cnt = np.zeros(self.num_positions, np.float32)
            np.add.at(self.pos_cnt, self.pos_ids_host, np.float32(1.0))
            self.bias_lr = np.float32(cfg.learning_rate)
            self.bias_reg = np.float32(
                cfg.lambdarank_position_bias_regularization)
            # the bias advances each call (the JAX package's routing)
            self.stochastic_gradients = True
        label_np = np.asarray(label, np.float64)
        gains = (np.asarray(cfg.label_gain, np.float64)
                 if cfg.label_gain else default_label_gain())
        doc_idx, _bounds = _pad_queries(group)
        q, s = doc_idx.shape
        self.trunc = min(cfg.lambdarank_truncation_level, s)
        valid = doc_idx >= 0
        lab = np.zeros((q, s), np.float64)
        lab[valid] = label_np[doc_idx[valid]]
        gain = np.where(valid, gains[np.minimum(lab.astype(np.int64),
                                                len(gains) - 1)], 0.0)
        # ideal DCG per query at the truncation level (reference
        # DCGCalculator::CalMaxDCGAtK)
        top = np.sort(gain, axis=1)[:, ::-1]
        disc = 1.0 / np.log2(np.arange(s) + 2.0)
        max_dcg = (top[:, : self.trunc] * disc[None, : self.trunc]).sum(axis=1)
        self.inv_max_dcg = torch.as_tensor(
            np.where(max_dcg > 0, 1.0 / np.maximum(max_dcg, 1e-20), 0.0)
            .astype(np.float32), device=device)
        self.doc_idx = torch.as_tensor(doc_idx, device=device)
        self.valid = torch.as_tensor(valid, device=device)
        self.qgain = torch.as_tensor(gain.astype(np.float32), device=device)

    def get_gradients(self, score):
        cfg = self.cfg
        if self.pos_ids is not None:
            bias = torch.as_tensor(self.pos_bias, device=score.device)
            score = score + bias[self.pos_ids]
        grad, hess = lambdarank_grads(
            score, self.doc_idx, self.valid, self.qgain, self.inv_max_dcg,
            trunc=self.trunc, sigmoid=cfg.sigmoid, norm=cfg.lambdarank_norm)
        grad, hess = self._apply_weight(grad, hess)
        if self.pos_ids is not None:
            self._position_step(grad, hess)
        return grad, hess

    def _position_step(self, grad, hess) -> None:
        """Newton step on the per-position utility derivatives
        (rank_objective.hpp:296-331), the sums in row order on the host."""
        p = self.num_positions
        fd = np.zeros(p, np.float32)
        sd = np.zeros(p, np.float32)
        np.add.at(fd, self.pos_ids_host, grad.cpu().numpy())
        np.add.at(sd, self.pos_ids_host, hess.cpu().numpy())
        fd, sd = -fd, -sd
        fd = fd - self.pos_bias * self.bias_reg * self.pos_cnt
        sd = sd - self.bias_reg * self.pos_cnt
        self.pos_bias = (self.pos_bias + self.bias_lr * fd
                         / (np.abs(sd) + np.float32(0.001))).astype(
                             np.float32)


class RankXENDCG(ObjectiveFunction):
    """Listwise XE-NDCG (reference ``RankXENDCG``): per-query softmax
    cross entropy against gain targets perturbed by fresh uniform gammas
    each iteration."""

    #: the gammas advance a generator each call
    stochastic_gradients = True

    def init(self, label, weight, device, group=None, position=None):
        super().init(label, weight, device)
        if group is None:
            raise ValueError("rank_xendcg requires query/group information")
        doc_idx, _ = _pad_queries(group)
        valid = doc_idx >= 0
        self.doc_idx = torch.as_tensor(doc_idx, device=device)
        self.valid = torch.as_tensor(valid, device=device)
        label_np = np.asarray(label, np.float64)
        lab = np.zeros(doc_idx.shape, np.float64)
        lab[valid] = label_np[doc_idx[valid]]
        self.phi_base = torch.as_tensor(
            (np.power(2.0, lab) - 1.0).astype(np.float32), device=device)
        # on the CPU: the card's generator would draw another stream
        self.generator = torch.Generator()
        self.generator.manual_seed(int(self.cfg.objective_seed))

    def get_gradients(self, score):
        gammas = torch.rand(self.phi_base.shape, generator=self.generator)
        return xendcg_grads(score, gammas.to(self.phi_base.device),
                            self.doc_idx, self.valid, self.phi_base)

