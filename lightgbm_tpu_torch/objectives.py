"""Objective functions: the training losses and their output transforms.

The port of the JAX package's ``objectives.py`` (reference
``objective_function.h`` and the per-family headers) for every
non-ranking objective: the regression family (``RegressionL2`` with
``reg_sqrt``, ``RegressionL1``, ``Huber``, ``Fair``, ``Poisson``,
``Quantile``, ``MAPE``, ``Gamma``, ``Tweedie``), ``Binary``, the
multiclass pair (``MulticlassSoftmax``, ``MulticlassOVA``: K trees an
iteration, (N, K) scores) and the cross-entropy pair.  Each keeps the JAX
package's flags (``num_model_per_iteration``, ``is_constant_hessian``,
``need_renew_tree_output``), label checks, ``boost_from_score`` in host
numpy float64, and ``renew_leaf_values`` (the percentile leaf refit of
L1 / Huber / Quantile / MAPE) in host numpy, verbatim.  ``get_gradients``
runs as torch ops on the scores' device, in float32 and in the JAX
package's order, so gradients without an ``exp`` are bit for bit the
JAX package's.  The ranking objectives (``lambdarank``, ``rank_xendcg``)
live in ``ranking.py``; ``create_objective`` makes them too, and their
``init`` also takes the training data's query groups and positions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as the float32 scalar JAX makes of it in an f32
    expression (weak typing: the value is rounded to f32 once)."""
    return torch.tensor(np.float32(value), device=like.device)


class ObjectiveFunction:
    """Base objective (reference ``objective_function.h``)."""

    is_constant_hessian = False
    need_renew_tree_output = False
    #: True where ``get_gradients`` advances host state (a generator), so
    #: device GOSS under ``tpu_device_goss=auto`` keeps the host sampler,
    #: as the JAX package's unfused path does
    stochastic_gradients = False

    def __init__(self, name: str, cfg: Config):
        self.name = name
        self.cfg = cfg
        self.num_model_per_iteration = 1
        self.label: Optional[torch.Tensor] = None
        self.weight: Optional[torch.Tensor] = None

    def init(self, label: np.ndarray, weight: Optional[np.ndarray],
             device: torch.device) -> None:
        """Keep the label and weights as float32 tensors on ``device``."""
        self.label = torch.as_tensor(np.asarray(label, np.float32),
                                     device=device)
        self.weight = (None if weight is None else torch.as_tensor(
            np.asarray(weight, np.float32), device=device))

    def _apply_weight(self, grad, hess):
        if self.weight is None:
            return grad, hess
        return grad * self.weight, hess * self.weight

    def _np_label(self) -> np.ndarray:
        return self.label.cpu().numpy()

    def _np_weight(self) -> Optional[np.ndarray]:
        return None if self.weight is None else self.weight.cpu().numpy()

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def convert_output(self, score: torch.Tensor) -> torch.Tensor:
        return score

    def renew_leaf_values(self, score: np.ndarray, row_leaf: np.ndarray,
                          num_leaves: int) -> Optional[np.ndarray]:
        """Per-leaf output refit after the tree is grown (reference
        ``RenewTreeOutput``); None where the objective keeps its leaves."""
        return None


def _check_label_range(label, name: str, lo: float = 0.0,
                       strict: bool = False) -> None:
    """Reference per-objective ``CheckLabel``: a label the loss is
    undefined for fails at init, not as a NaN gradient mid-run."""
    lab = np.asarray(label, np.float64)
    bad = (lab <= lo) if strict else (lab < lo)
    if lab.size and bad.any():
        op = ">" if strict else ">="
        raise ValueError(
            f"objective={name} requires labels {op} {lo:g}; found "
            f"minimum {lab.min():g}")


def _weighted_percentile(values: np.ndarray, weight: Optional[np.ndarray],
                         alpha: float) -> float:
    """Reference ``PercentileFun`` / ``WeightedPercentileFun``
    (``regression_objective.hpp:27-76``)."""
    if len(values) == 0:
        return 0.0
    order = np.argsort(values)
    v = values[order]
    if weight is None:
        # position alpha*(n-1) with linear interpolation
        pos = alpha * (len(v) - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, len(v) - 1)
        frac = pos - lo
        return float(v[lo] * (1 - frac) + v[hi] * frac)
    w = weight[order]
    cum = np.cumsum(w)
    threshold = alpha * cum[-1]
    idx = int(np.searchsorted(cum, threshold, side="left"))
    return float(v[min(idx, len(v) - 1)])


def _renew_by_percentile(residual_fn, alpha: float):
    def renew(self: ObjectiveFunction, score: np.ndarray,
              row_leaf: np.ndarray, num_leaves: int) -> np.ndarray:
        label = self._np_label()
        weight = self._np_weight()
        res = residual_fn(self, label, score)
        out = np.zeros(num_leaves, np.float64)
        order = np.argsort(row_leaf, kind="stable")
        sorted_leaf = row_leaf[order]
        bounds = np.searchsorted(sorted_leaf, np.arange(num_leaves + 1))
        for leaf in range(num_leaves):
            sel = order[bounds[leaf]: bounds[leaf + 1]]
            if len(sel) == 0:
                continue
            w = None if weight is None else weight[sel]
            out[leaf] = _weighted_percentile(res[sel], w, alpha)
        return out
    return renew


def _residual(self, label, score):
    return label - score


def _mean(label: np.ndarray, w: Optional[np.ndarray]):
    return np.average(label, weights=w) if w is not None else np.mean(label)


# ------------------------------------------------------------- regression
class RegressionL2(ObjectiveFunction):
    """Reference ``RegressionL2loss``; ``reg_sqrt`` fits on
    ``sign(y) * sqrt(|y|)`` and squares predictions back."""

    is_constant_hessian = True

    def __init__(self, name, cfg):
        super().__init__(name, cfg)
        self.sqrt = bool(cfg.reg_sqrt)

    def init(self, label, weight, device):
        super().init(label, weight, device)
        if self.sqrt:
            self.label = torch.sign(self.label) * torch.sqrt(
                torch.abs(self.label))

    def get_gradients(self, score):
        grad = score - self.label
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def convert_output(self, score):
        if self.sqrt:
            return torch.sign(score) * score * score
        return score

    def boost_from_score(self, class_id: int = 0) -> float:
        label = self._np_label()
        w = self._np_weight()
        if w is None:
            return float(np.mean(label))
        return float(np.average(label, weights=w))


class RegressionL1(ObjectiveFunction):
    """Reference ``RegressionL1loss``: constant gradients, median leaf
    refit."""

    is_constant_hessian = True
    need_renew_tree_output = True

    def get_gradients(self, score):
        grad = torch.sign(score - self.label)
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        return _weighted_percentile(self._np_label(), self._np_weight(), 0.5)

    renew_leaf_values = _renew_by_percentile(_residual, 0.5)


class Huber(ObjectiveFunction):
    """Reference ``RegressionHuberLoss``: delta = ``alpha``."""

    is_constant_hessian = True
    need_renew_tree_output = True

    def get_gradients(self, score):
        alpha = _f32(self.cfg.alpha, score)
        grad = torch.clamp(score - self.label, -alpha, alpha)
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        return _weighted_percentile(self._np_label(), self._np_weight(), 0.5)

    renew_leaf_values = _renew_by_percentile(_residual, 0.5)


class Fair(ObjectiveFunction):
    """Reference ``RegressionFairLoss``: c = ``fair_c``."""

    def get_gradients(self, score):
        c = self.cfg.fair_c
        x = score - self.label
        d = torch.abs(x) + _f32(c, score)
        grad = _f32(c, score) * x / d
        hess = _f32(c * c, score) / (d * d)
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        return _weighted_percentile(self._np_label(), self._np_weight(), 0.5)


class Poisson(ObjectiveFunction):
    """Reference ``RegressionPoissonLoss``: log link; the hessian is
    inflated by ``poisson_max_delta_step``."""

    def init(self, label, weight, device):
        super().init(label, weight, device)
        _check_label_range(label, self.name, lo=0.0)

    def get_gradients(self, score):
        grad = torch.exp(score) - self.label
        hess = torch.exp(score + _f32(self.cfg.poisson_max_delta_step,
                                      score))
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        mean = _mean(self._np_label(), self._np_weight())
        return float(np.log(max(mean, 1e-20)))

    def convert_output(self, score):
        return torch.exp(score)


class Quantile(ObjectiveFunction):
    """Reference ``RegressionQuantileloss``: pinball loss at ``alpha``."""

    is_constant_hessian = True
    need_renew_tree_output = True

    def get_gradients(self, score):
        alpha = self.cfg.alpha
        grad = torch.where(score - self.label >= 0,
                           _f32(1.0 - alpha, score), _f32(-alpha, score))
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        return _weighted_percentile(self._np_label(), self._np_weight(),
                                    self.cfg.alpha)

    def renew_leaf_values(self, score, row_leaf, num_leaves):
        return _renew_by_percentile(_residual, self.cfg.alpha)(
            self, score, row_leaf, num_leaves)


class MAPE(ObjectiveFunction):
    """Reference ``RegressionMAPELOSS``: L1 with 1/|label| sample
    weights."""

    is_constant_hessian = True
    need_renew_tree_output = True

    def init(self, label, weight, device):
        super().init(label, weight, device)
        scale = 1.0 / torch.clamp_min(torch.abs(self.label), 1.0)
        self.weight = scale if self.weight is None else self.weight * scale

    def get_gradients(self, score):
        grad = torch.sign(score - self.label)
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        return _weighted_percentile(self._np_label(), self._np_weight(), 0.5)

    renew_leaf_values = _renew_by_percentile(_residual, 0.5)


class Gamma(ObjectiveFunction):
    """Reference ``RegressionGammaLoss``: log-link gamma deviance."""

    def init(self, label, weight, device):
        super().init(label, weight, device)
        _check_label_range(label, self.name, lo=0.0, strict=True)

    def get_gradients(self, score):
        e = torch.exp(-score)
        grad = 1.0 - self.label * e
        hess = self.label * e
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        mean = _mean(self._np_label(), self._np_weight())
        return float(np.log(max(mean, 1e-20)))

    def convert_output(self, score):
        return torch.exp(score)


class Tweedie(ObjectiveFunction):
    """Reference ``RegressionTweedieLoss``: power
    ``tweedie_variance_power``."""

    def init(self, label, weight, device):
        super().init(label, weight, device)
        _check_label_range(label, self.name, lo=0.0)

    def get_gradients(self, score):
        rho = self.cfg.tweedie_variance_power
        c1, c2 = _f32(1.0 - rho, score), _f32(2.0 - rho, score)
        e1 = torch.exp(c1 * score)
        e2 = torch.exp(c2 * score)
        grad = -self.label * e1 + e2
        hess = -self.label * c1 * e1 + c2 * e2
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        mean = _mean(self._np_label(), self._np_weight())
        return float(np.log(max(mean, 1e-20)))

    def convert_output(self, score):
        return torch.exp(score)


# ----------------------------------------------------------------- binary
def _logistic_grads(label_pm1, score, sig, lw=None):
    """Reference ``BinaryLogloss::GetGradients`` for y in {-1, +1}."""
    response = -label_pm1 * sig / (1.0 + torch.exp(label_pm1 * sig * score))
    abs_r = torch.abs(response)
    if lw is None:
        return response, abs_r * (sig - abs_r)
    return response * lw, abs_r * (sig - abs_r) * lw


class Binary(ObjectiveFunction):
    """Reference ``BinaryLogloss``: labels {0, 1}, sigmoid scaling,
    ``is_unbalance`` / ``scale_pos_weight`` class weights."""

    def init(self, label, weight, device):
        label01 = np.asarray(label)
        if label01.size and not np.isin(label01, (0.0, 1.0)).all():
            raise ValueError(
                "objective=binary requires labels in {0, 1}; found values "
                f"outside (e.g. "
                f"{label01[~np.isin(label01, (0.0, 1.0))][:4].tolist()})")
        super().init(label, weight, device)
        npos = float((label01 > 0).sum())
        nneg = float(len(label01) - npos)
        if self.cfg.is_unbalance and npos > 0 and nneg > 0:
            if npos > nneg:
                self.label_weights = (1.0, npos / nneg)   # (pos_w, neg_w)
            else:
                self.label_weights = (nneg / npos, 1.0)
        else:
            self.label_weights = (self.cfg.scale_pos_weight, 1.0)

    def get_gradients(self, score):
        f32 = lambda v: _f32(v, score)
        pos = self.label > 0
        y = torch.where(pos, f32(1.0), f32(-1.0))
        pos_w, neg_w = self.label_weights
        lw = torch.where(pos, f32(pos_w), f32(neg_w))
        grad, hess = _logistic_grads(y, score, f32(self.cfg.sigmoid), lw)
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        label = self._np_label()
        w = self._np_weight()
        pos = (label > 0).astype(np.float64)
        pavg = np.average(pos, weights=w) if w is not None else np.mean(pos)
        pavg = min(max(pavg, 1e-15), 1 - 1e-15)
        return float(np.log(pavg / (1.0 - pavg)) / self.cfg.sigmoid)

    def convert_output(self, score):
        return 1.0 / (1.0 + torch.exp(-self.cfg.sigmoid * score))


# ------------------------------------------------------------- multiclass
def _check_multiclass_labels(label, num_class: int, name: str) -> np.ndarray:
    """Labels must lie in [0, num_class) (reference
    ``multiclass_objective.hpp:62-64``)."""
    lab = np.asarray(label, np.int64)
    if lab.size and (lab.min() < 0 or lab.max() >= num_class):
        raise ValueError(
            f"{name} labels must be in [0, {num_class}); found "
            f"range [{lab.min()}, {lab.max()}]")
    return lab


def _softmax(score: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: exp(x - max) / sum."""
    e = torch.exp(score - score.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


class _Multiclass(ObjectiveFunction):
    """K trees an iteration over (N, K) scores."""

    def __init__(self, name, cfg):
        super().__init__(name, cfg)
        self.num_model_per_iteration = cfg.num_class

    def init(self, label, weight, device):
        super().init(label, weight, device)
        lab = _check_multiclass_labels(label, self.cfg.num_class, self.name)
        self.onehot = torch.nn.functional.one_hot(
            torch.as_tensor(lab, device=device),
            self.cfg.num_class).to(torch.float32)
        return lab

    def _weighted(self, grad, hess):
        if self.weight is None:
            return grad, hess
        return grad * self.weight[:, None], hess * self.weight[:, None]


class MulticlassSoftmax(_Multiclass):
    """Reference ``MulticlassSoftmax``."""

    def init(self, label, weight, device):
        lab = super().init(label, weight, device)
        k = self.cfg.num_class
        # Friedman's rescale (reference multiclass_objective.hpp:31)
        self.factor = k / (k - 1.0)
        # weighted class priors for boost-from-average
        w = (np.ones(len(label)) if weight is None
             else np.asarray(weight, np.float64))
        counts = np.zeros(k)
        np.add.at(counts, lab, w)
        self.class_init_probs = counts / max(w.sum(), 1e-300)

    def get_gradients(self, score):  # score: (N, K)
        p = _softmax(score)
        grad = p - self.onehot
        hess = _f32(self.factor, score) * p * (1.0 - p)
        return self._weighted(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        return float(np.log(max(1e-15, self.class_init_probs[class_id])))

    def convert_output(self, score):
        return _softmax(score)


class MulticlassOVA(_Multiclass):
    """Reference ``MulticlassOVA``: K independent binary objectives."""

    def get_gradients(self, score):
        y = 2.0 * self.onehot - 1.0
        grad, hess = _logistic_grads(y, score, _f32(self.cfg.sigmoid, score))
        return self._weighted(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        label = self._np_label()
        w = self._np_weight()
        pos = (label.astype(np.int64) == class_id).astype(np.float64)
        pavg = np.average(pos, weights=w) if w is not None else np.mean(pos)
        pavg = min(max(pavg, 1e-15), 1 - 1e-15)
        return float(np.log(pavg / (1.0 - pavg)) / self.cfg.sigmoid)

    def convert_output(self, score):
        return 1.0 / (1.0 + torch.exp(-self.cfg.sigmoid * score))


# ---------------------------------------------------------- cross entropy
class CrossEntropy(ObjectiveFunction):
    """Reference ``CrossEntropy`` (``xentropy_objective.hpp``): labels in
    [0, 1]."""

    def get_gradients(self, score):
        p = torch.sigmoid(score)
        grad = p - self.label
        hess = p * (1.0 - p)
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        pavg = _mean(self._np_label(), self._np_weight())
        pavg = min(max(float(pavg), 1e-15), 1 - 1e-15)
        return float(np.log(pavg / (1.0 - pavg)))

    def convert_output(self, score):
        return torch.sigmoid(score)


class CrossEntropyLambda(ObjectiveFunction):
    """Reference ``CrossEntropyLambda``: the loss on the 1 - exp(-lambda)
    scale, with intensity weights."""

    def get_gradients(self, score):
        w = torch.ones_like(self.label) if self.weight is None else self.weight
        tiny = _f32(1e-15, score)
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = torch.exp(-score)
        grad = (1.0 - self.label / torch.maximum(z, tiny) * w) / (1.0 + enf)
        c = 1.0 / torch.maximum(1.0 - z, tiny)
        d = 1.0 + epf
        a = w * epf / torch.maximum(z * d, tiny)
        hess = (1.0 - self.label * c * a * (1.0 / torch.maximum(d, tiny)
                + (1.0 - a * (1.0 - z)))) * epf / (d * d)
        return grad, torch.maximum(hess, tiny)

    def boost_from_score(self, class_id: int = 0) -> float:
        pavg = float(np.mean(self._np_label()))
        return float(np.log(max(np.expm1(max(pavg, 1e-15)), 1e-15)))

    def convert_output(self, score):
        return torch.log1p(torch.exp(score))


_REGISTRY = {
    "regression": RegressionL2,
    "regression_l1": RegressionL1,
    "huber": Huber,
    "fair": Fair,
    "poisson": Poisson,
    "quantile": Quantile,
    "mape": MAPE,
    "gamma": Gamma,
    "tweedie": Tweedie,
    "binary": Binary,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
}

#: the learning-to-rank objectives (``ranking.py``): they read the
#: training data's query groups and positions
RANKING = ("lambdarank", "rank_xendcg")


def create_objective(cfg: Config) -> Optional[ObjectiveFunction]:
    """The objective of ``cfg`` (reference factory
    ``objective_function.cpp:20``); None for ``custom`` (raw margins)."""
    if cfg.objective == "custom":
        return None
    if cfg.objective in RANKING:
        from .ranking import LambdaRankNDCG, RankXENDCG
        cls = {"lambdarank": LambdaRankNDCG,
               "rank_xendcg": RankXENDCG}[cfg.objective]
        return cls(cfg.objective, cfg)
    if cfg.objective not in _REGISTRY:
        raise ValueError(f"unknown objective: {cfg.objective}")
    return _REGISTRY[cfg.objective](cfg.objective, cfg)
