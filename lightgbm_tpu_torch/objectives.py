"""Objective functions: output transforms, and the binary training loss.

The port of the JAX package's ``objectives.py`` for the objectives the
port serves (``convert_output`` of binary, regression and multiclass) and
the one it trains: ``Binary`` (reference ``BinaryLogloss``) with its label
check, ``is_unbalance`` / ``scale_pos_weight`` class weights, gradients
as torch ops on the scores' device, and ``boost_from_score`` in host
numpy float64.  Every tensor op runs in float32 in the JAX package's
order.  Other training objectives are refused (ROADMAP A3).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config


class ObjectiveFunction:
    def __init__(self, name: str, cfg: Config):
        self.name = name
        self.cfg = cfg
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
        raise NotImplementedError(
            f"training objective={self.name} is not ported yet (ROADMAP "
            "queue A, item A3); the port trains objective=binary")

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def convert_output(self, score: torch.Tensor) -> torch.Tensor:
        return score


class RegressionL2(ObjectiveFunction):
    """Identity output (``reg_sqrt`` is not ported yet)."""


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
        f32 = lambda v: torch.tensor(np.float32(v), device=score.device)
        sig = f32(self.cfg.sigmoid)
        pos = self.label > 0
        y = torch.where(pos, f32(1.0), f32(-1.0))
        pos_w, neg_w = self.label_weights
        lw = torch.where(pos, f32(pos_w), f32(neg_w))
        response = -y * sig / (1.0 + torch.exp(y * sig * score))
        abs_r = torch.abs(response)
        grad = response * lw
        hess = abs_r * (sig - abs_r) * lw
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


class MulticlassSoftmax(ObjectiveFunction):
    def convert_output(self, score):
        return torch.softmax(score, dim=-1)


_REGISTRY = {
    "regression": RegressionL2,
    "binary": Binary,
    "multiclass": MulticlassSoftmax,
}


def create_objective(cfg: Config) -> Optional[ObjectiveFunction]:
    """The objective of ``cfg``; None for ``custom`` (raw margins).
    Serving uses its ``convert_output``; training its gradients, which
    only ``binary`` has in the port."""
    if cfg.objective == "custom":
        return None
    if cfg.objective not in _REGISTRY:
        raise NotImplementedError(
            f"objective {cfg.objective!r} is not served by the port yet "
            "(binary, regression and multiclass are)")
    return _REGISTRY[cfg.objective](cfg.objective, cfg)
