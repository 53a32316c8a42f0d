"""Objective output transforms for the objectives the port serves.

The serving half of the JAX package's ``objectives.py``: only
``convert_output``, for binary (sigmoid scaled by ``cfg.sigmoid``), the
identity regression and multiclass softmax.  Training objectives come with
the training slice.  Inputs are float32 tensors and the transform runs in
float32, as the JAX package runs it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .config import Config


class ObjectiveFunction:
    def __init__(self, name: str, cfg: Config):
        self.name = name
        self.cfg = cfg

    def convert_output(self, score: torch.Tensor) -> torch.Tensor:
        return score


class RegressionL2(ObjectiveFunction):
    """Identity output (``reg_sqrt`` is not ported yet)."""


class Binary(ObjectiveFunction):
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
    """The objective whose output transform serving applies; None for
    ``custom`` (raw margins)."""
    if cfg.objective == "custom":
        return None
    if cfg.objective not in _REGISTRY:
        raise NotImplementedError(
            f"objective {cfg.objective!r} is not served by the port yet "
            "(binary, regression and multiclass are)")
    return _REGISTRY[cfg.objective](cfg.objective, cfg)
