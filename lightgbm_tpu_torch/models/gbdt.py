"""Gradient-boosted decision trees: the serving surface.

The port of the part of the JAX package's ``models/gbdt.py::GBDT`` that
serving reads: the config, class count, init scores, the iteration and
tree counts, the training bin mappers (``train_data.binned``), the host
trees of an iteration range (``host_trees``) and the objective.  Training
comes with a later slice, into this class.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..binning import BinnedData
from ..config import Config
from ..objectives import create_objective
from .tree import Tree


class TrainData:
    """The training-set facts a served model keeps: its bin mappers."""

    def __init__(self, binned: BinnedData):
        self.binned = binned


class GBDT:
    """A trained ensemble: ``models[k][i]`` is class ``k``'s tree of
    iteration ``i``."""

    def __init__(self, cfg: Config, binned: BinnedData,
                 models: List[List[Tree]], init_scores: np.ndarray):
        self.cfg = cfg
        self.num_class = int(cfg.num_class)
        if len(models) != self.num_class:
            raise ValueError(f"{len(models)} tree lists for num_class="
                             f"{self.num_class}")
        if len({len(m) for m in models}) > 1:
            raise ValueError("every class needs the same number of trees")
        self.train_data = TrainData(binned)
        self.models = [list(m) for m in models]
        self.init_scores = np.asarray(init_scores, np.float64).reshape(
            self.num_class).copy()
        self.objective = create_objective(cfg)

    @property
    def iter_(self) -> int:
        return len(self.models[0]) if self.models else 0

    @property
    def num_trees(self) -> int:
        return sum(len(m) for m in self.models)

    def host_trees(self, start: int = 0,
                   end: Optional[int] = None) -> List[List[Tree]]:
        """Per-class host trees of iterations ``[start, end)``."""
        n = self.iter_
        start = max(int(start), 0)
        end = n if end is None else min(int(end), n)
        return [self.models[k][start:end] for k in range(self.num_class)]
