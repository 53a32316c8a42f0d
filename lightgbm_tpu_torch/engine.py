"""Training entry point: ``train``.

The port of the JAX package's ``engine.py::train`` for the binary
training slice: ``params``, ``train_set``, ``num_boost_round`` and the
port's ``device``.  ``num_iterations`` / ``num_boost_round`` in
``params`` win over the argument, as in the JAX package.  Valid sets,
callbacks, early stopping, ``feval``, ``init_model`` and checkpoints are
later work (ROADMAP A5c, A8.9, A11): passing any of them raises.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

from .basic import Booster, Dataset


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100, *, device=None, **kwargs) -> Booster:
    """Train a booster on ``device`` (the CUDA card unless ``"cpu"``)."""
    given = sorted(k for k, v in kwargs.items() if v is not None)
    if given:
        raise NotImplementedError(
            f"train options {given} are not ported to lightgbm_tpu_torch "
            "yet (ROADMAP A5c: valid sets, callbacks, early stopping)")
    if callable(params.get("objective")):
        raise NotImplementedError(
            "a callable objective is not ported yet; pass fobj to "
            "Booster.update")
    params = copy.deepcopy(params)
    if "num_iterations" in params or "num_boost_round" in params:
        num_boost_round = int(params.pop("num_boost_round",
                              params.pop("num_iterations", num_boost_round)))
    booster = Booster(params=params, train_set=train_set, device=device)
    for _ in range(num_boost_round):
        if booster.update():
            break
    return booster
