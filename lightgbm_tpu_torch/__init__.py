"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

Slice 1 serves GBDT ensembles through a hand-written CUDA traversal
kernel (``ops/csrc/traverse.cu``, int16/int8 packs) and, since slice 2,
the fp32 pack.  Slice 2 trains binary-logloss GBDT: ``train`` ->
binning -> gradients -> leaf-wise wave growth through the hand-written
CUDA histogram and fused-wave kernels (``ops/csrc/histogram.cu``,
``ops/csrc/wave.cu``) -> model text.  Slice 11 trains every non-ranking
objective (regression family, multiclass softmax / one-vs-all, cross
entropy; K trees an iteration for multiclass) through the same kernels,
and scores valid sets with metrics, callbacks and early stopping.
Slice 12 reads CSV / TSV / LibSVM files (``Dataset(path)``), bins each
feature to its own budget with forced bounds, loads model text
(``Booster(model_file=...)``) and continues training from it
(``train(init_model=...)``).  Slice 13 adds ``cv``, row and feature
sampling (bagging, GOSS on the host or the card, ``feature_fraction``)
and learning to rank (query groups and positions, ``lambdarank``,
``rank_xendcg``, ``ndcg@k`` / ``map@k``).  A config it does not train raises
``NotImplementedError`` naming its ROADMAP item.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no card and no such request they raise.  The
package imports ``torch`` and never ``jax`` or ``lightgbm_tpu``.
"""

from .basic import Booster, Dataset
from .callback import (EarlyStopException, early_stopping, log_evaluation,
                       record_evaluation, reset_parameter)
from .binning import (bin_dataset, load_forced_bins, mappers_from_arrays,
                      mappers_to_arrays)
from .config import Config
from .convert import model_from_arrays
from .engine import cv, train
from .models import GBDT, Tree
from .serialization import LoadedModel, load_model_string
from .serve import BucketLadder, PredictPlan, Predictor

__all__ = ["Booster", "BucketLadder", "Config", "Dataset",
           "EarlyStopException", "GBDT", "LoadedModel", "PredictPlan",
           "Predictor", "Tree", "bin_dataset", "cv", "early_stopping",
           "load_forced_bins", "load_model_string", "log_evaluation",
           "mappers_from_arrays", "mappers_to_arrays", "model_from_arrays",
           "record_evaluation", "reset_parameter", "train"]
