"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

Slice 1 serves quantized GBDT ensembles (int16/int8 packs) on an NVIDIA
H100 through a hand-written CUDA traversal kernel
(``ops/csrc/traverse.cu``).  Training is still the JAX package's; a model
is carried across as plain arrays with :func:`model_from_arrays`.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no card and no such request they raise.  The
package imports ``torch`` and never ``jax`` or ``lightgbm_tpu``.
"""

from .binning import bin_dataset, mappers_from_arrays, mappers_to_arrays
from .config import Config
from .convert import model_from_arrays
from .models import GBDT, Tree
from .serve import BucketLadder, PredictPlan, Predictor

__all__ = ["BucketLadder", "Config", "GBDT", "PredictPlan", "Predictor",
           "Tree", "bin_dataset", "mappers_from_arrays", "mappers_to_arrays",
           "model_from_arrays"]
