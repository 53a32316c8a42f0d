"""Quantized serving on the card: device binning, the frozen plan and the
Predictor front end."""

from .bucketing import BucketLadder
from .metrics import ServeMetrics
from .plan import PredictPlan, cache_stats, clear_plan_cache, plan_for_model
from .predictor import Predictor

__all__ = ["BucketLadder", "PredictPlan", "Predictor", "ServeMetrics",
           "cache_stats", "clear_plan_cache", "plan_for_model"]
