"""Recommendation template of the port: ALS training on the card, and
serving with mips retrieval.

The math lives in ``predictionio_tpu_torch.models._als_common``,
``parallel/als`` and ``ops/``; this package is the DASE packaging and the
model's pickle-free persistence (``convert``).
"""

from predictionio_tpu_torch.models.recommendation.convert import (
    load_model,
    model_from_arrays,
    save_model,
)
from predictionio_tpu_torch.models.recommendation.engine import (
    ALSAlgorithm,
    RatingsData,
    RecommendationDataSource,
    RecommendationModel,
    RecommendationPreparator,
    engine_factory,
)

__all__ = [
    "ALSAlgorithm",
    "RatingsData",
    "RecommendationDataSource",
    "RecommendationModel",
    "RecommendationPreparator",
    "engine_factory",
    "load_model",
    "model_from_arrays",
    "save_model",
]
