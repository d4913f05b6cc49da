"""Recommendation template of the port: ALS serving with mips retrieval.

The math of scoring lives in ``predictionio_tpu_torch.models._als_common``
and ``ops/mips``; this package is the DASE packaging and the model's
pickle-free persistence (``convert``).
"""

from predictionio_tpu_torch.models.recommendation.convert import (
    load_model,
    model_from_arrays,
    save_model,
)
from predictionio_tpu_torch.models.recommendation.engine import (
    ALSAlgorithm,
    RecommendationModel,
)

__all__ = [
    "ALSAlgorithm",
    "RecommendationModel",
    "load_model",
    "model_from_arrays",
    "save_model",
]
