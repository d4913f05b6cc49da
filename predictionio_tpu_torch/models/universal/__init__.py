"""Universal Recommender template of the port: correlated
cross-occurrence over several event types, LLR-weighted, on the card
(``ops/cooccurrence``).

Port of ``predictionio_tpu/models/universal``; ``convert`` holds the
model's pickle-free persistence.
"""

from predictionio_tpu_torch.models.universal.convert import (
    load_model,
    model_from_arrays,
    save_model,
)
from predictionio_tpu_torch.models.universal.engine import (
    MultiEventData,
    URAlgorithm,
    URDataSource,
    URModel,
    engine_factory,
)

__all__ = [
    "MultiEventData",
    "URAlgorithm",
    "URDataSource",
    "URModel",
    "engine_factory",
    "load_model",
    "model_from_arrays",
    "save_model",
]
