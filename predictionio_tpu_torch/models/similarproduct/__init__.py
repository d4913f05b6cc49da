"""Similar-product template of the port: item-item cooccurrence over
implicit view/buy events, LLR-weighted, on the card
(``ops/cooccurrence``).

Port of ``predictionio_tpu/models/similarproduct``; ``convert`` holds the
model's pickle-free persistence.
"""

from predictionio_tpu_torch.models.similarproduct.convert import (
    load_model,
    model_from_arrays,
    save_model,
)
from predictionio_tpu_torch.models.similarproduct.engine import (
    CooccurrenceAlgorithm,
    InteractionData,
    SimilarityModel,
    SimilarProductDataSource,
)

__all__ = [
    "CooccurrenceAlgorithm",
    "InteractionData",
    "SimilarProductDataSource",
    "SimilarityModel",
    "load_model",
    "model_from_arrays",
    "save_model",
]
