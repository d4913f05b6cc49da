"""E-commerce template of the port: implicit ALS on the card (B1) with
serving-time business rules, mips retrieval through B2.

Port of ``predictionio_tpu/models/ecommerce``; ``convert`` holds the
model's pickle-free persistence.
"""

from predictionio_tpu_torch.models.ecommerce.convert import (
    load_model,
    model_from_arrays,
    save_model,
)
from predictionio_tpu_torch.models.ecommerce.engine import (
    ECommAlgorithm,
    ECommerceData,
    ECommerceDataSource,
    ECommerceModel,
    ECommercePreparator,
    engine_factory,
)

__all__ = [
    "ECommAlgorithm",
    "ECommerceData",
    "ECommerceDataSource",
    "ECommerceModel",
    "ECommercePreparator",
    "engine_factory",
    "load_model",
    "model_from_arrays",
    "save_model",
]
