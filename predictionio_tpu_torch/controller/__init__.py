"""DASE controller API of the port."""

from predictionio_tpu_torch.controller.base import (
    Algorithm,
    DataSource,
    Params,
    Preparator,
    SanityCheck,
    Serving,
    TrainContext,
)
from predictionio_tpu_torch.controller.serving import FirstServing

__all__ = [
    "Algorithm",
    "DataSource",
    "FirstServing",
    "Params",
    "Preparator",
    "SanityCheck",
    "Serving",
    "TrainContext",
]
