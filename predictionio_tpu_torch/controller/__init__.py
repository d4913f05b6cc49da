"""DASE controller API of the port."""

from predictionio_tpu_torch.controller.base import (
    Algorithm,
    DataSource,
    EvalInfo,
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
    "EvalInfo",
    "FirstServing",
    "Params",
    "Preparator",
    "SanityCheck",
    "Serving",
    "TrainContext",
]
