"""DASE controller API of the port (``predictionio_tpu/controller``): the
reference's 25 names, and ``TrainContext``, the port's stand-in for the
reference's ``RuntimeContext``."""

from predictionio_tpu_torch.controller.base import (
    Algorithm,
    DataSource,
    EmptyParams,
    EngineFactory,
    EvalInfo,
    IdentityPreparator,
    Params,
    PersistentModel,
    Preparator,
    SanityCheck,
    Serving,
    TPUAlgorithm,
    TrainContext,
)
from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.controller.serving import AverageServing, FirstServing
from predictionio_tpu_torch.controller.metrics import (
    AverageMetric,
    Evaluation,
    EngineParamsGenerator,
    Metric,
    MetricEvaluator,
    OptionAverageMetric,
    StdevMetric,
    SumMetric,
    ZeroMetric,
)

__all__ = [
    "Algorithm",
    "AverageMetric",
    "AverageServing",
    "DataSource",
    "EmptyParams",
    "Engine",
    "EngineFactory",
    "EngineParams",
    "EngineParamsGenerator",
    "EvalInfo",
    "Evaluation",
    "FirstServing",
    "IdentityPreparator",
    "Metric",
    "MetricEvaluator",
    "OptionAverageMetric",
    "Params",
    "PersistentModel",
    "Preparator",
    "SanityCheck",
    "Serving",
    "StdevMetric",
    "SumMetric",
    "TPUAlgorithm",
    "TrainContext",
    "ZeroMetric",
]
