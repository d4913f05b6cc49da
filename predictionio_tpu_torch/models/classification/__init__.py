"""Classification template of the port: Naive Bayes or logistic
regression (L-BFGS) over labelled text events or entity properties,
trained on the card (``ops/classify``), served on the host.

Port of ``predictionio_tpu/models/classification``; ``convert`` holds the
model's pickle-free persistence and the carry-over of a JAX-trained
model. ``ALGORITHMS`` maps the engine.json algorithm names to their
classes, as the reference's ``engine_factory`` does.
"""

from predictionio_tpu_torch.models.classification.convert import (
    from_reference,
    load_model,
    save_model,
)
from predictionio_tpu_torch.models.classification.engine import (
    ALGORITHMS,
    ClassificationDataSource,
    ClassificationPreparator,
    ClassifierModel,
    FeatureSpace,
    LogisticRegressionAlgorithm,
    NaiveBayesAlgorithm,
    engine_factory,
)

__all__ = [
    "ALGORITHMS",
    "ClassificationDataSource",
    "ClassificationPreparator",
    "ClassifierModel",
    "FeatureSpace",
    "LogisticRegressionAlgorithm",
    "NaiveBayesAlgorithm",
    "engine_factory",
    "from_reference",
    "load_model",
    "save_model",
]
