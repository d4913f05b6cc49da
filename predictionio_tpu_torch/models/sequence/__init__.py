"""Sequential-recommendation template of the port (SASRec-style).

Port of ``predictionio_tpu/models/sequence``: ``model.train_sasrec``
trains the causal transformer with Adam on one card, its attention
through the flash kernels B4 (forward), B5 and B6 (backward) of
``ops/flash_attention`` (``csrc/flash_attention.cu``); serving runs B4 in
every transformer block and ranks on the host. ``convert`` carries a
JAX-trained model in and persists models without pickle.
"""

from predictionio_tpu_torch.models.sequence.convert import (
    load_model,
    model_from_flax,
    model_from_state,
    save_model,
)
from predictionio_tpu_torch.models.sequence.engine import (
    SASRecAlgorithm,
    SASRecModel,
    SequenceDataSource,
    SequencePreparator,
    SequencesData,
    engine_factory,
)
from predictionio_tpu_torch.models.sequence.model import (
    SASRec,
    SASRecConfig,
    score_next_items,
    train_sasrec,
)

__all__ = [
    "SASRec",
    "SASRecAlgorithm",
    "SASRecConfig",
    "SASRecModel",
    "SequenceDataSource",
    "SequencePreparator",
    "SequencesData",
    "engine_factory",
    "load_model",
    "model_from_flax",
    "model_from_state",
    "save_model",
    "score_next_items",
    "train_sasrec",
]
