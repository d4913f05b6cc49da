"""Neural Collaborative Filtering template of the port (NeuMF: GMF + MLP).

Port of ``predictionio_tpu/models/ncf``: training is plain torch
(``model.train_ncf``, Adam on one card), serving scores every item for a
user through kernel B3 (``csrc/ncf_score.cu``, wrapped by
``kernel.ncf_score_all_items``) and ranks on the host; ``batch_predict``
goes through the plain batch scorer. ``convert`` carries a JAX-trained
model in and persists models without pickle.
"""

from predictionio_tpu_torch.models.ncf.convert import (
    load_model,
    model_from_flax,
    model_from_state,
    save_model,
)
from predictionio_tpu_torch.models.ncf.engine import (
    NCFAlgorithm,
    NCFModel,
    NCFPreparator,
    engine_factory,
)

__all__ = [
    "NCFAlgorithm",
    "NCFModel",
    "NCFPreparator",
    "engine_factory",
    "load_model",
    "model_from_flax",
    "model_from_state",
    "save_model",
]
