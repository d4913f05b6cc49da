"""ALS factor model: the serving half of ``predictionio_tpu/parallel/als.py``.

Holds ``ALSModel`` only for now (reference ``parallel/als.py:791-837``);
``als_fit`` and its half-step kernel come with the training slice. The
factors stay host numpy arrays and the per-user scoring stays
``np.einsum``: the mips shortlist's host re-rank
(``models/_als_common._host_rerank``) replays exactly this arithmetic, so
a shortlist holding the true top-k gives a response byte-identical to
the scan's.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ALSModel:
    user_factors: np.ndarray  # [num_users, K]
    item_factors: np.ndarray  # [num_items, K]
    #: lazily-built catalog norm cache -- similar_items is called once per
    #: anchor at serving time and must not rescan item_factors every call
    _item_norms: np.ndarray | None = field(
        default=None, init=False, repr=False, compare=False
    )
    #: lazily-built device retrieval indexes (``ops/mips.RetrievalIndex``),
    #: keyed by (kind, RetrievalConfig, device) -- see
    #: ``models/_als_common.retrieval_index``
    _retrieval_cache: dict | None = field(
        default=None, init=False, repr=False, compare=False
    )

    def __getstate__(self):
        # device tensors never enter a serialized model: indexes rebuild
        # at deploy (``warm_up``)
        state = self.__dict__.copy()
        state["_retrieval_cache"] = None
        return state

    def score_items_for_user(self, user_index: int) -> np.ndarray:
        # einsum, not @: BLAS sgemv picks its kernel by matrix height, so a
        # gathered-row product is a ULP off the full one -- einsum's per-row
        # reduction is height-independent, which lets the mips shortlist
        # re-rank (_als_common._host_rerank) reproduce these scores bitwise
        return np.einsum("ik,k->i", self.item_factors, self.user_factors[user_index])

    @property
    def item_norms(self) -> np.ndarray:
        if self._item_norms is None:
            self._item_norms = np.linalg.norm(self.item_factors, axis=1)
        return self._item_norms

    def similar_items(self, item_index: int) -> np.ndarray:
        """Cosine scores of all items against one (ALS-space similarity).

        einsum for the same reason as ``score_items_for_user``: the mips
        shortlist replays this row arithmetic and must land bitwise."""
        v = self.item_factors[item_index]
        norms = self.item_norms * (self.item_norms[item_index] + 1e-12)
        return np.einsum("ik,k->i", self.item_factors, v) / np.maximum(norms, 1e-12)
