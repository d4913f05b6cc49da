"""DASE components of the recommendation template, serving half.

Port of ``predictionio_tpu/models/recommendation/engine.py``:
``RecommendationModel`` and the query side of ``ALSAlgorithm``.

Query contract (reference template quickstart):
``{"user": "u1", "num": 4}`` -> ``{"itemScores": [{"item": ..., "score": ...}]}``
plus item-based queries ``{"items": [...], "num": k}`` for similarity.

Only ``seenFilter: "model"`` (the trained-in seen map) is served here;
``"live"`` reads the event store per query, which this slice does not
port, and is refused when the algorithm is built.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from predictionio_tpu_torch.controller.base import Algorithm
from predictionio_tpu_torch.models._als_common import (
    batch_score_known_users,
    partition_user_queries,
    resolve_retrieval,
    retrieval_index,
    score_known_user,
    similar_item_scores,
    topk_item_scores,
)
from predictionio_tpu_torch.parallel.als import ALSModel
from predictionio_tpu_torch.utils.device import resolve_device


@dataclass
class RecommendationModel:
    """Host-side serving model: factor matrices + vocab maps (factors
    stay on the host for the exact re-rank; only the retrieval index
    lives on the device)."""

    als: ALSModel
    user_index: dict[str, int]
    item_ids: list[str]
    item_index: dict[str, int]
    seen: dict[int, set[int]]  # user -> rated item indices (for filtering)


class ALSAlgorithm(Algorithm):
    """ALS serving: scan (host einsum) or mips (the two-stage device
    retrieval of ``ops/mips``) per the ``retrieval`` param.

    ``device`` is where the retrieval index lives: ``cuda`` unless the
    caller names ``"cpu"``; without a card and without an explicit CPU
    request construction raises.
    """

    def __init__(self, params=None, *, device=None):
        super().__init__(params)
        self.device = resolve_device(device)
        seen_mode = self.params.get_or("seenFilter", "model")
        if seen_mode == "live":
            raise NotImplementedError(
                'seenFilter "live" reads the event store per query, which '
                'this port does not serve yet; train with "seenFilter": "model"'
            )
        if seen_mode != "model":
            raise ValueError(
                f"seenFilter must be 'model' or 'live', got {seen_mode!r}"
            )
        # a retrieval typo fails the deploy, not the first query
        self._retrieval = resolve_retrieval(self.params)

    def warm_up(self, model: RecommendationModel) -> None:
        model.als.item_norms  # build the similar-items norm cache at deploy
        # mips mode: pack + upload both retrieval indexes at deploy, not on
        # the first query (dot for user scoring, cosine for similar-items),
        # and search each once: the first search loads the device code of
        # the kernel and the merge, which would otherwise stall a query
        for kind in ("dot", "cosine"):
            index = retrieval_index(
                model.als, self._retrieval, kind=kind, device=self.device
            )
            if index is not None:
                index.search(np.zeros((1, model.als.item_factors.shape[1]), np.float32))

    def predict(self, model: RecommendationModel, query) -> dict:
        num = int(query.get("num", 10))
        if "user" in query:
            return self._recommend_for_user(model, query, num)
        if "items" in query:
            return self._similar_items(model, query, num)
        raise ValueError("query must contain 'user' or 'items'")

    def batch_predict(self, model: RecommendationModel, queries):
        """Bulk scoring: every known-user query of the chunk goes through
        one retrieval search (mips) or one einsum slice (scan); cold users
        and item-similarity queries fall back to predict()."""
        user_rows, fallback = partition_user_queries(model.user_index, queries)
        out = batch_score_known_users(
            model.als,
            user_rows,
            lambda scores, qid, q, user_idx: (
                qid,
                self._topk_response(
                    model, scores, q, int(q.get("num", 10)), user_idx
                ),
            ),
            retrieval=self._retrieval,
            device=self.device,
        )
        out.extend((qid, self.predict(model, q)) for qid, q in fallback)
        return out

    @staticmethod
    def _topk_response(
        model: RecommendationModel, scores: np.ndarray, query, num: int,
        user_idx: int,
    ) -> dict:
        """Shared filter + top-k over one user's item scores (predict and
        the vectorized batch path must rank identically)."""
        # blackList always applies; the seen-items filter is opt-out
        exclude = {
            model.item_index[b]
            for b in (query.get("blackList") or [])
            if b in model.item_index
        }
        if query.get("unseenOnly", True):
            exclude |= model.seen.get(user_idx, set())
        for idx in exclude:
            scores[idx] = -np.inf
        return topk_item_scores(model.item_ids, scores, num)

    def _recommend_for_user(self, model: RecommendationModel, query, num: int) -> dict:
        user_idx = model.user_index.get(str(query["user"]))
        if user_idx is None:
            return {"itemScores": []}  # cold user: reference returns empty
        scores = score_known_user(model.als, user_idx, self._retrieval, device=self.device)
        return self._topk_response(model, scores, query, num, user_idx)

    def _similar_items(self, model: RecommendationModel, query, num: int) -> dict:
        anchors = [
            model.item_index[str(item)]
            for item in query["items"]
            if str(item) in model.item_index
        ]
        if not anchors:
            return {"itemScores": []}
        sims = similar_item_scores(model.als, anchors, self._retrieval, device=self.device)
        for idx in anchors:
            sims[idx] = -np.inf
        return topk_item_scores(model.item_ids, sims, num)
