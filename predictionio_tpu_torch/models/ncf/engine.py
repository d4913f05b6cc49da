"""DASE components of the Neural-CF template.

Port of ``predictionio_tpu/models/ncf/engine.py``. Query contract as in
the recommendation template: ``{"user": "u1", "num": 4}`` ->
``{"itemScores": [...]}``, with ``blackList`` and ``unseenOnly``.

- ``NCFPreparator`` hands the COO ratings on unchanged.
- ``NCFAlgorithm.train`` samples negatives (implicit mode), trains
  ``train_ncf`` on the algorithm's device with per-epoch checkpoints,
  over ``ctx.mesh`` in a multi-process launch (batch over ``data``,
  params over ``model``; every rank returns the gathered full params, and
  rank 0 persists them), and keeps the seen map.
- ``predict`` scores every item through ``NCFModel.scorer``: kernel B3
  when ``usePallas`` is on (the default on ``cuda``), else the batch
  scorer at a bucket of one. ``batch_predict`` scores chunks of known
  users through the plain batch scorer.

The reference's ``_pallas_with_fallback`` and its numpy fallback are not
ported: a model served on the card launches B3 or raises.
``seenFilter: "live"`` reads the user's events from the store per query
(``models/_streaming.py``), as in ``ALSAlgorithm``: when the model was
trained so, or the serving engine.json asks for it. A model trained on
an evaluation fold (``RatingsData.eval_fold``: ``pio eval``, ``pio eval
--replay``) keeps the trained-in map instead and never reads live
(reference ``:230``): the store still holds the fold's held-out events.
The template shares ``RecommendationDataSource``, so it has its
``read_eval`` and ``read_replay``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

from predictionio_tpu_torch.controller.base import Algorithm, Preparator, mesh_or_none
from predictionio_tpu_torch.models._als_common import (
    build_seen,
    partition_user_queries,
    score_buffer_rows,
    topk_item_scores,
)
from predictionio_tpu_torch.models._streaming import live_seen_indices
from predictionio_tpu_torch.models.ncf.kernel import (
    all_items_scorer,
    batch_scorer,
    head_tensors,
)
from predictionio_tpu_torch.models.ncf.model import (
    NCFConfig,
    make_implicit_batches,
    train_ncf,
)
from predictionio_tpu_torch.models.recommendation.engine import RatingsData
from predictionio_tpu_torch.utils.device import resolve_device

#: guards first-query scorer construction across serving threads
#: (reentrant: a scorer builds through the device tables under the same
#: lock)
_SCORER_BUILD_LOCK = threading.RLock()


class NCFPreparator(Preparator):
    """NCF consumes the COO directly; no CSR packing needed."""

    def prepare(self, ctx, training_data: RatingsData) -> RatingsData:
        from predictionio_tpu_torch.models._streaming import StreamingHandle

        if isinstance(training_data, StreamingHandle):
            # NCF shares RecommendationDataSource, whose '"reader":
            # "streaming"' mode hands back a handle with no edge arrays;
            # NCF's SGD needs the materialized COO (reference
            # models/ncf/engine.py:46-55)
            raise ValueError(
                "the NCF template does not support the streaming sharded "
                'reader; remove "reader": "streaming" from the datasource '
                "params (NCF training consumes the materialized COO arrays)"
            )
        return training_data


@dataclass
class NCFModel:
    """The trained ``NeuMF`` state dict (host f32 tensors), the id
    vocabularies, the seen map and the training config. The tables and
    weights go to a device once (``device_tensors``), and both scorers
    of that device are built over that one copy, lazily, once per
    (device, kind); none of it is persisted (``convert.save_model``
    writes arrays and JSON)."""

    state: dict
    user_index: dict[str, int]
    item_ids: list[str]
    item_index: dict[str, int]
    seen: dict[int, set[int]]
    config: NCFConfig
    #: "model": the seen map above; "live": per-query event-store read
    #: (``app_name`` / ``event_names`` say what to read), no seen map
    seen_mode: str = "model"
    app_name: str = ""
    event_names: list[str] = None
    #: trained on an evaluation fold: never filters live (not persisted)
    eval_fold: bool = False
    _scorers: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    def _cached(self, key, build):
        # the query server is a ThreadingHTTPServer: concurrent first
        # queries must not each upload the tables (double-checked under
        # a module lock)
        found = self._scorers.get(key)
        if found is None:
            with _SCORER_BUILD_LOCK:
                found = self._scorers.get(key)
                if found is None:
                    found = build()
                    self._scorers[key] = found
        return found

    def device_tensors(self, device):
        """``head_tensors`` of the model on ``device``, uploaded once."""
        return self._cached(
            ("tensors", str(device)),
            lambda: head_tensors(self.state, len(self.item_ids), device),
        )

    def scorer(self, device, use_kernel: bool):
        """``score(user_index) -> np [I]`` on ``device``: the all-items
        scorer (B3 at depth 2) when ``use_kernel``, else the batch
        scorer at a bucket of one, so single and batched answers are the
        same program."""
        if use_kernel:
            return self._cached(
                ("kernel", str(device)),
                lambda: all_items_scorer(self.device_tensors(device)),
            )
        batch = self.batch_scorer(device)
        return lambda u: batch(np.asarray([u], np.int64))[0]

    def batch_scorer(self, device):
        """``scores(user_indices) -> np [U, I]`` on ``device`` (plain torch)."""
        return self._cached(
            ("batch", str(device)),
            lambda: batch_scorer(self.device_tensors(device)),
        )


class NCFAlgorithm(Algorithm):
    """Params: embedDim, hidden, learningRate, epochs, batchSize,
    implicit, negatives, seed, checkpoint (per-epoch checkpoints,
    default on), seenFilter ("model" or "live") and usePallas (serve through
    kernel B3; default on when the device is ``cuda``).

    ``device`` is where training runs and the scorers live: ``cuda``
    unless the caller names ``"cpu"``; without a card and without an
    explicit CPU request construction raises."""

    def __init__(self, params=None, *, device=None):
        super().__init__(params)
        self.device = resolve_device(device)
        self.seen_mode = self.params.get_or("seenFilter", "model")
        if self.seen_mode not in ("model", "live"):
            raise ValueError(
                f"seenFilter must be 'model' or 'live', got {self.seen_mode!r}"
            )
        self.use_kernel = bool(self.params.get_or("usePallas", self.device.type == "cuda"))

    def _config(self, data: RatingsData) -> NCFConfig:
        p = self.params
        return NCFConfig(
            num_users=data.num_users,
            num_items=data.num_items,
            embed_dim=p.get_or("embedDim", 32),
            hidden=tuple(p.get_or("hidden", [64, 32])),
            learning_rate=p.get_or("learningRate", 0.01),
            implicit=p.get_or("implicit", False),
            negatives=p.get_or("negatives", 4),
            batch_size=p.get_or("batchSize", 4096),
            epochs=p.get_or("epochs", 5),
            seed=p.get_or("seed", 0),
        )

    def train(self, ctx, data: RatingsData) -> NCFModel:
        config = self._config(data)
        users, items, labels = data.users, data.items, data.ratings
        # the mesh first: a rank's card is set when it joins the launch
        mesh = mesh_or_none(ctx)
        device = mesh.device if mesh is not None and mesh.size > 1 else self.device
        checkpoint = (
            ctx.checkpoint_manager("ncf") if self.params.get_or("checkpoint", True) else None
        )
        with ctx.journal("ncf") as telemetry:
            if config.implicit:
                t0 = time.perf_counter()
                users, items, labels = make_implicit_batches(
                    users, items, data.num_items, config.negatives,
                    np.random.default_rng(config.seed), device=device,
                )
                if telemetry is not None:
                    telemetry.record_phase(
                        "negative_sampling", time.perf_counter() - t0, int(users.size)
                    )
            state, _ = train_ncf(
                config, users, items, labels, self.device, checkpoint=checkpoint,
                mesh=mesh, telemetry=telemetry,
            )
        seen_mode = self.seen_mode
        if seen_mode == "live" and data.eval_fold:
            # a live read would -inf every held-out item (they still exist
            # in the store) and zero eval metrics; fold data carries its
            # train edges, so the trained-in map is correct there
            seen_mode = "model"
        return NCFModel(
            state=state,
            user_index={uid: j for j, uid in enumerate(data.user_ids)},
            item_ids=list(data.item_ids),
            item_index={iid: j for j, iid in enumerate(data.item_ids)},
            seen=build_seen(data.users, data.items) if seen_mode == "model" else {},
            config=config,
            seen_mode=seen_mode,
            app_name=data.app_name,
            event_names=list(data.event_names),
            eval_fold=data.eval_fold,
        )

    def warm_up(self, model: NCFModel) -> None:
        """Build both scorers at deploy (tables upload), and score once
        through the query scorer, so the first query neither uploads
        tables nor loads the kernel's device code."""
        if model.user_index:
            model.scorer(self.device, self.use_kernel)(0)
        model.batch_scorer(self.device)

    @staticmethod
    def _seen(model: NCFModel, query, user_idx, cache=None, live=False) -> set[int]:
        if model.eval_fold or (not live and model.seen_mode != "live"):
            return model.seen.get(user_idx, set())
        return live_seen_indices(model, str(query.get("user")), cache)

    @staticmethod
    def _topk_response(model: NCFModel, scores: np.ndarray, query, user_idx,
                       seen_cache=None, live=False) -> dict:
        """Shared exclusion + ranking tail (predict and batch_predict must
        rank identically)."""
        exclude = {
            model.item_index[str(b)]
            for b in (query.get("blackList") or [])
            if str(b) in model.item_index
        }
        if query.get("unseenOnly", True):
            exclude |= NCFAlgorithm._seen(model, query, user_idx, seen_cache, live)
        scores = scores.astype(np.float64)
        for j in exclude:
            scores[j] = -np.inf
        return topk_item_scores(model.item_ids, scores, int(query.get("num", 10)))

    def predict(self, model: NCFModel, query) -> dict:
        user_idx = model.user_index.get(str(query.get("user")))
        if user_idx is None:
            return {"itemScores": []}
        scores = model.scorer(self.device, self.use_kernel)(user_idx)
        return self._topk_response(model, scores, query, user_idx,
                                   live=self.seen_mode == "live")

    def batch_predict(self, model: NCFModel, queries):
        """Chunks of known users score against the full catalog through
        the plain batch scorer; cold users and malformed queries fall
        through to predict()."""
        user_rows, fallback = partition_user_queries(model.user_index, queries)
        out = []
        if user_rows:
            # bound the host [rows, items] score buffer (the device-side
            # pair budget caps only the on-device intermediates)
            rows_per_slice = score_buffer_rows(len(model.item_ids))
            scorer = model.batch_scorer(self.device)
            seen_cache: dict = {}
            for start in range(0, len(user_rows), rows_per_slice):
                part = user_rows[start : start + rows_per_slice]
                scores = scorer(np.fromiter((u for _, _, u in part), dtype=np.int64))
                out.extend(
                    (qid, self._topk_response(model, scores[row], q, user_idx,
                                              seen_cache=seen_cache,
                                              live=self.seen_mode == "live"))
                    for row, (qid, q, user_idx) in enumerate(part)
                )
        out.extend((qid, self.predict(model, q)) for qid, q in fallback)
        return out
