"""DASE components of the similar-product template.

Port of ``predictionio_tpu/models/similarproduct/engine.py``: item-item
cooccurrence over implicit view/buy events, LLR-weighted by default.
``CooccurrenceAlgorithm.train`` packs the interactions on the host
(``pack_padded_csr``) and runs ``ops/cooccurrence.py::
cooccurrence_indicators`` on ``device`` (``cuda`` unless ``"cpu"``): the
one-hot products, the LLR and the per-row top-k on the card, only the
``[items, topK]`` indicators back on the host. The serving side
(``_resolve_anchors`` through ``batch_predict``, reference ``:281-427``)
is host numpy and copied.

The DataSource reads the store, or a JSON-lines events file when built
with ``events_path=``. With ``"reader": "streaming"`` it returns a
``StreamingHandle``, and ``train`` (reference ``:209-228``) builds the
user-rows CSR through ``parallel/reader.py::build_cooc_csr_sharded``
over the training mesh (each rank its data shard of the user rows; one
process: the whole padded layout), the LLR totals through
``distinct_user_counts_sharded`` and the counts summed over the mesh's
data axis; the indicators equal the materialized build's, and
user-anchored queries read the store live. A model's
``user_history`` is built in one sorted pass (the reference walks the
events in Python); the map is the same.

Query contract: ``{"items": ["i1"], "num": 4, "blackList": [...]}`` ->
``{"itemScores": [{"item": ..., "score": ...}]}``; a ``{"user": ...}``
query anchors on the user's own interaction history.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from predictionio_tpu_torch.controller.base import (
    Algorithm,
    DataSource,
    EvalInfo,
    IdentityPreparator,
    ModelFiles,
    SanityCheck,
    mesh_or_none,
)
from predictionio_tpu_torch.controller.engine import Engine
from predictionio_tpu_torch.controller.serving import FirstServing
from predictionio_tpu_torch.data.store import PEventStore, read_events_file
from predictionio_tpu_torch.models._als_common import (
    Shortlist,
    resolve_retrieval,
    topk_order,
    user_runs,
)
from predictionio_tpu_torch.models._streaming import (
    StreamingHandle,
    live_target_events,
    refuse_streaming_file,
    streaming_handle_or_none,
)
from predictionio_tpu_torch.ops.cooccurrence import (
    cooccurrence_indicators,
    distinct_user_counts,
)
from predictionio_tpu_torch.ops.ragged import pack_padded_csr
from predictionio_tpu_torch.utils.device import resolve_device

@dataclass
class InteractionData(SanityCheck):
    users: np.ndarray
    items: np.ndarray
    times: np.ndarray
    user_ids: list[str]
    item_ids: list[str]

    def sanity_check(self) -> None:
        if self.users.size == 0:
            raise ValueError("no interaction events found")


def user_histories(users: np.ndarray, items: np.ndarray, user_ids: list[str],
                   device=None) -> dict:
    """user id -> [item indices] in event order: the reference's
    per-event ``history.setdefault(...).append(...)`` loop as one stable
    sort (on ``device``) and one split (the same map)."""
    users = np.asarray(users)
    if users.size == 0:
        return {}
    order, uniq, starts, bounds = user_runs(users, device)
    sorted_items = np.asarray(items)[order].tolist()
    return {
        user_ids[u]: sorted_items[s:e]
        for u, s, e in zip(uniq.tolist(), starts.tolist(), bounds.tolist())
    }


class SimilarProductDataSource(DataSource):
    """Params: appName, eventNames (default ["view", "buy"]). With
    ``events_path`` the JSON-lines events file is read in place of the
    store."""

    def __init__(self, params=None, *, events_path: str | None = None):
        super().__init__(params)
        self.events_path = events_path
        refuse_streaming_file(self.params, events_path)

    def _read(self) -> InteractionData:
        event_names = self.params.get_or("eventNames", ["view", "buy"])
        if self.events_path is None:
            ds = PEventStore.dataset(
                self.params.appName,
                event_names=event_names,
                target_entity_type="item",
            )
        else:
            ds = read_events_file(
                self.events_path, event_names=event_names, target_entity_type="item"
            )
        valid = ds.target_entity_ids >= 0
        return InteractionData(
            users=ds.entity_ids[valid],
            items=ds.target_entity_ids[valid],
            times=ds.event_times[valid],
            user_ids=ds.entity_id_vocab,
            item_ids=ds.target_entity_id_vocab,
        )

    def read_training(self, ctx):
        handle = streaming_handle_or_none(
            self.params, ["view", "buy"],
            empty_message="no interaction events found",
        )
        return handle if handle is not None else self._read()

    def read_eval(self, ctx):
        """Hold out each user's most recent interaction; query with the rest."""
        data = self._read()
        data.sanity_check()  # empty store: fail with the real message, not IndexError
        order = np.lexsort((data.times, data.users))
        users, items = data.users[order], data.items[order]
        last_of_user = np.r_[users[1:] != users[:-1], True]
        train_mask = ~last_of_user
        history: dict[int, list[int]] = {}
        for u, i, keep in zip(users, items, train_mask):
            if keep:
                history.setdefault(int(u), []).append(int(i))
        pairs = []
        for u, i, is_last in zip(users, items, last_of_user):
            if is_last and history.get(int(u)):
                pairs.append(
                    (
                        {
                            "items": [data.item_ids[j] for j in history[int(u)]],
                            "num": self.params.get_or("evalK", 10),
                        },
                        [data.item_ids[int(i)]],
                    )
                )
        train = InteractionData(
            users=users[train_mask],
            items=items[train_mask],
            times=data.times[order][train_mask],
            user_ids=data.user_ids,
            item_ids=data.item_ids,
        )
        return [(train, EvalInfo(fold=0), pairs)]

    def read_replay(self, ctx, spec):
        """Time-travel replay fold (``pio eval --replay``): the
        cooccurrence model trains on interactions strictly before the
        boundary; each held-out user's query anchors on their TRAINING
        prefix items only (anchoring on held-out events would both leak
        the future and self-exclude the actuals). Users with no prefix
        history stay in the fold with an empty anchor list and score as
        misses -- the honest cold-user accounting."""
        from predictionio_tpu_torch.eval.split import ReplayFold, split_interactions

        data = self._read()
        cut = split_interactions(data.users, data.items, data.times, spec)
        train = InteractionData(
            users=data.users[cut.train_mask],
            items=data.items[cut.train_mask],
            times=data.times[cut.train_mask],
            user_ids=data.user_ids,
            item_ids=data.item_ids,
        )
        history: dict[int, list[int]] = {}
        for u, i in zip(train.users.tolist(), train.items.tolist()):
            hist = history.setdefault(int(u), [])
            if int(i) not in hist:
                hist.append(int(i))
        pairs = [
            (
                {
                    "items": [
                        data.item_ids[j] for j in history.get(int(u), [])
                    ],
                    "num": spec.k,
                },
                [data.item_ids[int(i)] for i in items],
            )
            for u, items in cut.holdout.items()
        ]
        return ReplayFold(train, pairs, cut.bounds)


@dataclass
class SimilarityModel:
    item_ids: list[str]
    item_index: dict[str, int]
    top_indices: np.ndarray  # [items, k]
    top_values: np.ndarray   # [items, k]
    user_history: dict[str, list[int]]
    #: "model": user-anchored queries read the trained-in map above;
    #: "live": per-query event-store read (O(entities) serving model --
    #: the streaming reader's contract, and fresh events anchor without
    #: retrain). Old pickles predate these; readers use getattr defaults.
    history_mode: str = "model"
    app_name: str = ""
    channel_name: str = None
    event_names: list[str] = None


def _user_anchor_items(model: "SimilarityModel", user: str) -> list[int]:
    """The user's interacted item indices to anchor a {"user": ...} query.

    Live mode reads the event store per request (fresh interactions anchor
    immediately, the model carries no O(edges) map); a store error
    degrades to no anchors rather than a 500.
    """
    if getattr(model, "history_mode", "model") != "live":
        return model.user_history.get(user, [])
    return [
        model.item_index[e.target_entity_id]
        for e in live_target_events(model, user)
        if e.target_entity_id in model.item_index
    ]


class CooccurrenceAlgorithm(Algorithm):
    """Params: topK (indicators per item, default 50), llr (default True),
    chunk (users per one-hot block), maxEventsPerUser, retrieval ({"mode":
    "scan"|"mips"} -- mips serves from a compact union of the anchors'
    indicator entries instead of a dense [items] buffer; scores are EXACT
    either way, so the knob trades nothing; the quantization knobs are
    ignored).

    ``device`` is where the cooccurrence runs: ``cuda`` unless the caller
    names ``"cpu"``; without a card and without an explicit CPU request
    construction raises.
    """

    model_files = ModelFiles(
        "similarproduct", "predictionio_tpu_torch.models.similarproduct.convert")

    def __init__(self, params=None, *, device=None):
        super().__init__(params)
        self.device = resolve_device(device)
        # a retrieval typo fails the build, not a query
        self._retrieval = resolve_retrieval(self.params)

    def train(self, ctx, data) -> SimilarityModel:
        chunk = self.params.get_or("chunk", 4096)
        streamed = isinstance(data, StreamingHandle)
        if streamed:
            from predictionio_tpu_torch.models._streaming import streaming_coo_source
            from predictionio_tpu_torch.parallel.reader import (
                build_cooc_csr_sharded,
                distinct_user_counts_sharded,
            )

            mesh = mesh_or_none(ctx)  # user rows sharded over data, summed
            source, users_enc, items_enc = streaming_coo_source(
                data, runtime_conf=getattr(ctx, "runtime_conf", None)
            )
            csr = build_cooc_csr_sharded(
                source, None, None, mesh,
                max_len=self.params.get_or("maxEventsPerUser", None),
                chunk=chunk,
            )
            user_ids, item_ids = users_enc.ids, items_enc.ids
            totals_fn = lambda: distinct_user_counts_sharded(csr, mesh)
        else:
            csr = pack_padded_csr(
                data.users,
                data.items,
                np.ones(data.users.size, dtype=np.float32),
                num_rows=len(data.user_ids),
                num_cols=len(data.item_ids),
                times=data.times,
                max_len=self.params.get_or("maxEventsPerUser", None),
            )
            user_ids, item_ids = data.user_ids, data.item_ids
            totals_fn = lambda: distinct_user_counts(csr)
            mesh = None
        # fused cooc -> (LLR) -> top-k on the device; the self-cooccurrence
        # diagonal (= per-item distinct-user counts) comes from the O(nnz)
        # host pass, so the [items, items] matrix never leaves the device
        llr_kwargs = {}
        if self.params.get_or("llr", True):
            totals = totals_fn()
            llr_kwargs = dict(
                llr_row_totals=totals,
                llr_col_totals=totals,
                total=len(user_ids),
            )
        idx, vals = cooccurrence_indicators(
            csr,
            top_k=self.params.get_or("topK", 50),
            chunk=chunk,
            device=self.device,
            mesh=mesh,
            **llr_kwargs,
        )
        if streamed:
            # no O(edges) history map exists; user queries read the store
            return SimilarityModel(
                item_ids=list(item_ids),
                item_index={iid: j for j, iid in enumerate(item_ids)},
                top_indices=np.asarray(idx),
                top_values=np.asarray(vals),
                user_history={},
                history_mode="live",
                app_name=data.app_name,
                channel_name=data.channel_name,
                event_names=list(data.event_names),
            )
        return SimilarityModel(
            item_ids=list(data.item_ids),
            item_index={iid: j for j, iid in enumerate(data.item_ids)},
            top_indices=np.asarray(idx),
            top_values=np.asarray(vals),
            user_history=user_histories(data.users, data.items, data.user_ids,
                                        self.device),
        )

    def query_from_json(self, obj):
        """A query names ``items`` or a ``user`` (``predict``'s contract):
        one that names neither is refused here, before it reaches a batch
        (``pio batchpredict`` writes it an error row)."""
        if isinstance(obj, dict) and "items" not in obj and "user" not in obj:
            raise ValueError("query must contain 'items' or 'user'")
        return obj

    @staticmethod
    def _resolve_anchors(model: SimilarityModel, query) -> list[int]:
        if "items" in query:
            return [
                model.item_index[str(i)]
                for i in query["items"]
                if str(i) in model.item_index
            ]
        if "user" in query:
            return _user_anchor_items(model, str(query["user"]))
        raise ValueError("query must contain 'items' or 'user'")

    @staticmethod
    def _anchor_contributions(model: SimilarityModel, anchors: list[int]):
        """(cols, vals): the anchors' positive indicator entries, flattened
        -- one gather over the [items, k] tables instead of a python loop
        over every (anchor, k) pair."""
        idx = model.top_indices[anchors].ravel()
        vals = model.top_values[anchors].ravel().astype(np.float64)
        keep = vals > 0
        return idx[keep], vals[keep]

    @classmethod
    def _compact_scores(cls, model: SimilarityModel, anchors: list[int]) -> Shortlist:
        """The anchors' summed indicator scores as a compact ``Shortlist``
        (ascending union of touched columns): O(anchors * topK) memory
        instead of a dense [items] buffer, and EXACT -- indicator tables
        are already top-K sparse, so the union IS the support. The f64
        accumulation matches the dense path bit-for-bit."""
        cols, vals = cls._anchor_contributions(model, anchors)
        uniq, inv = np.unique(cols, return_inverse=True)
        scores = np.zeros(uniq.size, np.float64)
        np.add.at(scores, inv, vals)
        return Shortlist(uniq, scores, len(model.item_ids))

    @staticmethod
    def _topk_response(model: SimilarityModel, scores, query,
                       anchors: list[int]) -> dict:
        """Shared exclusion + ranking tail (predict and batch_predict must
        rank identically). The exclusion sentinel here is 0, not -inf:
        only positively-scored items are ever emitted. A ``Shortlist``
        ranks over its compact arrays -- ascending indices mean the stable
        sort breaks ties by catalog index exactly like the dense path."""
        scores = scores.copy()
        exclude = set(anchors)
        for b in query.get("blackList") or []:
            if str(b) in model.item_index:
                exclude.add(model.item_index[str(b)])
        for j in exclude:
            scores[j] = 0.0
        if isinstance(scores, Shortlist):
            order = topk_order(scores.scores, int(query.get("num", 10)))
            return {
                "itemScores": [
                    {"item": model.item_ids[int(scores.indices[j])],
                     "score": float(scores.scores[j])}
                    for j in order
                    if scores.scores[j] > 0
                ]
            }
        order = topk_order(scores, int(query.get("num", 10)))
        return {
            "itemScores": [
                {"item": model.item_ids[int(j)], "score": float(scores[j])}
                for j in order
                if scores[j] > 0
            ]
        }

    def predict(self, model: SimilarityModel, query) -> dict:
        anchors = self._resolve_anchors(model, query)
        if not anchors:
            return {"itemScores": []}
        if self._retrieval.mode == "mips":
            return self._topk_response(
                model, self._compact_scores(model, anchors), query, anchors
            )
        scores = np.zeros(len(model.item_ids), np.float64)
        cols, vals = self._anchor_contributions(model, anchors)
        np.add.at(scores, cols, vals)
        return self._topk_response(model, scores, query, anchors)

    def batch_predict(self, model: SimilarityModel, queries):
        """Vectorized bulk scoring: the whole batch's anchor contributions
        accumulate into ONE [B, items] buffer with a single scatter-add
        (memory-bounded slices), instead of a python dict walk per query.
        Live user-anchor lookups are memoized per distinct user for the
        batch. Cold queries answer empty; malformed queries raise
        predict()'s normal error through the fallback loop."""
        from predictionio_tpu_torch.models._als_common import score_buffer_rows

        resolved, out, fallback = [], [], []
        live_memo: dict[str, list[int]] = {}
        for qid, q in queries:
            if not isinstance(q, dict) or not ("items" in q or "user" in q):
                fallback.append((qid, q))
                continue
            if "items" not in q and getattr(model, "history_mode", "model") == "live":
                user = str(q["user"])
                if user not in live_memo:
                    live_memo[user] = _user_anchor_items(model, user)
                anchors = live_memo[user]
            else:
                anchors = self._resolve_anchors(model, q)
            if not anchors:
                out.append((qid, {"itemScores": []}))
            else:
                resolved.append((qid, q, anchors))
        # malformed queries raise predict()'s error BEFORE the vectorized
        # work: one bad query must not cost the batch its completed scoring
        out.extend((qid, self.predict(model, q)) for qid, q in fallback)
        if self._retrieval.mode == "mips":
            # compact per-row accumulation: peak score memory is
            # O(anchors * topK) per row, never the [B, items] buffer below
            out.extend(
                (
                    qid,
                    self._topk_response(
                        model, self._compact_scores(model, anchors), q, anchors
                    ),
                )
                for qid, q, anchors in resolved
            )
            return out
        n_items = len(model.item_ids)
        # halved: this buffer accumulates in f64 (predict's dtype -- the
        # batched and single paths must sum identically) while
        # score_buffer_rows budgets for f32
        rows_per_slice = max(1, score_buffer_rows(n_items) // 2)
        for start in range(0, len(resolved), rows_per_slice):
            part = resolved[start : start + rows_per_slice]
            scores = np.zeros((len(part), n_items), np.float64)
            row_ids, col_ids, vals = [], [], []
            for row, (_, _, anchors) in enumerate(part):
                cols, v = self._anchor_contributions(model, anchors)
                row_ids.append(np.full(cols.size, row, np.int64))
                col_ids.append(cols)
                vals.append(v)
            np.add.at(
                scores,
                (np.concatenate(row_ids), np.concatenate(col_ids)),
                np.concatenate(vals),
            )
            out.extend(
                (qid, self._topk_response(model, scores[row], q, anchors))
                for row, (qid, q, anchors) in enumerate(part)
            )
        return out


def engine_factory() -> Engine:
    return Engine(
        data_source_class=SimilarProductDataSource,
        preparator_class=IdentityPreparator,
        algorithm_class_map={"cooccurrence": CooccurrenceAlgorithm},
        serving_class=FirstServing,
    )
