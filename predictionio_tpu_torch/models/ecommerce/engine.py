"""DASE components of the e-commerce recommendation template.

Port of ``predictionio_tpu/models/ecommerce/engine.py``: implicit-feedback
ALS over view/buy events (B1 on the card, through
``models/_als_common.py::fit_with_checkpoint``), with the business rules
the plain recommendation template lacks, applied at serving time:

- ``categories`` filter (item properties ingested via ``$set`` events),
- ``whiteList`` / ``blackList`` in the query,
- a live *unavailable items* constraint: a ``$set`` on the constraint
  entity ``unavailableItems`` read from the event store **per query**, so
  ops can pull items from every deployed server without retraining,
- cold-start users served from their recently-viewed items (also a live
  event-store read), scored through ALS item-space similarity.

Known users score through ``score_known_user`` / ``batch_score_known_users``
(B2 under ``"retrieval": {"mode": "mips"}``). ``fold_in`` is the
continuous-learning hook (``pio retrain --follow``): the touched users
re-solved through B1 with the datasource's per-event confidences, and
the category index rebuilt when the window holds item ``$set`` records.

The DataSource reads the store, or a JSON-lines events file when built
with ``events_path=`` (categories then from the file's item ``$set``
events). With ``"reader": "streaming"`` it returns a ``StreamingHandle``
carrying the buy-weighted confidences, and the Preparator streams the
store (reference ``:249-290``) through ``models/_streaming.py::
build_streaming_als`` (the block store and ``als_fit_streamed`` under
``alsFeed: "streamed"``); the model then keeps no seen map and filters
live.

Query contract:
``{"user": "u1", "num": 4, "categories": [...], "whiteList": [...],
"blackList": [...]}`` -> ``{"itemScores": [{"item": ..., "score": ...}]}``.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass, field

import numpy as np

from predictionio_tpu_torch.controller.base import (
    Algorithm,
    DataSource,
    EvalInfo,
    ModelFiles,
    Preparator,
    SanityCheck,
    mesh_or_none,
)
from predictionio_tpu_torch.controller.engine import Engine
from predictionio_tpu_torch.controller.serving import FirstServing
from predictionio_tpu_torch.data.store import (
    LEventStore,
    PEventStore,
    read_events_file,
    read_item_properties,
)
from predictionio_tpu_torch.models._als_common import (
    Shortlist,
    batch_score_known_users,
    build_seen,
    fit_with_checkpoint,
    partition_user_queries,
    prepare_als_data,
    resolve_retrieval,
    retrieval_index,
    score_known_user,
    similar_item_scores,
    topk_item_scores,
    warn_misplaced_packing_params,
)
from predictionio_tpu_torch.models._streaming import (
    StreamingHandle,
    build_streaming_handle,
    refuse_streaming_file,
    streaming_handle_or_none,
)
from predictionio_tpu_torch.parallel.als import ALSConfig, ALSModel
from predictionio_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("pio.torch.ecommerce")

@dataclass
class ECommerceData(SanityCheck):
    """Implicit interactions + per-item categories from ``$set`` properties."""

    users: np.ndarray
    items: np.ndarray
    weights: np.ndarray      # buy-weighted implicit confidence
    times: np.ndarray
    user_ids: list[str]
    item_ids: list[str]
    app_name: str = ""       # carried to the model for live serving reads
    categories: dict[str, list[str]] = field(default_factory=dict)
    channel_name: str = None
    event_names: list[str] = None  # the types this model trained on
    streamed: bool = False   # built by the sharded reader: edge arrays empty

    def sanity_check(self) -> None:
        if self.users.size == 0:
            raise ValueError("no view/buy events found -- check appName")


def _buy_confidences(params, event_names: list[str]) -> dict[str, float]:
    """event type -> implicit confidence (exact buy names boosted)."""
    buy_weight = float(params.get_or("buyWeight", 2.0))
    buy_events = set(params.get_or("buyEvents", ["buy"]))
    return {
        n: buy_weight if n in buy_events else 1.0 for n in event_names
    }


def _load_categories(app_name: str, channel_name=None) -> dict[str, list[str]]:
    props = PEventStore.aggregate_properties(
        app_name, "item", channel_name=channel_name
    )
    return _categories_of(props)


def _categories_of(props) -> dict[str, list[str]]:
    """item id -> its ``categories`` property, for the items that have one."""
    return {
        item_id: list(pm.get("categories", []) or [])
        for item_id, pm in props.items()
        if pm.get("categories", None)
    }


def _category_index(
    categories: dict[str, list[str]], item_index: dict[str, int]
) -> dict[str, np.ndarray]:
    """category -> sorted item indices: the inverted index behind the
    query-time ``categories`` filter (shared by train and fold-in)."""
    by_cat: dict[str, list[int]] = {}
    for item_id, cats in categories.items():
        j = item_index.get(item_id)
        if j is not None:
            for c in cats:
                by_cat.setdefault(str(c), []).append(j)
    return {
        c: np.asarray(sorted(js), dtype=np.int64) for c, js in by_cat.items()
    }


class ECommerceDataSource(DataSource):
    """Params: appName (required), eventNames (default ["view", "buy"]),
    buyEvents (exact event names carrying purchase-strength confidence,
    default ["buy"]), buyWeight (their confidence multiplier, default 2.0).
    With ``events_path`` the JSON-lines events file is read in place of
    the store."""

    def __init__(self, params=None, *, events_path: str | None = None):
        super().__init__(params)
        self.events_path = events_path
        refuse_streaming_file(self.params, events_path)

    def _read(self) -> ECommerceData:
        event_names = self.params.get_or("eventNames", ["view", "buy"])
        if self.events_path is None:
            ds = PEventStore.dataset(
                self.params.appName,
                event_names=event_names,
                target_entity_type="item",
            )
            categories = _load_categories(self.params.appName)
        else:
            ds = read_events_file(
                self.events_path, event_names=event_names, target_entity_type="item"
            )
            categories = _categories_of(read_item_properties(self.events_path))
        valid = ds.target_entity_ids >= 0
        # implicit confidence: views count 1, buys count more.
        # event_names is dictionary-encoded -- match codes, not strings;
        # exact names only (substring matching would give "unbuy"-style
        # cancellation events the purchase boost)
        buy_weight = float(self.params.get_or("buyWeight", 2.0))
        buy_events = set(self.params.get_or("buyEvents", ["buy"]))
        weights = np.ones(int(valid.sum()), dtype=np.float32)
        buy_codes = [
            code
            for code, name in enumerate(ds.event_name_vocab)
            if name in buy_events
        ]
        weights[np.isin(ds.event_names[valid], buy_codes)] = buy_weight
        return ECommerceData(
            users=ds.entity_ids[valid],
            items=ds.target_entity_ids[valid],
            weights=weights,
            times=ds.event_times[valid],
            user_ids=ds.entity_id_vocab,
            item_ids=ds.target_entity_id_vocab,
            app_name=self.params.get_or("appName", ""),
            categories=categories,
        )

    def read_training(self, ctx):
        handle = streaming_handle_or_none(
            self.params, ["view", "buy"],
            empty_message="no view/buy events found -- check appName",
        )
        if handle is not None:
            # DATASOURCE knobs the streaming build needs (DASE keeps
            # per-component params separate)
            handle.extras["event_values"] = _buy_confidences(
                self.params, handle.event_names
            )
            return handle
        return self._read()

    def online_handle(self):
        """Continuous-learning scan descriptor; the confidence map rides
        ``extras``, so fold-in weighs a buy the same way training does."""
        handle = build_streaming_handle(
            self.params, ["view", "buy"],
            empty_message="no view/buy events found -- check appName",
        )
        handle.extras["event_values"] = _buy_confidences(
            self.params, handle.event_names
        )
        return handle

    def read_eval(self, ctx):
        """Hold out each user's latest interaction as the actual."""
        data = self._read()
        data.sanity_check()
        order = np.lexsort((data.times, data.users))
        users, items = data.users[order], data.items[order]
        last = np.r_[users[1:] != users[:-1], True]
        train = ECommerceData(
            users=users[~last],
            items=items[~last],
            weights=data.weights[order][~last],
            times=data.times[order][~last],
            user_ids=data.user_ids,
            item_ids=data.item_ids,
            app_name=data.app_name,
            categories=data.categories,
        )
        pairs = [
            (
                {"user": data.user_ids[int(u)], "num": self.params.get_or("evalK", 10)},
                [data.item_ids[int(i)]],
            )
            for u, i in zip(users[last], items[last])
        ]
        return [(train, EvalInfo(fold=0), pairs)]

    def read_replay(self, ctx, spec):
        """Time-travel replay fold (``pio eval --replay``): implicit
        interactions strictly before the boundary train the fold's model
        (array-backed, so the trained-in seen map covers exactly the
        prefix -- live-serving filter parity without seeing the held-out
        events); each held-out user asks for their top-``spec.k``."""
        from predictionio_tpu_torch.eval.split import ReplayFold, split_interactions

        data = self._read()
        cut = split_interactions(data.users, data.items, data.times, spec)
        train = ECommerceData(
            users=data.users[cut.train_mask],
            items=data.items[cut.train_mask],
            weights=data.weights[cut.train_mask],
            times=data.times[cut.train_mask],
            user_ids=data.user_ids,
            item_ids=data.item_ids,
            app_name=data.app_name,
            categories=data.categories,
        )
        pairs = [
            (
                {"user": data.user_ids[u], "num": spec.k},
                [data.item_ids[int(i)] for i in items],
            )
            for u, items in cut.holdout.items()
        ]
        return ReplayFold(train, pairs, cut.bounds)


class ECommercePreparator(Preparator):
    """Packs interactions into padded CSR blocks (``maxEventsPerUser``,
    ``buckets``, ``alsFeed``). A StreamingHandle (datasource ``"reader":
    "streaming"``) routes through the streaming reader with the
    buy-weighted confidences applied per event type in the stream."""

    def prepare(self, ctx, data):
        if isinstance(data, StreamingHandle):
            return self._prepare_streaming(ctx, data)
        als_data = prepare_als_data(
            ctx,
            self.params,
            data.users,
            data.items,
            data.weights,
            len(data.user_ids),
            len(data.item_ids),
            times=data.times,
        )
        return data, als_data

    def _prepare_streaming(self, ctx, src: StreamingHandle):
        from predictionio_tpu_torch.models._streaming import build_streaming_als

        # the DATASOURCE's confidence scheme, applied in-stream (it rides
        # the handle: preparator params are a different DASE component)
        event_values = src.extras.get("event_values") or {
            n: 1.0 for n in src.event_names
        }
        users_enc, items_enc, als_data = build_streaming_als(
            src, self.params, mesh_or_none(ctx), event_values=event_values,
            runtime_conf=getattr(ctx, "runtime_conf", None),
        )
        categories = _load_categories(src.app_name, src.channel_name)
        data = ECommerceData(
            users=np.empty(0, np.int64),
            items=np.empty(0, np.int64),
            weights=np.empty(0, np.float32),
            times=np.empty(0, np.float64),
            user_ids=users_enc.ids,
            item_ids=items_enc.ids,
            app_name=src.app_name,
            categories=categories,
            channel_name=src.channel_name,
            event_names=list(src.event_names),
            streamed=True,
        )
        return data, als_data


@dataclass
class ECommerceModel:
    """Host-cached factors + the inverted category index for O(1) filters."""

    als: ALSModel
    app_name: str
    user_index: dict[str, int]
    item_ids: list[str]
    item_index: dict[str, int]
    seen: dict[int, set[int]]
    #: category -> sorted item indices (query-time mask building)
    category_items: dict[str, np.ndarray]
    similar_events: list[str]
    #: "model": the trained-in seen map; "live": per-query event-store
    #: read (streaming-reader serving contract -- O(entities) model).
    #: Old pickles predate these fields; readers use getattr defaults.
    seen_mode: str = "model"
    channel_name: str = None
    event_names: list[str] = None


class ECommAlgorithm(Algorithm):
    """Implicit ALS + serving-time business rules.

    Params: rank, numIterations, lambda, alpha, seed, unseenOnly (default
    True), similarEvents (events anchoring cold users, default ["view"]),
    recentCount (how many recent views to anchor on, default 10; a query
    may override it), checkpointInterval (iterations between step
    checkpoints; 0 disables), retrieval ({"mode": "scan"|"mips", ...}).

    ``device`` is where training and the retrieval index run: ``cuda``
    unless the caller names ``"cpu"``; without a card and without an
    explicit CPU request construction raises.
    """

    model_files = ModelFiles("ecommerce", "predictionio_tpu_torch.models.ecommerce.convert")

    def __init__(self, params=None, *, device=None):
        super().__init__(params)
        self.device = resolve_device(device)
        # a retrieval typo fails the build, not a query
        self._retrieval = resolve_retrieval(self.params)

    def _config(self) -> ALSConfig:
        p = self.params
        return ALSConfig(
            rank=p.get_or("rank", 16),
            iterations=p.get_or("numIterations", 10),
            reg=p.get_or("lambda", 0.05),
            alpha=p.get_or("alpha", 10.0),
            implicit=p.get_or("implicitPrefs", True),
            seed=p.get_or("seed", 0),
            dtype=p.get_or("factorDtype", "float32"),
            factor_sharding=p.get_or("factorSharding", "auto"),
            # "auto"/"pallas": the fused gather->Gram kernel (B1); "xla":
            # the unfused gather + products
            solver=p.get_or("alsSolver", "auto"),
        )

    def train(self, ctx, prepared) -> ECommerceModel:
        data, als_data = prepared
        warn_misplaced_packing_params(self.params, "ecommerce")
        model = fit_with_checkpoint(
            ctx,
            als_data,
            self._config(),
            user_ids=data.user_ids,
            item_ids=data.item_ids,
            interval=self.params.get_or("checkpointInterval", 5),
            name="ecomm-als",
            mesh=mesh_or_none(ctx),
        )
        # a streamed build has no edge arrays: the seen filter reads live
        streamed = getattr(data, "streamed", False)
        item_index = {iid: j for j, iid in enumerate(data.item_ids)}
        return ECommerceModel(
            als=model,
            app_name=self.params.get_or("appName", None) or data.app_name,
            user_index={uid: k for k, uid in enumerate(data.user_ids)},
            item_ids=list(data.item_ids),
            item_index=item_index,
            seen={} if streamed else build_seen(data.users, data.items),
            category_items=_category_index(data.categories, item_index),
            similar_events=self.params.get_or("similarEvents", ["view"]),
            seen_mode="live" if streamed else "model",
            channel_name=getattr(data, "channel_name", None),
            event_names=getattr(data, "event_names", None),
        )

    supports_fold_in = True

    def fold_in(self, model: ECommerceModel, delta) -> ECommerceModel | None:
        """Continuous-learning hook: implicit fold-in of the delta window
        (frozen item factors, per-event confidences from the datasource's
        map riding ``delta.extras``; one B1 launch on ``cuda``). New items
        carry zero factors until the next full retrain. When the window's
        touched events include item ``$set`` records, the ``$set``
        aggregate is rescanned and the category index rebuilt against the
        (possibly extended) item vocabulary; a window of only ``$set``
        records still publishes, the factors unchanged."""
        # imported here: the online package's loop imports the templates
        from predictionio_tpu_torch.online.foldin import fold_in_als_model

        event_values = delta.extras.get("event_values") or {}
        result = fold_in_als_model(
            model.als,
            model.user_index,
            model.item_ids,
            model.item_index,
            delta,
            self._config(),
            event_values=event_values,
            device=self.device,
        )
        refresh_categories = "item" in (
            getattr(delta, "set_entity_types", None) or ()
        )
        if result is None and not refresh_categories:
            return None
        item_index = result.item_index if result else model.item_index
        category_items = model.category_items
        if refresh_categories:
            category_items = _category_index(
                _load_categories(model.app_name, model.channel_name), item_index
            )
        seen = model.seen
        if (
            result is not None
            and model.seen_mode == "model"
            and result.window_pairs is not None
        ):
            # a new map whose touched users get new sets: the old model's
            # sets stay as they were (the swap protocol), and the other
            # users' sets are shared instead of copied
            seen = dict(model.seen)
            for u, i in result.window_pairs.tolist():
                if seen.get(int(u)) is model.seen.get(int(u)):
                    seen[int(u)] = set(model.seen.get(int(u), ()))
                seen[int(u)].add(int(i))
        return dataclasses.replace(
            model,
            als=result.als if result else model.als,
            user_index=result.user_index if result else model.user_index,
            item_ids=result.item_ids if result else model.item_ids,
            item_index=item_index,
            category_items=category_items,
            seen=seen,
        )

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------

    def _unavailable_items(self, model: ECommerceModel) -> set[int]:
        """Latest ``$set`` on constraint entity ``unavailableItems``, read
        live so deployed servers react without retraining. Any storage
        error degrades to "nothing unavailable" (serving must not 500
        because the metadata store blinked)."""
        if not model.app_name:
            return set()
        try:
            events = list(
                LEventStore.find_by_entity(
                    model.app_name,
                    entity_type="constraint",
                    entity_id="unavailableItems",
                    channel_name=getattr(model, "channel_name", None),
                    event_names=["$set"],
                    limit=1,
                    latest=True,
                )
            )
        except Exception:
            logger.warning("unavailableItems lookup failed; serving unfiltered",
                           exc_info=True)
            return set()
        if not events:
            return set()
        items = events[0].properties.get("items", []) or []
        return {
            model.item_index[str(i)] for i in items if str(i) in model.item_index
        }

    def _recently_viewed(self, model: ECommerceModel, user: str, count: int) -> list[int]:
        """Cold-user anchors: the user's latest ``similarEvents`` items."""
        if not model.app_name:
            return []
        try:
            events = LEventStore.find_by_entity(
                model.app_name,
                entity_type="user",
                entity_id=user,
                channel_name=getattr(model, "channel_name", None),
                event_names=model.similar_events,
                limit=count,
                latest=True,
            )
        except Exception:
            logger.warning("recent-view lookup failed for user %r", user,
                           exc_info=True)
            return []
        out = []
        for e in events:
            j = model.item_index.get(str(e.target_entity_id))
            if j is not None and j not in out:
                out.append(j)
        return out

    def warm_up(self, model: ECommerceModel) -> None:
        model.als.item_norms  # cold-user similarity norm cache, at deploy
        # mips mode: pack + upload both retrieval indexes at deploy (dot for
        # user scoring, cosine for cold anchors) and search each once, so
        # the first query does not load the kernel's device code
        for kind in ("dot", "cosine"):
            index = retrieval_index(
                model.als, self._retrieval, kind=kind, device=self.device
            )
            if index is not None:
                index.search(np.zeros((1, model.als.item_factors.shape[1]), np.float32))

    @staticmethod
    def _seen(model: ECommerceModel, query, user_idx, cache) -> set[int]:
        """Already-interacted item indices; live mode reads the store
        (memoized per distinct user when the batch path passes a cache)."""
        if getattr(model, "seen_mode", "model") != "live":
            return model.seen.get(user_idx, set())
        from predictionio_tpu_torch.models._streaming import live_seen_indices

        return live_seen_indices(model, str(query.get("user")), cache)

    def _apply_rules(
        self,
        model: ECommerceModel,
        scores: np.ndarray,
        query,
        user_idx,
        anchors,
        unavailable: set[int],
        seen_cache: dict | None = None,
    ) -> dict:
        """Business-rule filtering + ranking shared by predict and
        batch_predict (which resolves ``unavailable`` ONCE per batch and
        memoizes live seen lookups per distinct user)."""
        n_items = scores.shape[0]
        if query.get("whiteList"):
            allowed = np.zeros(n_items, dtype=bool)
            for w in query["whiteList"]:
                j = model.item_index.get(str(w))
                if j is not None:
                    allowed[j] = True
        else:
            allowed = np.ones(n_items, dtype=bool)
        if query.get("categories"):
            cat_mask = np.zeros(n_items, dtype=bool)
            for c in query["categories"]:
                idxs = model.category_items.get(str(c))
                if idxs is not None:
                    cat_mask[idxs] = True
            allowed &= cat_mask
        exclude: set[int] = set(anchors)
        for b in query.get("blackList") or []:
            j = model.item_index.get(str(b))
            if j is not None:
                exclude.add(j)
        exclude |= unavailable
        if user_idx is not None and query.get(
            "unseenOnly", self.params.get_or("unseenOnly", True)
        ):
            exclude |= self._seen(model, query, user_idx, seen_cache)
        if isinstance(scores, Shortlist):
            scores.where_allowed(allowed)  # O(shortlist), stays compact
        else:
            scores = np.where(allowed, scores, -np.inf)
        for j in exclude:
            scores[j] = -np.inf
        return topk_item_scores(model.item_ids, scores, int(query.get("num", 10)))

    def _cold_scores(self, model: ECommerceModel, query, user: str):
        """(anchors, scores) for a user unseen at training time; anchors
        empty means no history at all -> empty response."""
        anchors = self._recently_viewed(
            model,
            user,
            int(query.get("recentCount", self.params.get_or("recentCount", 10))),
        )
        if not anchors:
            return [], None
        return anchors, similar_item_scores(
            model.als, anchors, self._retrieval, device=self.device
        )

    def query_from_json(self, obj):
        """A query names its ``user`` (``predict``'s contract): one that
        does not is refused here, before it reaches a batch (``pio
        batchpredict`` writes it an error row)."""
        if isinstance(obj, dict) and not str(obj.get("user", "")):
            raise ValueError("query must contain 'user'")
        return obj

    def predict(self, model: ECommerceModel, query) -> dict:
        user = str(query.get("user", ""))
        if not user:
            raise ValueError("query must contain 'user'")
        user_idx = model.user_index.get(user)
        anchors: list[int] = []
        if user_idx is not None:
            scores = score_known_user(
                model.als, user_idx, self._retrieval, device=self.device
            )
        else:
            anchors, scores = self._cold_scores(model, query, user)
            if scores is None:
                return {"itemScores": []}
        return self._apply_rules(
            model, scores, query, user_idx, anchors, self._unavailable_items(model)
        )

    def batch_predict(self, model: ECommerceModel, queries):
        """Bulk scoring: known users through one retrieval search (mips)
        or one einsum slice (scan) a chunk, and the live unavailable-items
        constraint read ONCE per batch instead of once per query. Cold
        users still do their per-user recently-viewed lookup; malformed
        queries raise predict()'s error through the fallback loop."""
        user_rows, fallback = partition_user_queries(model.user_index, queries)
        unavailable = self._unavailable_items(model) if queries else set()
        seen_cache: dict = {}
        out = batch_score_known_users(
            model.als,
            user_rows,
            lambda scores, qid, q, user_idx: (
                qid,
                self._apply_rules(
                    model, scores, q, user_idx, [], unavailable,
                    seen_cache=seen_cache,
                ),
            ),
            retrieval=self._retrieval,
            device=self.device,
        )
        for qid, q in fallback:
            user = str(q.get("user", "")) if isinstance(q, dict) else ""
            if not user:
                out.append((qid, self.predict(model, q)))  # raises like predict
                continue
            anchors, scores = self._cold_scores(model, q, user)
            if scores is None:
                out.append((qid, {"itemScores": []}))
            else:
                out.append(
                    (
                        qid,
                        self._apply_rules(
                            model, scores, q, None, anchors, unavailable
                        ),
                    )
                )
        return out


def engine_factory() -> Engine:
    return Engine(
        data_source_class=ECommerceDataSource,
        preparator_class=ECommercePreparator,
        algorithm_class_map={"ecomm": ECommAlgorithm},
        serving_class=FirstServing,
    )
