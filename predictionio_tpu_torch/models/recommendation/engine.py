"""DASE components of the recommendation template.

Port of ``predictionio_tpu/models/recommendation/engine.py``: the
training half (``RatingsData``, ``RecommendationDataSource``,
``RecommendationPreparator``, ``ALSAlgorithm.train``), the serving
half (``RecommendationModel``, the query side of ``ALSAlgorithm``) and
the continuous-learning hooks (``RecommendationDataSource.online_handle``,
``ALSAlgorithm.fold_in``, reference ``:130``, ``:492-530``) that
``pio retrain --follow`` (``online/loop.py``) runs, the serving
fabric's ``ALSAlgorithm.shard_model`` (reference ``:438-470``), and the
evaluation hooks (reference ``:140-239``): ``read_eval`` (time-ordered
k-fold) and ``read_replay`` (the ``pio eval --replay`` split).

The DataSource reads the event store (``PEventStore.dataset`` of the
``appName`` app, the reference's filters), or a JSON-lines events file
when it is built with ``events_path=`` (``data/store.py``).

Query contract (reference template quickstart):
``{"user": "u1", "num": 4}`` -> ``{"itemScores": [{"item": ..., "score": ...}]}``
plus item-based queries ``{"items": [...], "num": k}`` for similarity.

``seenFilter`` is ``"model"`` (the trained-in seen map) or ``"live"``
(a per-query read of the user's events from the store,
``models/_streaming.py``; a model trained so keeps no seen map). A
query filters live when its model was trained live or the serving
engine.json asks for it: every model names the app and events a live
read needs. An evaluation fold's model never filters live (reference
``:389-399``): a live read would see the fold's held-out events and
score every actual item -inf, so training on a fold keeps the seen map
and marks the model ``eval_fold``.

``"reader": "streaming"`` (reference ``:95-130``, ``:263-290``): the
DataSource returns a ``StreamingHandle``, and the Preparator streams the
store's chunked scan (or, under ``--snapshot-mode use|refresh``, the
training snapshot's memmaps) through ``models/_streaming.py::
build_streaming_als``; with ``alsFeed: "streamed"`` (or ``pio train
--als-feed streamed``) and a snapshot it packs the on-disk block store
that ``als_fit_streamed`` trains from, one B1 launch per block of each
half-step. A streamed model keeps no seen map: ``seenFilter`` defaults
to ``"live"`` there, and ``"model"`` raises.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from predictionio_tpu_torch.controller.base import (
    Algorithm,
    DataSource,
    EvalInfo,
    Preparator,
    SanityCheck,
    mesh_or_none,
)
from predictionio_tpu_torch.data.store import PEventStore, read_events_file
from predictionio_tpu_torch.models._als_common import (
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
    live_seen_indices,
    refuse_streaming_file,
    streaming_handle_or_none,
)
from predictionio_tpu_torch.parallel.als import ALSConfig, ALSModel
from predictionio_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("pio.torch.recommendation")


@dataclass
class RatingsData(SanityCheck):
    """COO interactions + id vocabularies."""

    users: np.ndarray       # int indices
    items: np.ndarray
    ratings: np.ndarray     # float32
    times: np.ndarray       # float64 epoch seconds
    user_ids: list[str]
    item_ids: list[str]
    app_name: str = ""
    event_names: list[str] = field(default_factory=list)
    #: True when built by the streaming reader: the edge arrays are empty
    #: (only the vocabularies are materialized)
    streamed: bool = False
    channel_name: str = None   # non-default channel the data came from
    #: True for read_eval's and read_replay's fold copies: live seen
    #: filtering is downgraded to the trained-in map there (the held-out
    #: events still exist in the store, and a live read would exclude
    #: every 'actual' item)
    eval_fold: bool = False

    def sanity_check(self) -> None:
        if self.users.size == 0:
            raise ValueError(
                "no rating events found -- check appName (or the events file) "
                "and eventNames"
            )

    @property
    def num_users(self) -> int:
        return len(self.user_ids)

    @property
    def num_items(self) -> int:
        return len(self.item_ids)


#: the streaming reader's training handle (``models/_streaming.py``): the
#: preparator streams the chunked scan; requires seenFilter "live"
StreamingRatings = StreamingHandle


class RecommendationDataSource(DataSource):
    """Reads rating-like events into COO form.

    Params: ``appName`` (required to read the store), ``eventNames``
    (default ["rate", "buy"]), ``ratingKey`` (property holding the rating;
    "buy"-style events without it score 1.0), ``evalK``/``evalFolds`` for
    read_eval. With ``events_path`` the JSON-lines events file is read in
    place of the store. ``"reader": "streaming"`` switches read_training
    to the streaming reader (``StreamingRatings``); it scans the store,
    so it refuses an events file.
    """

    def __init__(self, params=None, *, events_path: str | None = None):
        super().__init__(params)
        self.events_path = events_path
        refuse_streaming_file(self.params, events_path)

    def _read(self, **snapshot) -> RatingsData:
        """The ratings of the store (``snapshot``: ``snapshot_mode`` /
        ``snapshot_dir`` for ``PEventStore.dataset``) or of the events
        file."""
        event_names = self.params.get_or("eventNames", ["rate", "buy"])
        rating_key = self.params.get_or("ratingKey", "rating")
        if self.events_path is None:
            ds = PEventStore.dataset(
                self.params.appName,
                rating_key=rating_key,
                event_names=event_names,
                target_entity_type="item",
                **snapshot,
            )
        else:
            ds = read_events_file(
                self.events_path,
                event_names=event_names,
                target_entity_type="item",
                rating_key=rating_key,
            )
        ratings = np.nan_to_num(ds.ratings, nan=1.0)  # implicit events -> 1.0
        valid = ds.target_entity_ids >= 0
        return RatingsData(
            users=ds.entity_ids[valid],
            items=ds.target_entity_ids[valid],
            ratings=ratings[valid],
            times=ds.event_times[valid],
            user_ids=ds.entity_id_vocab,
            item_ids=ds.target_entity_id_vocab,
            app_name=self.params.get_or("appName", ""),
            event_names=list(event_names),
        )

    def read_training(self, ctx):
        handle = streaming_handle_or_none(
            self.params, ["rate", "buy"],
            empty_message="no rating events found -- check appName and "
            "eventNames",
        )
        return handle if handle is not None else self._read()

    def online_handle(self):
        """The continuous-learning loop's scan descriptor: same identity
        (app/channel/event names/rating key) as the training read, so the
        snapshot the loop refreshes is the one training replays."""
        return build_streaming_handle(
            self.params, ["rate", "buy"],
            empty_message="no rating events found -- check appName and "
            "eventNames",
        )

    @staticmethod
    def _fold(data: RatingsData, keep: np.ndarray) -> RatingsData:
        """The ``keep`` rows of ``data`` as an evaluation fold's training
        data (``eval_fold``)."""
        return RatingsData(
            users=data.users[keep],
            items=data.items[keep],
            ratings=data.ratings[keep],
            times=data.times[keep],
            user_ids=data.user_ids,
            item_ids=data.item_ids,
            app_name=data.app_name,
            event_names=data.event_names,
            eval_fold=True,
        )

    def read_eval(self, ctx):
        """Time-ordered k-fold: hold out each fold's interactions as
        (query, actual) pairs asking for top-`evalK` recommendations."""
        data = self._read()
        folds = self.params.get_or("evalFolds", 3)
        eval_k = self.params.get_or("evalK", 10)
        out = []
        for f in range(folds):
            test_mask = (np.arange(data.users.size) % folds) == f
            qa = {}
            for u, i in zip(data.users[test_mask], data.items[test_mask]):
                qa.setdefault(u, set()).add(i)
            pairs = [
                (
                    {"user": data.user_ids[u], "num": eval_k},
                    [data.item_ids[i] for i in items],
                )
                for u, items in qa.items()
            ]
            out.append((self._fold(data, ~test_mask), EvalInfo(fold=f), pairs))
        return out

    def _read_replay_source(self, ctx) -> RatingsData:
        """``_read()``, served from the training snapshot
        (``data/snapshot.py``) when ``ctx.runtime_conf`` or the
        environment enables it (``--snapshot-mode use|refresh``): the
        replay's prefix then trains with zero SQL scans, and reruns
        against the same generation replay identical bytes. A snapshot
        miss degrades to the direct store read (``PEventStore.dataset``
        logs it), never fails the eval."""
        from predictionio_tpu_torch.data.snapshot import snapshot_settings

        runtime_conf = getattr(ctx, "runtime_conf", None) or {}
        mode, root = snapshot_settings(runtime_conf)
        if mode == "off" or self.events_path is not None:
            return self._read()
        data = self._read(snapshot_mode=mode, snapshot_dir=root)
        data.channel_name = self.params.get_or("channelName", None)
        return data

    def read_replay(self, ctx, spec):
        """Time-travel replay fold (``pio eval --replay``): train on
        ratings strictly before the boundary, ask for each held-out
        user's top-``spec.k`` (cold holdout users -- no training events
        -- stay in the fold and score as misses). The fold carries
        ``eval_fold=True`` so a ``seenFilter: "live"`` variant downgrades
        to the trained-in map, exactly like the k-fold path."""
        from predictionio_tpu_torch.eval.split import ReplayFold, split_interactions

        data = self._read_replay_source(ctx)
        cut = split_interactions(data.users, data.items, data.times, spec)
        pairs = [
            (
                {"user": data.user_ids[u], "num": spec.k},
                [data.item_ids[int(i)] for i in items],
            )
            for u, items in cut.holdout.items()
        ]
        return ReplayFold(self._fold(data, cut.train_mask), pairs, cut.bounds)


class RecommendationPreparator(Preparator):
    """Packs COO ratings into padded CSR blocks.

    Preparator params: ``buckets`` (length-bucketed packing),
    ``maxEventsPerUser`` (history cap, most recent kept), ``alsFeed``
    (``"resident"`` or ``"streamed"``). A ``StreamingRatings`` handle
    routes through the streaming reader instead of host arrays."""

    def prepare(self, ctx, training_data):
        if isinstance(training_data, StreamingRatings):
            return self._prepare_streaming(ctx, training_data)
        als_data = prepare_als_data(
            ctx,
            self.params,
            training_data.users,
            training_data.items,
            training_data.ratings,
            training_data.num_users,
            training_data.num_items,
            times=training_data.times,
        )
        return training_data, als_data

    def _prepare_streaming(self, ctx, src: StreamingRatings):
        from predictionio_tpu_torch.models._streaming import build_streaming_als

        users_enc, items_enc, als_data = build_streaming_als(
            src, self.params, mesh_or_none(ctx),
            runtime_conf=getattr(ctx, "runtime_conf", None),
        )
        # the vocabularies come from the scan; the edge arrays stay empty
        ratings_like = RatingsData(
            users=np.empty(0, np.int64),
            items=np.empty(0, np.int64),
            ratings=np.empty(0, np.float32),
            times=np.empty(0, np.float64),
            user_ids=users_enc.ids,
            item_ids=items_enc.ids,
            app_name=src.app_name,
            event_names=list(src.event_names),
            streamed=True,
            channel_name=src.channel_name,
        )
        return ratings_like, als_data


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
    #: "model": the seen map above; "live": per-query event-store read
    #: (``app_name`` / ``event_names`` say what to read), no seen map
    seen_mode: str = "model"
    app_name: str = ""
    event_names: list[str] = None
    #: trained on an evaluation fold: never filters live (not persisted)
    eval_fold: bool = False
    #: the channel a live read scans (a streamed build's)
    channel_name: str = None


def _seen_indices(model: RecommendationModel, query, user_idx: int,
                  cache: dict | None = None, live: bool = False) -> set[int]:
    """The user's already-interacted item indices for the unseenOnly
    filter: the trained-in map, or in "live" mode (the model's, or
    ``live``, unless the model is an evaluation fold's) the store's
    events of the query's user (a store error degrades to nothing
    seen)."""
    if model.eval_fold or (not live and model.seen_mode != "live"):
        return model.seen.get(user_idx, set())
    return live_seen_indices(model, str(query.get("user")), cache)


class ALSAlgorithm(Algorithm):
    """ALS training (``train``: ``als_fit`` on ``ctx.device``) and serving:
    scan (host einsum) or mips (the two-stage device retrieval of
    ``ops/mips``) per the ``retrieval`` param.

    Params: rank, numIterations, lambda, alpha, implicitPrefs, seed,
    factorDtype, factorSharding, alsSolver, checkpointInterval
    (iterations between step checkpoints; 0 disables), seenFilter
    ("model" or "live": kept in the model at training; "live" at deploy
    reads the store whatever the model holds) and retrieval.

    ``device`` is where the retrieval index lives: ``cuda`` unless the
    caller names ``"cpu"``; without a card and without an explicit CPU
    request construction raises.
    """

    def __init__(self, params=None, *, device=None):
        super().__init__(params)
        self.device = resolve_device(device)
        #: None: "model", or "live" for a streamed build
        self.seen_mode = self.params.get_or("seenFilter", None)
        if self.seen_mode not in (None, "model", "live"):
            raise ValueError(
                f"seenFilter must be 'model' or 'live', got {self.seen_mode!r}"
            )
        # a retrieval typo fails the deploy, not the first query
        self._retrieval = resolve_retrieval(self.params)

    def _config(self) -> ALSConfig:
        p = self.params
        return ALSConfig(
            rank=p.get_or("rank", 16),
            iterations=p.get_or("numIterations", 10),
            reg=p.get_or("lambda", 0.1),
            alpha=p.get_or("alpha", 40.0),
            implicit=p.get_or("implicitPrefs", False),
            seed=p.get_or("seed", 0),
            dtype=p.get_or("factorDtype", "float32"),
            factor_sharding=p.get_or("factorSharding", "auto"),
            # "auto"/"pallas": the fused gather->Gram kernel; "xla": the
            # unfused gather + products
            solver=p.get_or("alsSolver", "auto"),
        )

    def train(self, ctx, prepared) -> RecommendationModel:
        ratings_data, als_data = prepared
        warn_misplaced_packing_params(self.params, "recommendation")
        streamed = ratings_data.streamed
        seen_mode = self.seen_mode or ("live" if streamed else "model")
        if streamed and seen_mode == "model":
            raise ValueError(
                "the streaming reader materializes no edges, so there is "
                'no O(edges) seen map to train in; use "seenFilter": "live"'
            )
        if seen_mode == "live" and ratings_data.eval_fold:
            # a live read sees the WHOLE store -- including the held-out
            # test events -- and would score every 'actual' item -inf,
            # collapsing fold metrics to zero. Evaluation folds carry
            # their train-edge arrays, so the trained-in map is both
            # correct and available.
            logger.info(
                "seenFilter 'live' downgraded to 'model' for this "
                "evaluation fold (a live read would exclude held-out items)"
            )
            seen_mode = "model"
        model = fit_with_checkpoint(
            ctx,
            als_data,
            self._config(),
            user_ids=ratings_data.user_ids,
            item_ids=ratings_data.item_ids,
            interval=self.params.get_or("checkpointInterval", 5),
            mesh=mesh_or_none(ctx),
        )
        return RecommendationModel(
            als=model,
            user_index={uid: idx for idx, uid in enumerate(ratings_data.user_ids)},
            item_ids=list(ratings_data.item_ids),
            item_index={iid: idx for idx, iid in enumerate(ratings_data.item_ids)},
            # "live" keeps the serving model O(entities): no seen map
            seen=(
                build_seen(ratings_data.users, ratings_data.items)
                if seen_mode == "model" else {}
            ),
            seen_mode=seen_mode,
            app_name=ratings_data.app_name,
            event_names=list(ratings_data.event_names),
            eval_fold=ratings_data.eval_fold,
            # a streamed build on a non-default channel reads that channel
            channel_name=ratings_data.channel_name,
        )

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

    supports_fold_in = True

    def shard_model(
        self, model: RecommendationModel, shard: int, num_shards: int
    ) -> RecommendationModel:
        """Keep only the user rows ``shardmap.shard_of`` assigns to
        ``shard`` (reference ``:438-470``); item factors, item vocab, and
        the norm caches' inputs are replicated untouched.

        Row scoring is per-row (einsum over one user's factor vector, and
        the retrieval index is built from the item side alone), so
        compacting the user table cannot change a kept user's scores by a
        bit. Users filtered OUT of this shard simply miss ``user_index``
        -- the cold-user path -- which is correct because the frontend
        routes their queries to the owning shard. A shard's model
        serializes like any other (``serialize_model``): that is the
        per-shard blob of a registry version (``online/loop.py``).
        """
        if num_shards <= 1:
            return model
        from predictionio_tpu_torch.serving.shardmap import shard_of

        # original row order preserved: renumbering must be a pure
        # compaction, never a reorder
        by_row = sorted(model.user_index.items(), key=lambda kv: kv[1])
        kept = [
            (uid, row) for uid, row in by_row
            if shard_of(uid, num_shards) == shard
        ]
        rank = model.als.user_factors.shape[1]
        if kept:
            rows = np.asarray([row for _, row in kept], dtype=np.int64)
            user_factors = np.ascontiguousarray(model.als.user_factors[rows])
        else:
            user_factors = np.empty((0, rank), dtype=model.als.user_factors.dtype)
        seen = {
            new_row: model.seen[old_row]
            for new_row, (_, old_row) in enumerate(kept)
            if old_row in model.seen
        }
        return RecommendationModel(
            als=ALSModel(
                user_factors=user_factors,
                item_factors=model.als.item_factors,
            ),
            user_index={uid: new for new, (uid, _) in enumerate(kept)},
            item_ids=model.item_ids,
            item_index=model.item_index,
            seen=seen,
            seen_mode=model.seen_mode,
            app_name=model.app_name,
            event_names=model.event_names,
            channel_name=model.channel_name,
        )

    def fold_in(self, model: RecommendationModel, delta) -> RecommendationModel | None:
        """Continuous-learning hook (``pio retrain --follow``): re-solve
        the delta window's touched user rows against the frozen item
        factors (``online.foldin``, one B1 launch on ``cuda``), extend
        vocabularies for new users/items (new items carry zero factors
        until the next full retrain -- the staleness budget bounds how
        long that lasts), and absorb the window into a trained-in seen
        map. Returns a NEW model; the serving swap protocol relies on the
        old one staying intact."""
        # imported here: the online package's loop imports the templates
        from predictionio_tpu_torch.online.foldin import fold_in_als_model

        result = fold_in_als_model(
            model.als,
            model.user_index,
            model.item_ids,
            model.item_index,
            delta,
            self._config(),
            # the training read scores property-less events 1.0
            rating_default=1.0,
            device=self.device,
        )
        if result is None:
            return None
        seen = model.seen
        if model.seen_mode == "model" and result.window_pairs is not None:
            seen = {u: set(s) for u, s in model.seen.items()}
            for u, i in result.window_pairs.tolist():
                seen.setdefault(int(u), set()).add(int(i))
        return RecommendationModel(
            als=result.als,
            user_index=result.user_index,
            item_ids=result.item_ids,
            item_index=result.item_index,
            seen=seen,
            seen_mode=model.seen_mode,
            app_name=model.app_name,
            event_names=model.event_names,
            channel_name=model.channel_name,
        )

    def query_from_json(self, obj):
        """A query names a ``user`` or ``items`` (``predict``'s two kinds):
        one that names neither is refused here, before it reaches a batch
        (``pio batchpredict`` writes it an error row)."""
        if isinstance(obj, dict) and "user" not in obj and "items" not in obj:
            raise ValueError("query must contain 'user' or 'items'")
        return obj

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
        # live seen filter: one store read per distinct user of the chunk
        seen_memo: dict = {}
        out = batch_score_known_users(
            model.als,
            user_rows,
            lambda scores, qid, q, user_idx: (
                qid,
                self._topk_response(
                    model, scores, q, int(q.get("num", 10)), user_idx,
                    seen=_seen_indices(model, q, user_idx, seen_memo,
                                       live=self.seen_mode == "live"),
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
        user_idx: int, seen: set | None = None,
    ) -> dict:
        """Shared filter + top-k over one user's item scores (predict and
        the vectorized batch path must rank identically). ``seen`` lets
        the batch path pass a memoized live lookup."""
        # blackList always applies; the seen-items filter is opt-out
        exclude = {
            model.item_index[b]
            for b in (query.get("blackList") or [])
            if b in model.item_index
        }
        if query.get("unseenOnly", True):
            exclude |= (
                seen if seen is not None else _seen_indices(model, query, user_idx)
            )
        for idx in exclude:
            scores[idx] = -np.inf
        return topk_item_scores(model.item_ids, scores, num)

    def _recommend_for_user(self, model: RecommendationModel, query, num: int) -> dict:
        user_idx = model.user_index.get(str(query["user"]))
        if user_idx is None:
            return {"itemScores": []}  # cold user: reference returns empty
        scores = score_known_user(model.als, user_idx, self._retrieval, device=self.device)
        seen = _seen_indices(model, query, user_idx, live=self.seen_mode == "live")
        return self._topk_response(model, scores, query, num, user_idx, seen=seen)

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
