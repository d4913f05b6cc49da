"""DASE components of the Universal Recommender template.

Port of ``predictionio_tpu/models/universal/engine.py``: correlated
cross-occurrence over several event types, LLR-weighted. The FIRST name
in ``eventNames`` is the primary (conversion) event; ``URAlgorithm.train``
builds one self-cooccurrence indicator table on it and one
cross-occurrence table per other type, each through ``ops/cooccurrence.
py::cooccurrence_indicators`` on ``device`` (``cuda`` unless ``"cpu"``):
the one-hot products, the LLR and the per-row top-k on the card.
Scoring sums indicator weights over the user's per-type histories, with
the business rules (blacklist, property filters and boosts) applied on
the host; that side (``URModel`` through ``batch_predict``, reference
``:147-193``, ``:348-455``) and ``read_eval`` are copied.

The DataSource reads the store (``PEventStore.find`` and the item
``$set`` aggregate), or a JSON-lines events file when built with
``events_path=``. With ``"reader": "streaming"`` it returns a
``StreamingHandle``, and ``train`` (reference ``:270-345``) streams one
source per event type over one shared user and item universe
(``streaming_multi_event_sources``, primed by ``universe_pass`` unless a
snapshot replay fixed it), each type's user-rows CSR through
``build_cooc_csr_sharded``; the model reads user histories live. The
per-user histories of a materialized build are built in one sorted pass
per event type (the reference walks the events in Python); the map is
the same.

Query contract: ``{"user": "u1", "num": 4, "blackList": [...],
"fields": [{"name": "category", "values": ["books"], "bias": -1}]}``
-> ``{"itemScores": [...]}``. ``bias < 0`` filters, ``bias >= 0``
multiplies matching items' scores.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from predictionio_tpu_torch.controller.base import (
    Algorithm,
    DataSource,
    EvalInfo,
    SanityCheck,
    mesh_or_none,
)
from predictionio_tpu_torch.data.store import (
    PEventStore,
    read_events,
    read_item_properties,
)
from predictionio_tpu_torch.models._als_common import topk_order
from predictionio_tpu_torch.models._streaming import (
    StreamingHandle,
    live_target_events,
    refuse_streaming_file,
    streaming_handle_or_none,
)
from predictionio_tpu_torch.models.similarproduct.engine import user_histories
from predictionio_tpu_torch.ops.cooccurrence import (
    cooccurrence_indicators,
    distinct_user_counts,
)
from predictionio_tpu_torch.ops.ragged import pack_padded_csr
from predictionio_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("pio.torch.universal")


@dataclass
class MultiEventData(SanityCheck):
    """Per-event-type COO interactions over one shared user/item universe."""

    event_names: list[str]                      # [0] is primary
    per_event: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]]  # (u, i, t)
    user_ids: list[str]
    item_ids: list[str]
    item_properties: dict[str, dict]            # item id -> properties

    def sanity_check(self) -> None:
        primary = self.event_names[0]
        if primary not in self.per_event or self.per_event[primary][0].size == 0:
            raise ValueError(f"no events of primary type {primary!r} found")


class URDataSource(DataSource):
    """Params: appName, eventNames (primary first; default ["buy", "view"]).
    With ``events_path`` the JSON-lines events file is read in place of
    the store."""

    def __init__(self, params=None, *, events_path: str | None = None):
        super().__init__(params)
        self.events_path = events_path
        refuse_streaming_file(self.params, events_path)

    def _read(self) -> MultiEventData:
        event_names = self.params.get_or("eventNames", ["buy", "view"])
        if self.events_path is None:
            events = PEventStore.find(
                self.params.appName,
                event_names=event_names,
                target_entity_type="item",
            )
            props = PEventStore.aggregate_properties(
                self.params.appName, entity_type="item"
            )
        else:
            events = sorted(
                (e for e in read_events(self.events_path)
                 if e.event in event_names and e.target_entity_type == "item"),
                key=lambda e: int(e.event_time.timestamp() * 1000),
            )
            props = read_item_properties(self.events_path)
        user_index: dict[str, int] = {}
        item_index: dict[str, int] = {}
        raw: dict[str, list[tuple[int, int, float]]] = {n: [] for n in event_names}
        for e in events:
            if e.target_entity_id is None:
                continue
            u = user_index.setdefault(e.entity_id, len(user_index))
            i = item_index.setdefault(e.target_entity_id, len(item_index))
            raw[e.event].append((u, i, e.event_time.timestamp()))
        per_event = {}
        for name, triples in raw.items():
            if triples:
                arr = np.array(triples, dtype=np.float64)
                per_event[name] = (
                    arr[:, 0].astype(np.int64),
                    arr[:, 1].astype(np.int64),
                    arr[:, 2],
                )
            else:
                per_event[name] = (
                    np.zeros(0, np.int64),
                    np.zeros(0, np.int64),
                    np.zeros(0, np.float64),
                )
        return MultiEventData(
            event_names=list(event_names),
            per_event=per_event,
            user_ids=list(user_index),
            item_ids=list(item_index),
            item_properties={iid: pm.to_dict() for iid, pm in props.items()},
        )

    def read_training(self, ctx):
        handle = streaming_handle_or_none(
            self.params, ["buy", "view"], probe_primary_only=True
        )
        if handle is not None:
            handle.empty_message = (
                f"no events of primary type {handle.event_names[0]!r} found"
            )
        return handle if handle is not None else self._read()

    def read_eval(self, ctx):
        """Hold out each user's most recent PRIMARY interaction."""
        data = self._read()
        data.sanity_check()  # empty store: fail with the real message, not IndexError
        primary = data.event_names[0]
        u, i, t = data.per_event[primary]
        order = np.lexsort((t, u))
        u, i, t = u[order], i[order], t[order]
        last = np.r_[u[1:] != u[:-1], True]
        held = {int(uu): int(ii) for uu, ii, l in zip(u, i, last) if l}
        train = MultiEventData(
            event_names=data.event_names,
            per_event={
                **data.per_event,
                primary: (u[~last], i[~last], t[~last]),
            },
            user_ids=data.user_ids,
            item_ids=data.item_ids,
            item_properties=data.item_properties,
        )
        pairs = [
            (
                {"user": data.user_ids[uu], "num": self.params.get_or("evalK", 10)},
                [data.item_ids[ii]],
            )
            for uu, ii in held.items()
        ]
        return [(train, EvalInfo(fold=0), pairs)]


@dataclass
class URModel:
    event_names: list[str]
    item_ids: list[str]
    item_index: dict[str, int]
    #: per event type: reverse indicator index -- history item j ->
    #: [(primary item p, weight)] (inverted from the per-p top-k table so a
    #: query costs O(history * hits), not O(history * items * k))
    indicators: dict[str, dict[int, list[tuple[int, float]]]]
    #: user id -> {event type -> [item indices]}
    user_history: dict[str, dict[str, list[int]]]
    item_properties: dict[str, dict]
    #: "model": the trained-in map above; "live": per-query event-store
    #: read (O(entities) serving -- the streaming reader's contract, and
    #: fresh events enter the history without retrain). Old pickles
    #: predate these fields; readers use getattr defaults.
    history_mode: str = "model"
    app_name: str = ""
    channel_name: str = None


def _invert_indicators(
    idx: np.ndarray, vals: np.ndarray
) -> dict[int, list[tuple[int, float]]]:
    inverted: dict[int, list[tuple[int, float]]] = {}
    for p in range(idx.shape[0]):
        for j, v in zip(idx[p], vals[p]):
            if v > 0:
                inverted.setdefault(int(j), []).append((p, float(v)))
    return inverted


def _user_history(model: "URModel", user: str) -> dict[str, list[int]]:
    """{event type -> [item indices]} for the query user.

    Live mode reads the event store per request (the streaming reader's
    serving contract); a store error degrades to an empty history rather
    than a 500.
    """
    if getattr(model, "history_mode", "model") != "live":
        return dict(model.user_history.get(user, {}))
    out: dict[str, list[int]] = {}
    for e in live_target_events(model, user):
        j = model.item_index.get(e.target_entity_id)
        if j is not None:
            out.setdefault(e.event, []).append(j)
    return out


class URAlgorithm(Algorithm):
    """Params: topK (indicators per anchor, default 50), maxEventsPerUser,
    chunk.

    ``device`` is where the cross-occurrence runs: ``cuda`` unless the
    caller names ``"cpu"``; without a card and without an explicit CPU
    request construction raises.
    """

    def __init__(self, params=None, *, device=None):
        super().__init__(params)
        self.device = resolve_device(device)

    def train(self, ctx, data) -> URModel:
        if isinstance(data, StreamingHandle):
            return self._train_streaming(ctx, data)
        max_len = self.params.get_or("maxEventsPerUser", None)
        chunk = self.params.get_or("chunk", 4096)
        top_k = self.params.get_or("topK", 50)
        n_users, n_items = len(data.user_ids), len(data.item_ids)

        def to_csr(triples):
            uu, ii, tt = triples
            return pack_padded_csr(
                uu, ii, np.ones(uu.size, np.float32), n_users, n_items,
                times=tt, max_len=max_len,
            )

        primary_csr = to_csr(data.per_event[data.event_names[0]])
        # diagonals are distinct-user counts: O(nnz) on host, no extra matmuls
        primary_counts = distinct_user_counts(primary_csr)
        indicators: dict[str, dict[int, list[tuple[int, float]]]] = {}
        for name in data.event_names:
            if data.per_event[name][0].size == 0:
                continue
            is_primary = name == data.event_names[0]
            csr = primary_csr if is_primary else to_csr(data.per_event[name])
            col_counts = (
                primary_counts if is_primary else distinct_user_counts(csr)
            )
            # fused cooc -> LLR -> top-k on the device: only the [items,
            # topK] indicators leave it, never the [items, items] matrix
            indicators[name] = _invert_indicators(
                *cooccurrence_indicators(
                    primary_csr,
                    None if is_primary else csr,
                    top_k=top_k,
                    llr_row_totals=primary_counts,
                    llr_col_totals=col_counts,
                    total=n_users,
                    drop_diagonal=is_primary,
                    chunk=chunk,
                    device=self.device,
                )
            )
        history: dict[str, dict[str, list[int]]] = {}
        for name in data.event_names:
            uu, ii, _ = data.per_event[name]
            for user, items in user_histories(uu, ii, data.user_ids, self.device).items():
                history.setdefault(user, {})[name] = items
        return URModel(
            event_names=list(data.event_names),
            item_ids=list(data.item_ids),
            item_index={iid: j for j, iid in enumerate(data.item_ids)},
            indicators=indicators,
            user_history=history,
            item_properties=data.item_properties,
        )

    def _train_streaming(self, ctx, src) -> URModel:
        """Every event type's CSR through the streaming reader over ONE
        shared entity universe (the per-type sources' shared encoders);
        the indicators equal the materialized build's. Costs 1 + 2 *
        len(event_names) scans (or memmap replays) -- bounded memory is
        the trade."""
        from predictionio_tpu_torch.models._streaming import (
            streaming_multi_event_sources,
        )
        from predictionio_tpu_torch.parallel.reader import (
            build_cooc_csr_sharded,
            distinct_user_counts_sharded,
            universe_pass,
        )

        max_len = self.params.get_or("maxEventsPerUser", None)
        chunk = self.params.get_or("chunk", 4096)
        top_k = self.params.get_or("topK", 50)
        sources, users_enc, items_enc, universe_ready = (
            streaming_multi_event_sources(
                src, runtime_conf=getattr(ctx, "runtime_conf", None)
            )
        )
        if not universe_ready:
            # fix the shared universe before any build (a snapshot replay
            # comes back with the encoders already complete)
            universe_pass(sources)
        n_users, n_items = len(users_enc.ids), len(items_enc.ids)

        primary = src.event_names[0]
        mesh = mesh_or_none(ctx)  # user rows sharded over data, summed
        primary_csr = build_cooc_csr_sharded(
            sources[primary], n_users, n_items, mesh, max_len=max_len, chunk=chunk,
        )
        primary_counts = distinct_user_counts_sharded(primary_csr, mesh)
        indicators = {}
        for name in src.event_names:
            is_primary = name == primary
            csr = (
                primary_csr if is_primary
                else build_cooc_csr_sharded(
                    sources[name], n_users, n_items, mesh, max_len=max_len, chunk=chunk,
                )
            )
            if csr.global_edges == 0 and not is_primary:
                # GLOBAL emptiness (from the counts pass): every rank takes
                # the same branch around the collectives below
                continue
            col_counts = (
                primary_counts if is_primary
                else distinct_user_counts_sharded(csr, mesh)
            )
            indicators[name] = _invert_indicators(
                *cooccurrence_indicators(
                    primary_csr,
                    None if is_primary else csr,
                    top_k=top_k,
                    llr_row_totals=primary_counts,
                    llr_col_totals=col_counts,
                    total=n_users,
                    drop_diagonal=is_primary,
                    chunk=chunk,
                    device=self.device,
                    mesh=mesh,
                )
            )
        item_props = {
            iid: pm.to_dict()
            for iid, pm in PEventStore.aggregate_properties(
                src.app_name, entity_type="item",
                channel_name=src.channel_name,
            ).items()
        }
        return URModel(
            event_names=list(src.event_names),
            item_ids=list(items_enc.ids),
            item_index={iid: j for j, iid in enumerate(items_enc.ids)},
            indicators=indicators,
            user_history={},
            item_properties=item_props,
            history_mode="live",
            app_name=src.app_name,
            channel_name=src.channel_name,
        )

    @staticmethod
    def _rule_multiplier(model: URModel, rule, cache: dict | None) -> np.ndarray:
        """One ``fields`` rule's per-item multiplier. The match scan is
        O(items) of python property probing -- by far the dominant cost of
        a rule-carrying query -- so batch_predict memoizes it per DISTINCT
        rule across the whole batch."""
        name, values = rule.get("name"), set(map(str, rule.get("values", [])))
        bias = float(rule.get("bias", -1))
        key = (name, tuple(sorted(values)), bias)
        if cache is not None and key in cache:
            return cache[key]
        matches = np.array(
            [
                str(model.item_properties.get(iid, {}).get(name)) in values
                or bool(
                    isinstance(model.item_properties.get(iid, {}).get(name), list)
                    and values
                    & set(map(str, model.item_properties[iid][name]))
                )
                for iid in model.item_ids
            ]
        )
        mult = (
            np.where(matches, 1.0, 0.0)
            if bias < 0
            else np.where(matches, bias, 1.0)
        )
        if cache is not None:
            cache[key] = mult
        return mult

    def _predict_impl(
        self,
        model: URModel,
        query,
        rule_cache: dict | None = None,
        history_memo: dict | None = None,
    ) -> dict:
        num = int(query.get("num", 10))
        user = str(query.get("user", ""))
        if history_memo is not None:
            if user not in history_memo:
                history_memo[user] = _user_history(model, user)
            history = dict(history_memo[user])  # copied before any mutation
        else:
            history = _user_history(model, user)
        # item-anchored queries act as view-history of the primary type
        if "items" in query:
            anchors = [
                model.item_index[str(i)]
                for i in query["items"]
                if str(i) in model.item_index
            ]
            history[model.event_names[0]] = (
                history.get(model.event_names[0], []) + anchors
            )
        if not history:
            return {"itemScores": []}
        # CCO scoring via the reverse index: each history item j credits the
        # primary items whose top-k correlators include j
        scores = np.zeros(len(model.item_ids), dtype=np.float64)
        for name, items in history.items():
            inverted = model.indicators.get(name)
            if inverted is None:
                continue
            for j in set(items):
                for p, v in inverted.get(j, ()):
                    scores[p] += v
        exclude = {
            j
            for items in history.values()
            for j in items
        } if query.get("unseenOnly", True) else set()
        for b in query.get("blackList") or []:
            if str(b) in model.item_index:
                exclude.add(model.item_index[str(b)])
        # business rules: fields filters/boosts over item properties
        multipliers = np.ones(len(model.item_ids))
        for rule in query.get("fields") or []:
            multipliers *= self._rule_multiplier(model, rule, rule_cache)
        scores = scores * multipliers
        for j in exclude:
            scores[j] = 0.0
        order = topk_order(scores, num)
        return {
            "itemScores": [
                {"item": model.item_ids[j], "score": float(scores[j])}
                for j in order
                if scores[j] > 0
            ]
        }

    def predict(self, model: URModel, query) -> dict:
        return self._predict_impl(model, query)

    def batch_predict(self, model: URModel, queries):
        """Bulk scoring with per-batch memoization: business-rule match
        masks are built ONCE per distinct rule (they cost an O(items)
        python property scan each) and live user-history reads once per
        distinct user, instead of once per query. Scoring itself stays the
        reverse-index walk (already O(history * hits), not O(items));
        malformed queries raise predict()'s normal error."""
        rule_cache: dict = {}
        history_memo: dict = {}
        return [
            (qid, self._predict_impl(model, q, rule_cache, history_memo))
            for qid, q in queries
        ]
