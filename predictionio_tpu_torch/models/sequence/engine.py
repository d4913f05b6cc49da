"""DASE components of the sequential-recommendation template.

Port of ``predictionio_tpu/models/sequence/engine.py``. Per-user event
histories -> next-item prediction. Query contracts: ``{"user": "u1",
"num": 4}`` (recommend from the user's trained-in history) and
``{"items": ["i3", "i9"], "num": 4}`` (session-based: recommend from an
explicit prefix), with ``blackList`` and ``unseenOnly``. Response:
``{"itemScores": [{"item", "score"}, ...]}``.

- ``SequenceDataSource`` reads the event store (``PEventStore.dataset``
  of the ``appName`` app), or a JSON-lines events file when built with
  ``events_path=``, and groups each user's items in event-time order
  (``group_sequences``: one lexsort, then a grouped scan; ``minSeqLen``).
- ``SequencePreparator`` left-truncates to ``maxLen``, right-pads and
  shifts ids by one (0 = padding).
- ``SASRecAlgorithm.train`` runs ``train_sasrec`` on the algorithm's
  device (the flash kernels B4-B6 on ``cuda``), over ``ctx.mesh`` in a
  multi-process launch (``pio.mesh_axes`` ``["data", "seq"]``: batch and
  sequence sharded, ``seqParallel`` ring or Ulysses); rank 0's full
  params are the model it persists, as every rank's are; ``predict`` and
  ``batch_predict`` score through the model's network on that device, B4
  in every transformer block.

``historyMode: "live"`` continues the user's events read from the store
per query (``models/_streaming.py``) instead of the trained-in history:
when the model was trained so, or the serving engine.json asks for it.
``SequenceDataSource.read_eval`` (reference ``:109-140``) holds out each
user's last item per fold (leave-one-out) for ``pio eval``.
"""

from __future__ import annotations

import threading
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
from predictionio_tpu_torch.data.store import PEventStore, read_events_file
from predictionio_tpu_torch.models._als_common import score_buffer_rows, topk_item_scores
from predictionio_tpu_torch.models._streaming import live_target_events
from predictionio_tpu_torch.models.sequence.model import (
    SASRecConfig,
    network,
    score_next_items,
    score_next_items_batch,
    train_sasrec,
)
from predictionio_tpu_torch.utils.device import resolve_device

#: guards first-query network construction across serving threads
_NETWORK_BUILD_LOCK = threading.Lock()


@dataclass
class SequencesData(SanityCheck):
    """Per-user time-ordered item-index sequences + vocabularies.

    Item indices are 0-based here; the model shifts by +1 (0 = padding).
    """

    sequences: list[np.ndarray]
    user_ids: list[str]
    item_ids: list[str]
    app_name: str = ""
    event_names: list[str] = field(default_factory=list)

    def sanity_check(self) -> None:
        if not self.sequences:
            raise ValueError(
                "no event sequences found -- check appName (or the events file) "
                "and eventNames"
            )

    @property
    def num_items(self) -> int:
        return len(self.item_ids)


def group_sequences(users, items, times, user_vocab, min_len: int = 2):
    """``(sequences, user ids)``: each user's items ordered by event time
    (ties keep their input order), users in index order, histories
    shorter than ``min_len`` dropped. One vectorized (user, time) sort,
    then a grouped scan, as the reference's DataSource does."""
    users, items, times = (np.asarray(a) for a in (users, items, times))
    sequences, seq_user_ids = [], []
    if users.size:
        order = np.lexsort((times, users))
        users, items = users[order], items[order]
        boundaries = np.flatnonzero(np.diff(users)) + 1
        for hist, u in zip(np.split(items, boundaries), users[np.r_[0, boundaries]]):
            if len(hist) >= min_len:
                sequences.append(hist.astype(np.int64))
                seq_user_ids.append(user_vocab[int(u)])
    return sequences, seq_user_ids


class SequenceDataSource(DataSource):
    """Groups item-interaction events per user, ordered by event time.

    Params: ``appName`` (required to read the store), ``eventNames``
    (default ``["view", "buy", "rate"]``), ``minSeqLen`` (drop shorter
    histories, default 2), ``evalFolds``/``evalK`` for read_eval. With
    ``events_path`` the JSON-lines events file is read in place of the
    store.
    """

    def __init__(self, params=None, *, events_path: str | None = None):
        super().__init__(params)
        self.events_path = events_path

    def read_training(self, ctx) -> SequencesData:
        event_names = self.params.get_or("eventNames", ["view", "buy", "rate"])
        if self.events_path is None:
            ds = PEventStore.dataset(self.params.appName, event_names=event_names,
                                     target_entity_type="item")
        else:
            ds = read_events_file(self.events_path, event_names=event_names,
                                  target_entity_type="item")
        valid = ds.target_entity_ids >= 0
        sequences, user_ids = group_sequences(
            ds.entity_ids[valid], ds.target_entity_ids[valid], ds.event_times[valid],
            ds.entity_id_vocab, self.params.get_or("minSeqLen", 2),
        )
        return SequencesData(
            sequences=sequences,
            user_ids=user_ids,
            item_ids=ds.target_entity_id_vocab,
            app_name=self.params.get_or("appName", ""),
            event_names=list(event_names),
        )

    def read_eval(self, ctx):
        """Leave-one-out per fold: hold out each user's last item as the
        actual, query on the preceding history (the SASRec protocol)."""
        data = self.read_training(ctx)
        folds = self.params.get_or("evalFolds", 1)
        eval_k = self.params.get_or("evalK", 10)
        out = []
        for f in range(folds):
            train_seqs, pairs, users = [], [], []
            for uid, seq in zip(data.user_ids, data.sequences):
                if len(seq) < 3:
                    train_seqs.append(seq)
                    users.append(uid)
                    continue
                cut = len(seq) - 1 - (f % max(len(seq) - 2, 1))
                train_seqs.append(seq[:cut])
                users.append(uid)
                pairs.append(
                    (
                        {"items": [data.item_ids[i] for i in seq[:cut]],
                         "num": eval_k},
                        [data.item_ids[seq[cut]]],
                    )
                )
            out.append(
                (
                    SequencesData(train_seqs, users, data.item_ids),
                    EvalInfo(fold=f),
                    pairs,
                )
            )
        return out


@dataclass
class PackedSequences(SanityCheck):
    matrix: np.ndarray            # [N, max_len] int32, ids shifted +1, 0 = pad
    data: SequencesData

    def sanity_check(self) -> None:
        self.data.sanity_check()


class SequencePreparator(Preparator):
    """Pad/left-truncate histories to maxLen and shift ids (+1, 0 = pad).

    Params: ``maxLen`` (default 64).
    """

    def prepare(self, ctx, data: SequencesData) -> PackedSequences:
        max_len = self.params.get_or("maxLen", 64)
        matrix = np.zeros((len(data.sequences), max_len), np.int32)
        for row, seq in enumerate(data.sequences):
            tail = seq[-max_len:] + 1
            matrix[row, : len(tail)] = tail
        return PackedSequences(matrix=matrix, data=data)


@dataclass
class SASRecModel:
    """The trained ``SASRec`` state dict (host f32 tensors), its config,
    the item vocabulary and every user's trained-in history (shifted +1
    ids). The network goes to a device once per device, lazily
    (``network``); none of it is persisted (``convert.save_model`` writes
    arrays and JSON)."""

    state: dict
    config: SASRecConfig
    item_ids: list[str]
    item_index: dict[str, int]
    histories: dict[str, np.ndarray]   # user id -> shifted (+1) id sequence
    #: "model": queries continue the trained-in history above; "live":
    #: the user's events read from the store per query (``app_name`` /
    #: ``event_names`` say what to read), no histories kept
    history_mode: str = "model"
    app_name: str = ""
    event_names: list[str] = None
    _networks: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    def network(self, device):
        """The serving ``SASRec`` on ``device``, built once (the query
        server is a ThreadingHTTPServer: concurrent first queries must not
        each upload the weights)."""
        key = str(device)
        found = self._networks.get(key)
        if found is None:
            with _NETWORK_BUILD_LOCK:
                found = self._networks.get(key)
                if found is None:
                    found = network(self.state, self.config, device)
                    self._networks[key] = found
        return found


class SASRecAlgorithm(Algorithm):
    """Params: embedDim, numHeads, numBlocks, ffnDim, dropout, learningRate,
    batchSize, epochs, seed, maxLen (must match the preparator's and
    divide over the mesh's ``seq`` axis), seqParallel ("ring" or
    "ulysses": the attention across ranks when the mesh has a ``seq``
    axis above 1), attention ("auto" | "flash" | "plain") and historyMode
    ("model", or "live": a query continues the user's events read from
    the store, and the model keeps no histories).

    ``device`` is where training runs and the network serves: ``cuda``
    unless the caller names ``"cpu"``; without a card and without an
    explicit CPU request construction raises."""

    model_files = ModelFiles("sequence", "predictionio_tpu_torch.models.sequence.convert")

    def __init__(self, params=None, *, device=None):
        super().__init__(params)
        self.device = resolve_device(device)
        self.history_mode = self.params.get_or("historyMode", "model")
        if self.history_mode not in ("model", "live"):
            raise ValueError(
                f"historyMode must be 'model' or 'live', got {self.history_mode!r}"
            )

    def train(self, ctx, prepared: PackedSequences) -> SASRecModel:
        p = self.params
        data = prepared.data
        max_len = p.get_or("maxLen", None)
        if max_len is not None and max_len != prepared.matrix.shape[1]:
            raise ValueError(
                f"algorithm maxLen={max_len} != preparator maxLen="
                f"{prepared.matrix.shape[1]}; set both to the same value "
                "(or drop the algorithm's)"
            )
        config = SASRecConfig(
            num_items=data.num_items,
            max_len=prepared.matrix.shape[1],
            embed_dim=p.get_or("embedDim", 32),
            num_heads=p.get_or("numHeads", 2),
            num_blocks=p.get_or("numBlocks", 2),
            ffn_dim=p.get_or("ffnDim", 64),
            dropout=p.get_or("dropout", 0.0),
            learning_rate=p.get_or("learningRate", 1e-3),
            batch_size=p.get_or("batchSize", 256),
            epochs=p.get_or("epochs", 10),
            seed=p.get_or("seed", 0),
            seq_parallel=p.get_or("seqParallel", "ring"),
            attention=p.get_or("attention", "auto"),
        )
        mesh = mesh_or_none(ctx)
        with ctx.journal("sasrec") as telemetry:
            state, _ = train_sasrec(config, prepared.matrix, self.device, mesh=mesh,
                                    telemetry=telemetry)
        return SASRecModel(
            state=state,
            config=config,
            item_ids=list(data.item_ids),
            item_index={iid: j for j, iid in enumerate(data.item_ids)},
            # live mode: O(entities) model; queries read fresh histories
            histories={} if self.history_mode == "live" else {
                uid: seq + 1 for uid, seq in zip(data.user_ids, data.sequences)
            },
            history_mode=self.history_mode,
            app_name=data.app_name,
            event_names=list(data.event_names),
        )

    def warm_up(self, model: SASRecModel) -> None:
        """Put the network on the device at deploy and run one forward,
        so the first query neither uploads weights nor loads the kernels'
        device code."""
        score_next_items(model.network(self.device), np.ones(1, np.int64))

    @staticmethod
    def _resolve_prefix(model: SASRecModel, query, live: bool = False):
        """The sequence to continue: explicit ``items`` anchor or the user's
        training history. None/empty means a cold query (empty response)."""
        if query.get("items"):
            return np.asarray(
                [
                    model.item_index[str(i)] + 1
                    for i in query["items"]
                    if str(i) in model.item_index
                ],
                np.int64,
            )
        user = str(query.get("user"))
        if not live and model.history_mode != "live":
            return model.histories.get(user)
        # time-ASCENDING: the sequence the model continues
        events = sorted(live_target_events(model, user), key=lambda e: e.event_time)
        seq = [
            model.item_index[e.target_entity_id] + 1
            for e in events
            if e.target_entity_id in model.item_index
        ]
        # FULL history, untruncated: the unseenOnly exclusion must cover
        # everything the user saw; the scorer keeps only the max_len tail
        return np.asarray(seq, np.int64) if seq else None

    @staticmethod
    def _topk_response(model: SASRecModel, scores: np.ndarray, query, prefix) -> dict:
        """Shared exclusion + ranking tail (predict and batch_predict must
        rank identically)."""
        scores = scores.astype(np.float64)
        exclude = (
            {int(i) - 1 for i in prefix} if query.get("unseenOnly", True) else set()
        )
        exclude |= {
            model.item_index[str(b)]
            for b in (query.get("blackList") or [])
            if str(b) in model.item_index
        }
        for j in exclude:
            scores[j] = -np.inf
        return topk_item_scores(model.item_ids, scores, int(query.get("num", 10)))

    def predict(self, model: SASRecModel, query) -> dict:
        prefix = self._resolve_prefix(model, query, self.history_mode == "live")
        if prefix is None or len(prefix) == 0:
            return {"itemScores": []}
        scores = score_next_items(model.network(self.device), prefix)
        return self._topk_response(model, scores, query, prefix)

    def batch_predict(self, model: SASRecModel, queries):
        """Fixed-size slices of prefixes run one forward + vocab
        projection each (score_next_items_batch) instead of one per query.
        Cold/malformed queries fall through to predict()."""
        resolved, fallback = [], []
        for qid, q in queries:
            prefix = (self._resolve_prefix(model, q, self.history_mode == "live")
                      if isinstance(q, dict) else None)
            if prefix is None or len(prefix) == 0:
                fallback.append((qid, q))
            else:
                resolved.append((qid, q, prefix))
        out = []
        if resolved:
            # bound the host [rows, vocab] buffer like the other batch
            # paths, rounded down to a power of two as the reference does
            rows = score_buffer_rows(len(model.item_ids), floor=16, cap=1024)
            rows = 1 << (rows.bit_length() - 1)
            net = model.network(self.device)
            for start in range(0, len(resolved), rows):
                part = resolved[start : start + rows]
                scores = score_next_items_batch(net, [p for _, _, p in part])
                out.extend(
                    (qid, self._topk_response(model, scores[row], q, prefix))
                    for row, (qid, q, prefix) in enumerate(part)
                )
        out.extend((qid, self.predict(model, q)) for qid, q in fallback)
        return out


def engine_factory() -> Engine:
    return Engine(
        data_source_class=SequenceDataSource,
        preparator_class=SequencePreparator,
        algorithm_class_map={"sasrec": SASRecAlgorithm},
        serving_class=FirstServing,
    )
