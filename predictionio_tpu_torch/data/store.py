"""Columnar training read of the port: an events file -> ``EventDataset``.

``EventDataset`` and its ``from_events`` are a copy of
``predictionio_tpu/data/store.py:80-110`` (framework-free numpy): string
columns dictionary-encoded in first-appearance order, numeric columns
dense. ``read_events_file`` stands in for ``pio import`` + the event
store + ``PEventStore.dataset`` until the port has a store of its own:
it reads a JSON-lines file in the ``pio import`` wire shape (one event
object per line, ``docs/quickstart-recommendation.md``), keeps the events
the store's query would return -- names in ``event_names``, target type
``target_entity_type`` -- in the store's scan order (event time
ascending, ties in file order), and encodes them.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from predictionio_tpu_torch.data.event import Event


@dataclass
class EventDataset:
    """Columnar view of an event query result.

    String-valued columns are dictionary-encoded: ``entity_ids[i]`` indexes
    into ``entity_id_vocab``. Numeric columns are dense numpy arrays.
    """

    events: list[Event]
    entity_id_vocab: list[str]
    target_entity_id_vocab: list[str]
    event_name_vocab: list[str]
    entity_ids: np.ndarray        # int32 [n]
    target_entity_ids: np.ndarray # int32 [n], -1 when absent
    event_names: np.ndarray       # int32 [n]
    event_times: np.ndarray       # float64 [n], epoch seconds
    ratings: np.ndarray           # float32 [n], properties["rating"] or NaN

    def __len__(self) -> int:
        return int(self.entity_ids.size)

    @classmethod
    def from_events(cls, events: list[Event], rating_key: str = "rating") -> "EventDataset":
        ent_vocab: dict[str, int] = {}
        tgt_vocab: dict[str, int] = {}
        name_vocab: dict[str, int] = {}
        n = len(events)
        ent = np.empty(n, dtype=np.int32)
        tgt = np.full(n, -1, dtype=np.int32)
        names = np.empty(n, dtype=np.int32)
        times = np.empty(n, dtype=np.float64)
        ratings = np.full(n, np.nan, dtype=np.float32)
        for i, ev in enumerate(events):
            ent[i] = ent_vocab.setdefault(ev.entity_id, len(ent_vocab))
            if ev.target_entity_id is not None:
                tgt[i] = tgt_vocab.setdefault(ev.target_entity_id, len(tgt_vocab))
            names[i] = name_vocab.setdefault(ev.event, len(name_vocab))
            times[i] = ev.event_time.timestamp()
            r = ev.properties.get_opt(rating_key)
            if isinstance(r, (int, float)) and not isinstance(r, bool):
                ratings[i] = float(r)
        return cls(
            events=events,
            entity_id_vocab=list(ent_vocab),
            target_entity_id_vocab=list(tgt_vocab),
            event_name_vocab=list(name_vocab),
            entity_ids=ent,
            target_entity_ids=tgt,
            event_names=names,
            event_times=times,
            ratings=ratings,
        )


def read_events(path: str) -> list[Event]:
    """Every event of a JSON-lines file (blank lines skipped), validated
    by ``Event.from_json_obj``; a bad line raises with its line number."""
    events = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            if not line.strip():
                continue
            try:
                events.append(Event.from_json_obj(json.loads(line)))
            except ValueError as exc:
                raise ValueError(f"{path}:{lineno}: {exc}") from None
    return events


def read_events_file(
    path: str,
    *,
    event_names: list[str] | None = None,
    target_entity_type: str | None = "item",
    rating_key: str = "rating",
) -> EventDataset:
    """The training read of ``PEventStore.dataset(..., event_names=...,
    target_entity_type=...)`` over an events file: filter first, then
    encode, so vocabularies hold only the entities of the kept events."""
    kept = [
        ev for ev in read_events(path)
        if (event_names is None or ev.event in event_names)
        and (target_entity_type is None or ev.target_entity_type == target_entity_type)
    ]
    # the store scans by event time (millisecond resolution); sorted() is
    # stable, so ties keep their file order
    kept = sorted(kept, key=lambda ev: int(ev.event_time.timestamp() * 1000))
    return EventDataset.from_events(kept, rating_key=rating_key)
