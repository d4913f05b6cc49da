"""Entity-property aggregation: fold ``$set/$unset/$delete`` streams.

Behavioral model: reference ``data/.../storage/LEventAggregator.scala``
(apache/predictionio layout, unverified -- SURVEY.md section 2.2 #5):

- events are folded in ``event_time`` order per entity;
- ``$set`` merges the event's properties over the current map;
- ``$unset`` removes the named keys;
- ``$delete`` clears the entity entirely (a later ``$set`` re-creates it);
- ``first_updated`` / ``last_updated`` track the surviving window -- a
  ``$delete`` resets ``first_updated`` to the next mutation's time;
- an entity whose final state is deleted (or never set) yields no entry.

Port copy: ``predictionio_tpu/data/aggregation.py`` (framework-free),
verbatim, under the port's package name; ``tests/test_torch_imports.py``
holds it to the original.
"""

from __future__ import annotations

from typing import Iterable, Optional

from predictionio_tpu_torch.data.datamap import DataMap, PropertyMap
from predictionio_tpu_torch.data.event import (
    DELETE_EVENT,
    SET_EVENT,
    SPECIAL_EVENTS,
    UNSET_EVENT,
    Event,
)


def aggregate_entity(events: Iterable[Event]) -> Optional[PropertyMap]:
    """Fold one entity's special events into its current PropertyMap.

    ``events`` may arrive in any order; they are sorted by
    ``(event_time, creation_time)`` before folding. Returns ``None`` if the
    entity ends up deleted or was never ``$set``.
    """
    ordered = sorted(events, key=lambda e: (e.event_time, e.creation_time))
    props: DataMap | None = None
    first = last = None
    for ev in ordered:
        if ev.event not in SPECIAL_EVENTS:
            continue
        if ev.event == SET_EVENT:
            props = (props or DataMap()).updated(ev.properties)
        elif ev.event == UNSET_EVENT:
            if props is None:
                continue
            props = props.removed(ev.properties.keys())
        elif ev.event == DELETE_EVENT:
            props = None
            first = last = None
            continue
        if first is None:
            first = ev.event_time
        last = ev.event_time
    if props is None or first is None:
        return None
    return PropertyMap(props.to_dict(), first_updated=first, last_updated=last)


def aggregate_properties(events: Iterable[Event]) -> dict[str, PropertyMap]:
    """Group special events by entity_id and fold each (one entity_type).

    Mirrors the contract of ``LEvents.aggregateProperties`` /
    ``PEventStore.aggregateProperties`` (SURVEY.md section 2.2 #7/#12): the
    caller has already filtered to a single ``entity_type``.
    """
    by_entity: dict[str, list[Event]] = {}
    for ev in events:
        if ev.event in SPECIAL_EVENTS:
            by_entity.setdefault(ev.entity_id, []).append(ev)
    out: dict[str, PropertyMap] = {}
    for entity_id, evs in by_entity.items():
        pm = aggregate_entity(evs)
        if pm is not None:
            out[entity_id] = pm
    return out
