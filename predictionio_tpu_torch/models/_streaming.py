"""The serving-time live event-store lookups of the templates.

Copy of ``live_target_events`` and ``live_seen_indices``
(``predictionio_tpu/models/_streaming.py:118-169``, framework-free): a
query reads the user's item-target events from the store (through
``LEventStore``), so events ingested after training filter at once and
the model stays O(entities). They serve ``seenFilter: "live"`` (ALS,
NCF) and ``historyMode: "live"`` (SASRec). The rest of that module, the
streaming sharded reader (``"reader": "streaming"``), is ROADMAP.md
Queue A item 8.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("pio.streaming")


def live_target_events(model, user: str) -> list:
    """The query user's item-target events, read live from the store.

    Reads the model's ``app_name``/``channel_name``/``event_names``
    (getattr-safe: pickled models may predate the fields). Degrades to an
    empty list -- with one warning -- on any store error: serving must
    not 500 because a backend blinked. An unresolvable app short-circuits
    without a per-request failing lookup.
    """
    app_name = getattr(model, "app_name", "")
    if not user or not app_name:
        return []
    from predictionio_tpu_torch.data.store import LEventStore

    try:
        return list(
            LEventStore.find(
                app_name,
                entity_type="user",
                entity_id=user,
                channel_name=getattr(model, "channel_name", None),
                event_names=getattr(model, "event_names", None) or None,
                target_entity_type="item",
            )
        )
    except Exception:
        logger.warning(
            "live history lookup failed; serving without user history",
            exc_info=True,
        )
        return []


def live_seen_indices(model, user: str, cache: dict | None = None) -> set[int]:
    """The user's already-interacted item indices, read live.

    THE live seen-lookup (recommendation, NCF, and e-commerce all filter
    through it): item ids map through ``model.item_index``; ``cache``
    memoizes per user for bulk paths. Store errors degrade inside
    live_target_events.
    """
    key = user
    if cache is not None and key in cache:
        return cache[key]
    out = {
        model.item_index[e.target_entity_id]
        for e in live_target_events(model, user)
        if e.target_entity_id in model.item_index
    }
    if cache is not None:
        cache[key] = out
    return out
