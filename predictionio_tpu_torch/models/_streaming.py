"""The templates' scan descriptor and serving-time live event-store lookups.

Copy of ``predictionio_tpu/models/_streaming.py:23-169``
(framework-free):

- ``StreamingHandle``, ``build_streaming_handle`` and
  ``streaming_handle_or_none`` (``:23-117``): where and what a template
  scans (app, channel, event names, rating key), pinned at an exclusive
  ``until_time``. ``DataSource.online_handle`` builds one for the
  continuous-learning loop (``online/loop.py``), which keys its snapshot
  and WAL filter on it. ``streaming_handle_or_none`` is the opt-in gate
  of the sharded reader (``"reader": "streaming"``); the port's
  DataSources refuse that reader (ROADMAP.md Queue A item 8), so the
  gate has no caller until that item lands.
- ``live_target_events`` and ``live_seen_indices`` (``:118-169``): a
  query reads the user's item-target events from the store (through
  ``LEventStore``), so events ingested after training filter at once
  and the model stays O(entities). They serve ``seenFilter: "live"``
  (ALS, NCF) and ``historyMode: "live"`` (SASRec).

The rest of that module, the streaming sharded reader, is item 8.
"""

from __future__ import annotations

import datetime as _dt
import logging
from dataclasses import dataclass, field

from predictionio_tpu_torch.controller.base import SanityCheck

logger = logging.getLogger("pio.streaming")

#: what a datasource's ``"reader": "streaming"`` raises until the sharded
#: reader is ported
STREAMING_NOT_PORTED = (
    'datasource "reader": "streaming" (the sharded reader) is not ported '
    "yet: ROADMAP.md Queue A item 8; leave it out"
)


@dataclass
class StreamingHandle(SanityCheck):
    """Lazy training handle: no arrays, just where/what to stream."""

    app_name: str
    app_id: int
    channel_id: int | None
    channel_name: str | None
    event_names: list[str]
    rating_key: str = "rating"
    chunk_rows: int = 262_144
    #: events whose absence means "no data"; None probes all of event_names
    probe_event_names: list[str] | None = None
    empty_message: str = "no events found -- check appName and eventNames"
    #: template-specific DATASOURCE knobs the preparator/algorithm need:
    #: DASE keeps per-component params separate, so values configured on
    #: the datasource ride the handle
    extras: dict = field(default_factory=dict)
    #: EXCLUSIVE scan bound captured when the handle is created; also the
    #: snapshot layer's coverage boundary
    until_time: _dt.datetime = field(
        default_factory=lambda: _dt.datetime.now(_dt.timezone.utc)
    )

    def sanity_check(self) -> None:
        from predictionio_tpu_torch.data import storage

        probe = list(
            storage.get_l_events().find(
                app_id=self.app_id,
                channel_id=self.channel_id,
                event_names=self.probe_event_names or self.event_names,
                limit=1,
            )
        )
        if not probe:
            raise ValueError(self.empty_message)


def build_streaming_handle(
    params,
    default_event_names: list[str],
    probe_primary_only: bool = False,
    empty_message: str | None = None,
) -> StreamingHandle:
    """Build the scan descriptor a datasource's params pin down --
    unconditionally. The continuous-learning loop
    (``DataSource.online_handle``) builds one regardless of the reader
    opt-in, because the handle is also the identity of the snapshot the
    loop refreshes and the WAL filter it follows."""
    from predictionio_tpu_torch.data.store import resolve_app_channel

    event_names = params.get_or("eventNames", default_event_names)
    app_id, channel_id = resolve_app_channel(
        params.appName, params.get_or("channelName", None)
    )
    return StreamingHandle(
        app_name=params.appName,
        app_id=app_id,
        channel_id=channel_id,
        channel_name=params.get_or("channelName", None),
        event_names=list(event_names),
        rating_key=params.get_or("ratingKey", "rating"),
        chunk_rows=params.get_or("chunkRows", 262_144),
        probe_event_names=[event_names[0]] if probe_primary_only else None,
        empty_message=empty_message
        or "no events found -- check appName and eventNames",
    )


def streaming_handle_or_none(
    params,
    default_event_names: list[str],
    probe_primary_only: bool = False,
    empty_message: str | None = None,
) -> StreamingHandle | None:
    """The shared ``read_training`` branch: a StreamingHandle when the
    datasource params opt in (``"reader": "streaming"``), else None."""
    if params.get_or("reader", "materialized") != "streaming":
        return None
    return build_streaming_handle(
        params, default_event_names, probe_primary_only, empty_message
    )


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
