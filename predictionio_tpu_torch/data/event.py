"""Event model: the append-only record everything else is built on.

Copy of ``predictionio_tpu/data/event.py`` (framework-free), whole: the
field set, the name validation rules, the reserved ``$set/$unset/$delete``
semantics, the JSON wire shape in both directions (``Event.from_json_obj``,
``Event.to_json_obj``, ISO times to the millisecond) and event ids
(``with_id``), which the event store, the event server and ``pio
import``/``export`` share.
"""

from __future__ import annotations

import datetime as _dt
import uuid
from dataclasses import dataclass, field, replace
from typing import Any, Mapping

from predictionio_tpu_torch.data.datamap import DataMap

#: Reserved event names with entity-property mutation semantics.
SET_EVENT = "$set"
UNSET_EVENT = "$unset"
DELETE_EVENT = "$delete"
SPECIAL_EVENTS = frozenset({SET_EVENT, UNSET_EVENT, DELETE_EVENT})


class EventValidationError(ValueError):
    """Raised when an event violates the wire contract."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise EventValidationError(msg)


def validate_event_name(name: str) -> None:
    """Reserved-prefix rules: ``$``-events other than set/unset/delete and any
    ``pio_``-prefixed name are rejected (SURVEY.md Appendix A)."""
    _require(bool(name), "event name must not be empty")
    if name.startswith("$"):
        _require(name in SPECIAL_EVENTS, f"unsupported reserved event {name!r}")
    else:
        _require(not name.startswith("pio_"), f"event name {name!r}: prefix 'pio_' is reserved")


#: reserved entity types the framework itself writes (feedback loop)
INTERNAL_ENTITY_TYPES = frozenset({"pio_pr"})


def validate_entity(kind: str, value: str) -> None:
    _require(isinstance(value, str), f"{kind} must be a string, got {type(value).__name__}")
    _require(bool(value), f"{kind} must not be empty")
    # the pio_pr exemption is for entity *types* (feedback loop); ids keep the
    # full reserved-prefix rule
    exempt = kind in ("entityType", "targetEntityType") and value in INTERNAL_ENTITY_TYPES
    _require(
        not value.startswith("pio_") or exempt,
        f"{kind} {value!r}: prefix 'pio_' is reserved",
    )


def parse_event_time(value: str) -> _dt.datetime:
    """Parse an ISO-8601 timestamp; naive times are taken as UTC."""
    _require(isinstance(value, str), f"eventTime must be a string, got {type(value).__name__}")
    try:
        # Accept the trailing-Z form the SDKs emit.
        ts = _dt.datetime.fromisoformat(value.replace("Z", "+00:00"))
    except ValueError as exc:
        raise EventValidationError(f"cannot parse eventTime {value!r}: {exc}") from None
    if ts.tzinfo is None:
        ts = ts.replace(tzinfo=_dt.timezone.utc)
    return ts


def format_event_time(ts: _dt.datetime) -> str:
    if ts.tzinfo is None:
        ts = ts.replace(tzinfo=_dt.timezone.utc)
    return ts.isoformat(timespec="milliseconds")


def _utcnow() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


@dataclass(frozen=True)
class Event:
    """One immutable event record (wire contract: SURVEY.md Appendix A)."""

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: str | None = None
    target_entity_id: str | None = None
    properties: DataMap = field(default_factory=DataMap)
    event_time: _dt.datetime = field(default_factory=_utcnow)
    event_id: str | None = None
    pr_id: str | None = None
    creation_time: _dt.datetime = field(default_factory=_utcnow)

    def __post_init__(self):
        # normalize naive datetimes to UTC so mixed-source events compare/sort
        # and serialize consistently (frozen dataclass: use object.__setattr__)
        if self.event_time.tzinfo is None:
            object.__setattr__(
                self, "event_time", self.event_time.replace(tzinfo=_dt.timezone.utc)
            )
        if self.creation_time.tzinfo is None:
            object.__setattr__(
                self, "creation_time", self.creation_time.replace(tzinfo=_dt.timezone.utc)
            )
        validate_event_name(self.event)
        validate_entity("entityType", self.entity_type)
        validate_entity("entityId", self.entity_id)
        _require(
            (self.target_entity_type is None) == (self.target_entity_id is None),
            "targetEntityType and targetEntityId must be set together",
        )
        if self.target_entity_type is not None:
            validate_entity("targetEntityType", self.target_entity_type)
            validate_entity("targetEntityId", self.target_entity_id)
        if self.event == UNSET_EVENT:
            _require(len(self.properties) > 0, "$unset event requires non-empty properties")
        if self.event == DELETE_EVENT:
            _require(
                self.target_entity_type is None,
                "$delete event must not have a target entity",
            )
        if self.event in (SET_EVENT, UNSET_EVENT):
            _require(
                self.target_entity_type is None,
                f"{self.event} event must not have a target entity",
            )

    # -- JSON wire serde ----------------------------------------------------
    @classmethod
    def from_json_obj(cls, obj: Mapping[str, Any]) -> "Event":
        _require(isinstance(obj, Mapping), "event body must be a JSON object")
        _require("event" in obj, "field 'event' is required")
        _require("entityType" in obj, "field 'entityType' is required")
        _require("entityId" in obj, "field 'entityId' is required")
        props = obj.get("properties")
        if props is None:
            props = {}
        _require(isinstance(props, Mapping), "'properties' must be a JSON object")
        event_time = (
            parse_event_time(obj["eventTime"]) if obj.get("eventTime") else _utcnow()
        )
        _require(isinstance(obj["event"], str), "'event' must be a string")
        return cls(
            event=obj["event"],
            entity_type=str(obj["entityType"]),
            entity_id=str(obj["entityId"]),
            target_entity_type=obj.get("targetEntityType"),
            target_entity_id=obj.get("targetEntityId"),
            properties=DataMap(props),
            event_time=event_time,
            event_id=obj.get("eventId"),
            pr_id=obj.get("prId"),
            **(
                {"creation_time": parse_event_time(obj["creationTime"])}
                if obj.get("creationTime")
                else {}
            ),
        )

    def to_json_obj(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "eventId": self.event_id,
            "event": self.event,
            "entityType": self.entity_type,
            "entityId": self.entity_id,
        }
        if self.target_entity_type is not None:
            out["targetEntityType"] = self.target_entity_type
            out["targetEntityId"] = self.target_entity_id
        out["properties"] = self.properties.to_dict()
        out["eventTime"] = format_event_time(self.event_time)
        if self.pr_id is not None:
            out["prId"] = self.pr_id
        out["creationTime"] = format_event_time(self.creation_time)
        return out

    def with_id(self, event_id: str | None = None) -> "Event":
        return replace(self, event_id=event_id or uuid.uuid4().hex)
