"""Webhook connectors: map third-party payloads to Events.

Behavioral model: reference ``data/.../webhooks/{ConnectorUtil,JsonConnector,
FormConnector}.scala`` + segmentio/mailchimp connectors (apache/predictionio
layout, unverified -- SURVEY.md section 2.2 #14). Pluggable registry keyed by
the URL path segment under ``/webhooks/``.

Port copy: ``predictionio_tpu/data/webhooks.py`` (framework-free),
verbatim, under the port's package name; ``tests/test_torch_imports.py``
holds it to the original.
"""

from __future__ import annotations

import abc
from typing import Any, Mapping

from predictionio_tpu_torch.data.event import Event, EventValidationError


class ConnectorError(ValueError):
    pass


class JsonConnector(abc.ABC):
    """Maps a JSON webhook payload to an Event."""

    @abc.abstractmethod
    def to_event_json(self, payload: Mapping[str, Any]) -> Mapping[str, Any]: ...

    def to_event(self, payload: Mapping[str, Any]) -> Event:
        try:
            return Event.from_json_obj(self.to_event_json(payload))
        except EventValidationError as exc:
            raise ConnectorError(str(exc)) from exc


class FormConnector(abc.ABC):
    """Maps form-encoded webhook fields to an Event."""

    @abc.abstractmethod
    def to_event_json(self, form: Mapping[str, str]) -> Mapping[str, Any]: ...

    def to_event(self, form: Mapping[str, str]) -> Event:
        try:
            return Event.from_json_obj(self.to_event_json(form))
        except EventValidationError as exc:
            raise ConnectorError(str(exc)) from exc


class ExampleJsonConnector(JsonConnector):
    """Reference-style example connector (exampleJson parity role)."""

    def to_event_json(self, payload):
        for field in ("type", "userId"):
            if field not in payload:
                raise ConnectorError(f"webhook payload missing {field!r}")
        return {
            "event": payload["type"],
            "entityType": "user",
            "entityId": str(payload["userId"]),
            "properties": payload.get("properties", {}),
            **({"eventTime": payload["timestamp"]} if "timestamp" in payload else {}),
        }


class SegmentIOConnector(JsonConnector):
    """segment.com track-call mapping (SegmentIOConnector parity role)."""

    def to_event_json(self, payload):
        if payload.get("type") != "track":
            raise ConnectorError("segmentio connector only accepts 'track' calls")
        user = payload.get("userId") or payload.get("anonymousId")
        if not user:
            raise ConnectorError("segmentio payload has no userId/anonymousId")
        if not payload.get("event"):
            raise ConnectorError("segmentio payload missing 'event'")
        out = {
            "event": payload["event"],
            "entityType": "user",
            "entityId": str(user),
            "properties": payload.get("properties", {}),
        }
        if payload.get("timestamp"):
            out["eventTime"] = payload["timestamp"]
        return out


class ExampleFormConnector(FormConnector):
    def to_event_json(self, form):
        for field in ("type", "userId"):
            if field not in form:
                raise ConnectorError(f"webhook form missing {field!r}")
        return {
            "event": form["type"],
            "entityType": "user",
            "entityId": form["userId"],
            "properties": {
                k: v for k, v in form.items() if k not in ("type", "userId")
            },
        }


class MailChimpConnector(FormConnector):
    """MailChimp webhook mapping (MailChimpConnector parity role).

    MailChimp posts form-encoded fields: ``type`` (subscribe / unsubscribe /
    profile / upemail / cleaned / campaign), ``fired_at``, and bracketed
    ``data[...]`` fields. Subscriber events map to entityType=user (the
    subscriber id) targeting the list; campaign events map the campaign
    targeting the list.
    """

    _SUBSCRIBER_TYPES = ("subscribe", "unsubscribe", "profile", "upemail", "cleaned")

    def to_event_json(self, form):
        mc_type = form.get("type")
        if not mc_type:
            raise ConnectorError("mailchimp form missing 'type'")
        data = {
            k[len("data["):-1]: v
            for k, v in form.items()
            if k.startswith("data[") and k.endswith("]") and "][" not in k
        }
        properties = dict(data)

        if mc_type in self._SUBSCRIBER_TYPES:
            # upemail payloads carry new_id/new_email instead of id/email
            entity_id = (
                data.get("id")
                or data.get("new_id")
                or data.get("email")
                or data.get("new_email")
            )
            if not entity_id:
                raise ConnectorError(
                    f"mailchimp {mc_type!r} form missing data[id]/data[email]"
                )
            out = {
                "event": mc_type,
                "entityType": "user",
                "entityId": str(entity_id),
                "properties": properties,
            }
        elif mc_type == "campaign":
            if not data.get("id"):
                raise ConnectorError("mailchimp campaign form missing data[id]")
            out = {
                "event": mc_type,
                "entityType": "campaign",
                "entityId": str(data["id"]),
                "properties": properties,
            }
        else:
            raise ConnectorError(f"mailchimp webhook type {mc_type!r} not supported")

        if data.get("list_id"):
            out["targetEntityType"] = "list"
            out["targetEntityId"] = str(data["list_id"])
        if form.get("fired_at"):
            # MailChimp timestamps are naive UTC "YYYY-MM-DD HH:MM:SS"
            out["eventTime"] = form["fired_at"].replace(" ", "T") + "+00:00"
        return out


#: path segment under /webhooks/ -> connector instance
JSON_CONNECTORS: dict[str, JsonConnector] = {
    "example": ExampleJsonConnector(),
    "segmentio": SegmentIOConnector(),
}
FORM_CONNECTORS: dict[str, FormConnector] = {
    "exampleform": ExampleFormConnector(),
    "mailchimp": MailChimpConnector(),
}


def register_json_connector(name: str, connector: JsonConnector) -> None:
    JSON_CONNECTORS[name] = connector


def register_form_connector(name: str, connector: FormConnector) -> None:
    FORM_CONNECTORS[name] = connector
