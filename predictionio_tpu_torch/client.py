"""Python client SDK for the Event and Query servers.

Copy of ``predictionio_tpu/client.py``. Parity role of the reference
ecosystem's ``predictionio`` Python SDK (SURVEY.md §1 L7: the client SDKs
live outside the framework repo, but their WIRE CONTRACT — the event
JSON shape, ``accessKey`` auth, the ``/events.json`` and
``/queries.json`` endpoints — is part of this framework's compatibility
surface, see Appendix A). Stdlib-only (urllib), synchronous, keep-alive
is the server's concern.

    from predictionio_tpu_torch.client import EventClient, EngineClient

    events = EventClient("http://localhost:7070", access_key=KEY)
    events.create(event="rate", entity_type="user", entity_id="u1",
                  target_entity_type="item", target_entity_id="i3",
                  properties={"rating": 5})

    engine = EngineClient("http://localhost:8000")
    engine.query({"user": "u1", "num": 4})
"""

from __future__ import annotations

import datetime as _dt
import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Any


class PIOServerError(RuntimeError):
    """Non-2xx response from an event/query server."""

    def __init__(self, status: int, body: str):
        super().__init__(f"HTTP {status}: {body[:300]}")
        self.status = status
        self.body = body


class PIOConnectionError(PIOServerError):
    """The server could not be reached at all (refused, DNS, timeout).

    Subclasses PIOServerError so SDK users have ONE error hierarchy to
    catch; ``status`` is 0 because no HTTP response exists."""

    def __init__(self, reason: str):
        RuntimeError.__init__(self, f"connection failed: {reason}")
        self.status = 0
        self.body = ""


def _request(
    method: str, url: str, payload: Any | None = None, timeout: float = 10.0
) -> Any:
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = resp.read().decode()
    except urllib.error.HTTPError as exc:
        raise PIOServerError(exc.code, exc.read().decode()) from None
    except (urllib.error.URLError, OSError) as exc:
        # URLError wraps refused/DNS; bare OSError covers socket timeouts
        # and resets mid-read -- all "never reached a response" failures
        raise PIOConnectionError(str(exc)) from None
    return json.loads(body) if body else None


class EventClient:
    """Talks to the Event Server (default :7070) for one app's access key."""

    def __init__(self, url: str, access_key: str, channel: str | None = None,
                 timeout: float = 10.0):
        self.url = url.rstrip("/")
        self.access_key = access_key
        self.channel = channel
        self.timeout = timeout

    def _qs(self, extra: dict | None = None) -> str:
        params = {"accessKey": self.access_key}
        if self.channel:
            params["channel"] = self.channel
        params.update(extra or {})
        return urllib.parse.urlencode(params)

    @staticmethod
    def _event_body(
        event: str,
        entity_type: str,
        entity_id: str,
        target_entity_type: str | None = None,
        target_entity_id: str | None = None,
        properties: dict | None = None,
        event_time: _dt.datetime | str | None = None,
    ) -> dict:
        body: dict[str, Any] = {
            "event": event, "entityType": entity_type, "entityId": entity_id,
        }
        if target_entity_type is not None:
            body["targetEntityType"] = target_entity_type
        if target_entity_id is not None:
            body["targetEntityId"] = target_entity_id
        if properties is not None:
            # an explicit {} must survive to the wire: an empty $set is a
            # legal "touch" (updates lastUpdated) and differs from no field
            body["properties"] = properties
        if event_time is not None:
            body["eventTime"] = (
                event_time.isoformat()
                if isinstance(event_time, _dt.datetime)
                else event_time
            )
        return body

    def create(self, **kwargs) -> str:
        """POST one event; returns its eventId. Kwargs mirror the wire
        contract: event, entity_type, entity_id, target_entity_type,
        target_entity_id, properties, event_time."""
        out = _request(
            "POST",
            f"{self.url}/events.json?{self._qs()}",
            self._event_body(**kwargs),
            self.timeout,
        )
        return out["eventId"]

    def set_properties(self, entity_type: str, entity_id: str, properties: dict) -> str:
        return self.create(event="$set", entity_type=entity_type,
                           entity_id=entity_id, properties=properties)

    def unset_properties(self, entity_type: str, entity_id: str, keys: list[str]) -> str:
        return self.create(event="$unset", entity_type=entity_type,
                           entity_id=entity_id,
                           properties={k: None for k in keys})

    def delete_entity(self, entity_type: str, entity_id: str) -> str:
        return self.create(event="$delete", entity_type=entity_type,
                           entity_id=entity_id)

    def create_batch(self, events: list[dict]) -> list[dict]:
        """POST up to 50 raw event dicts (wire shape); returns the per-item
        status array in order."""
        return _request(
            "POST", f"{self.url}/batch/events.json?{self._qs()}", events,
            self.timeout,
        )

    def get(self, event_id: str) -> dict:
        # explicit ids from imports may carry reserved chars ('/', '?')
        eid = urllib.parse.quote(event_id, safe="")
        return _request(
            "GET", f"{self.url}/events/{eid}.json?{self._qs()}",
            timeout=self.timeout,
        )

    def delete(self, event_id: str) -> None:
        eid = urllib.parse.quote(event_id, safe="")
        _request(
            "DELETE", f"{self.url}/events/{eid}.json?{self._qs()}",
            timeout=self.timeout,
        )

    def find(self, **filters) -> list[dict]:
        """GET /events.json with the reference filter set (camelCase keys:
        startTime, untilTime, entityType, entityId, event, limit, ...)."""
        return _request(
            "GET",
            f"{self.url}/events.json?{self._qs(filters)}",
            timeout=self.timeout,
        )


class EngineClient:
    """Talks to a deployed Query Server (default :8000)."""

    def __init__(self, url: str, timeout: float = 10.0):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def query(self, query: dict) -> dict:
        """POST /queries.json -> the template's PredictedResult JSON."""
        return _request(
            "POST", f"{self.url}/queries.json", query, self.timeout
        )
