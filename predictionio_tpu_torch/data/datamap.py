"""DataMap: the JSON-object wrapper attached to events.

Copy of the parts of ``DataMap`` (``predictionio_tpu/data/datamap.py``,
framework-free) that the event record and the training read use: an
event's ``properties`` JSON object as an immutable mapping, and
``get_opt``. The typed getters and the aggregated ``PropertyMap`` belong
to the event store, which the port does not have yet.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping


class DataMapError(KeyError):
    """Raised when a required field is missing."""


class DataMap(Mapping[str, Any]):
    """Immutable mapping over an event's ``properties`` JSON object."""

    __slots__ = ("_fields",)

    def __init__(self, fields: Mapping[str, Any] | None = None):
        self._fields: dict[str, Any] = dict(fields or {})

    def __getitem__(self, key: str) -> Any:
        try:
            return self._fields[key]
        except KeyError:
            raise DataMapError(f"required field {key!r} not found") from None

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, key: object) -> bool:
        return key in self._fields

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DataMap):
            return self._fields == other._fields
        if isinstance(other, Mapping):
            return self._fields == dict(other)
        return NotImplemented

    def __hash__(self) -> int:
        # Event is a frozen dataclass whose generated __hash__ hashes this
        # field; values may be unhashable JSON, so hash a canonical dump.
        import json

        return hash(json.dumps(self._fields, sort_keys=True, default=str))

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"

    def get_opt(self, name: str, default: Any = None) -> Any:
        return self._fields.get(name, default)
