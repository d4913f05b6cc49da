"""DataMap / PropertyMap: typed JSON-object wrappers attached to events.

Copy of ``predictionio_tpu/data/datamap.py`` (framework-free), whole: an
event's ``properties`` JSON object as an immutable mapping with typed
getters (``get_string``, ``get_int``, ``get_double``, ...) and the
functional updates the ``$set/$unset`` fold uses, and ``PropertyMap``,
the aggregated entity properties with their first and last update
times that ``PEventStore.aggregate_properties`` returns
(``data/aggregation.py``).
"""

from __future__ import annotations

import datetime as _dt
from typing import Any, Iterator, Mapping


class DataMapError(KeyError):
    """Raised when a required field is missing or has the wrong type."""


def _check_type(name: str, value: Any, expected: type | tuple[type, ...]) -> Any:
    # bool is an int subclass in Python; only accept it when bool is expected.
    if expected in (int, float, (int, float)) and isinstance(value, bool):
        raise DataMapError(f"field {name!r} has type bool, expected {expected}")
    if isinstance(value, expected):
        return value
    # JSON has one number type; allow int where float is asked for.
    if expected is float and isinstance(value, int):
        return float(value)
    raise DataMapError(
        f"field {name!r} has type {type(value).__name__}, expected {expected}"
    )


class DataMap(Mapping[str, Any]):
    """Immutable mapping over an event's ``properties`` JSON object."""

    __slots__ = ("_fields",)

    def __init__(self, fields: Mapping[str, Any] | None = None):
        self._fields: dict[str, Any] = dict(fields or {})

    # -- Mapping protocol ---------------------------------------------------
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
        # field; values may be unhashable JSON (lists/objects), so hash a
        # canonical dump instead.
        import json

        return hash(json.dumps(self._fields, sort_keys=True, default=str))

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"

    # -- typed getters (reference: DataMap.get[T]/getOpt[T]) ----------------
    def get_string(self, name: str) -> str:
        return _check_type(name, self[name], str)

    def get_int(self, name: str) -> int:
        return _check_type(name, self[name], int)

    def get_double(self, name: str) -> float:
        return _check_type(name, self[name], float)

    def get_boolean(self, name: str) -> bool:
        return _check_type(name, self[name], bool)

    def get_list(self, name: str) -> list:
        # copy so callers cannot mutate the map through the returned list
        return list(_check_type(name, self[name], list))

    def get_string_list(self, name: str) -> list[str]:
        val = self.get_list(name)
        for i, item in enumerate(val):
            _check_type(f"{name}[{i}]", item, str)
        return val

    def get_double_list(self, name: str) -> list[float]:
        val = self.get_list(name)
        return [_check_type(f"{name}[{i}]", v, float) for i, v in enumerate(val)]

    def get_opt(self, name: str, default: Any = None) -> Any:
        return self._fields.get(name, default)

    # -- functional updates (used by the $set/$unset fold) ------------------
    def updated(self, other: "DataMap | Mapping[str, Any]") -> "DataMap":
        merged = dict(self._fields)
        merged.update(dict(other))
        return DataMap(merged)

    def removed(self, keys) -> "DataMap":
        drop = set(keys)
        return DataMap({k: v for k, v in self._fields.items() if k not in drop})

    def to_dict(self) -> dict[str, Any]:
        return dict(self._fields)


class PropertyMap(DataMap):
    """Aggregated entity properties with first/last update times.

    Produced by folding an entity's ``$set/$unset/$delete`` event stream
    (reference ``LEventAggregator.scala`` behavior, SURVEY.md section 2.2 #5).
    """

    __slots__ = ("first_updated", "last_updated")

    def __init__(
        self,
        fields: Mapping[str, Any] | None,
        first_updated: _dt.datetime,
        last_updated: _dt.datetime,
    ):
        super().__init__(fields)
        self.first_updated = first_updated
        self.last_updated = last_updated

    def __repr__(self) -> str:
        return (
            f"PropertyMap({self.to_dict()!r}, "
            f"first_updated={self.first_updated.isoformat()}, "
            f"last_updated={self.last_updated.isoformat()})"
        )
