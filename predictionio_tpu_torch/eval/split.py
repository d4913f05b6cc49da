"""Time-travel splits for offline replay evaluation.

The split contract: train on events strictly BEFORE ``t``, hold out
interactions AT-OR-AFTER ``t`` (``times >= t``) -- the boundary event
lands in the holdout, matching the snapshot layer's EXCLUSIVE ``until``
bound (``data/snapshot.Snapshot.until_time``) so a replay split and a
snapshot generation bounded at the same ``t`` cover exactly the same
prefix. Exactness is microsecond-level: the split time parses through
the same ``datetime.fromisoformat(...).timestamp()`` path
``EventDataset`` uses for event times, so an event stamped exactly ``t``
compares equal as float64 epoch seconds, never "close".

Copy of ``predictionio_tpu/eval/split.py`` (framework-free), verbatim after
the package rename.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field
from typing import Any

import numpy as np

#: the operator-facing format hint for malformed --split-time values
#: (the ``pio check --rules`` contract: exit 2 with the expectation
#: spelled out, never a traceback)
SPLIT_TIME_FORMAT = (
    "ISO-8601, e.g. 2024-01-31T00:00:00+00:00 (a naive timestamp is"
    " read as UTC)"
)


def parse_split_time(value: str) -> float:
    """``--split-time`` ISO string -> float64 epoch seconds.

    Naive timestamps are read as UTC (event times are stored UTC);
    anything ``datetime.fromisoformat`` rejects raises ``ValueError``
    carrying the expected format.
    """
    try:
        # same 'Z' normalization as event ingestion (data/event.py)
        parsed = _dt.datetime.fromisoformat(str(value).replace("Z", "+00:00"))
    except (ValueError, TypeError):
        raise ValueError(
            f"malformed --split-time {value!r}; expected {SPLIT_TIME_FORMAT}"
        ) from None
    if parsed.tzinfo is None:
        parsed = parsed.replace(tzinfo=_dt.timezone.utc)
    return parsed.timestamp()


def _iso(seconds: float) -> str:
    return _dt.datetime.fromtimestamp(
        seconds, tz=_dt.timezone.utc
    ).isoformat()


@dataclass(frozen=True)
class SplitSpec:
    """How to cut the event timeline: an explicit ISO boundary OR an
    event-count fraction (the boundary becomes the timestamp of the
    first held-out event, so a fraction split is as replayable as an
    explicit one). ``k`` rides along because the datasource hooks build
    top-``k`` queries for the held-out users."""

    split_time: str | None = None
    split_frac: float | None = None
    k: int = 10

    def validate(self) -> None:
        if (self.split_time is None) == (self.split_frac is None):
            raise ValueError(
                "exactly one of --split-time and --split-frac is required"
            )
        if self.split_time is not None:
            parse_split_time(self.split_time)
        if self.split_frac is not None and not 0.0 < self.split_frac < 1.0:
            raise ValueError(
                f"--split-frac must be in (0, 1), got {self.split_frac}"
            )
        if self.k < 1:
            raise ValueError(f"--k must be >= 1, got {self.k}")


@dataclass
class SplitBounds:
    """The resolved, replayable description of one split -- recorded in
    the report so a later run can reproduce it with --split-time."""

    split_time_iso: str
    split_frac: float | None
    train_events: int
    holdout_events: int
    holdout_users: int
    train_until_iso: str | None   # newest training event
    holdout_from_iso: str | None  # oldest held-out event

    def to_json_obj(self) -> dict:
        return dict(self.__dict__)


@dataclass
class SplitCut:
    """One template-agnostic cut of (users, items, times) arrays."""

    train_mask: np.ndarray                 # bool [n]
    holdout: dict[int, np.ndarray]         # user idx -> unique item idxs
    bounds: SplitBounds
    split_seconds: float


@dataclass
class ReplayFold:
    """What a datasource's ``read_replay`` hands the replay runner:
    prefix training data (template-shaped), per-held-out-user
    ``(query, [actual item ids])`` pairs, and the resolved bounds."""

    train_data: Any
    pairs: list = field(default_factory=list)
    bounds: SplitBounds | None = None


def resolve_split_seconds(times: np.ndarray, spec: SplitSpec) -> float:
    """The split boundary as epoch seconds. A fraction resolves to the
    timestamp of the event at the ``frac`` quantile of the TIME-SORTED
    stream (ties at that timestamp all land in the holdout -- the
    ``>= t`` rule keeps the split exact rather than exactly-sized)."""
    spec.validate()
    if spec.split_time is not None:
        return parse_split_time(spec.split_time)
    times = np.asarray(times, np.float64)
    if times.size == 0:
        raise ValueError("no events to split -- check appName and eventNames")
    idx = min(int(spec.split_frac * times.size), times.size - 1)
    return float(np.sort(times)[idx])


def split_interactions(
    users: np.ndarray,
    items: np.ndarray,
    times: np.ndarray,
    spec: SplitSpec,
) -> SplitCut:
    """Cut COO interaction arrays at the spec's boundary.

    Returns the train mask (``times < t``), the held-out interactions
    grouped per user (unique item indices, ascending user order -- the
    deterministic query order every run replays identically), and the
    resolved bounds.
    """
    times = np.asarray(times, np.float64)
    t = resolve_split_seconds(times, spec)
    train_mask = times < t
    hold = ~train_mask
    h_users = np.asarray(users)[hold]
    h_items = np.asarray(items)[hold]
    # sorted-split grouping (the build_seen construction): O(distinct
    # users) interpreter time, not O(events)
    holdout: dict[int, np.ndarray] = {}
    if h_users.size:
        order = np.argsort(h_users, kind="stable")
        su, si = h_users[order], h_items[order]
        uniq, starts = np.unique(su, return_index=True)
        ends = np.append(starts[1:], su.size)
        holdout = {
            int(u): np.unique(si[s:e])
            for u, s, e in zip(uniq.tolist(), starts.tolist(), ends.tolist())
        }
    bounds = SplitBounds(
        split_time_iso=_iso(t),
        split_frac=spec.split_frac,
        train_events=int(train_mask.sum()),
        holdout_events=int(hold.sum()),
        holdout_users=len(holdout),
        train_until_iso=_iso(float(times[train_mask].max()))
        if train_mask.any() else None,
        holdout_from_iso=_iso(float(times[hold].min()))
        if hold.any() else None,
    )
    return SplitCut(
        train_mask=train_mask, holdout=holdout, bounds=bounds,
        split_seconds=t,
    )
