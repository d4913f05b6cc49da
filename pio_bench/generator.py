"""The one generator of the benchmark's traffic: rating events drawn from a
seed by the laws a traffic file names, at the sizes a configuration
states.

A traffic file (``pio_bench/traffic/<name>.json``) holds only parameters:

    {"users": {"law": "power", "exponent": 4.4, "floor": 20},
     "items": {"law": "power", "exponent": 2.2},
     "ratings": {"low": 1, "high": 5},
     "times": "index"}

- ``power``: ``floor(min(u ** exponent, clip) * n)`` for ``u`` uniform on
  ``[0, 1)`` (``clip`` 0.999999 by default): id ``j`` is drawn with
  density ``(j / n) ** (1 / exponent - 1)``, low ids popular, the recipe
  of ``bench.py:68-78``.
- ``floor`` (either side, default 0): every id first gets that many
  events, and the law draws the rest; the events are then shuffled.
- ratings: integers from ``low`` to ``high``.
- ``times: "index"``: event ``i`` happens at second ``i``.

The draws run in one ``numpy`` generator seeded by the run's seed, in a
fixed order (users, items, ratings, then the shuffle where a floor asks
for it), so one seed always gives the same events.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

ID_LAWS = ("power",)


@dataclass
class Ratings:
    users: np.ndarray    # int64 [E]
    items: np.ndarray    # int64 [E]
    ratings: np.ndarray  # float32 [E]
    times: np.ndarray    # float64 [E]
    num_users: int
    num_items: int


def _ids(rng: np.random.Generator, law: dict, n: int, size: int) -> np.ndarray:
    kind = law.get("law")
    if kind == "power":
        u = np.minimum(rng.random(size) ** float(law["exponent"]), float(law.get("clip", 0.999999)))
        return (u * n).astype(np.int64)
    raise ValueError(f"unknown id law {kind!r}; known: {ID_LAWS}")


def _side(rng: np.random.Generator, law: dict, n: int, events: int) -> np.ndarray:
    floor = int(law.get("floor", 0))
    if floor * n > events:
        raise ValueError(f"a floor of {floor} events for each of {n} ids exceeds {events} events")
    drawn = _ids(rng, law, n, events - floor * n)
    if not floor:
        return drawn
    return np.concatenate([np.repeat(np.arange(n, dtype=np.int64), floor), drawn])


def ratings(traffic: dict, num_users: int, num_items: int, events: int, seed: int) -> Ratings:
    """The events of one run."""
    rng = np.random.default_rng(seed)
    users = _side(rng, traffic["users"], num_users, events)
    items = _side(rng, traffic["items"], num_items, events)
    spec = traffic["ratings"]
    values = rng.integers(int(spec["low"]), int(spec["high"]) + 1, size=events).astype(np.float32)
    if traffic["users"].get("floor") or traffic["items"].get("floor"):
        order = rng.permutation(events)
        users, items, values = users[order], items[order], values[order]
    if traffic.get("times") != "index":
        raise ValueError(f"unknown times {traffic.get('times')!r}; known: 'index'")
    times = np.arange(events, dtype=np.float64)
    return Ratings(users, items, values, times, num_users, num_items)
