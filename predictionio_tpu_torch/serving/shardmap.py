"""Shard routing for the sharded serving fabric.

One function decides which scorer shard owns a user, and every tier --
the frontend's ring picker, the shard process's model filter, and the
continuous-learning loop's touched-shard delta routing -- imports it
from here, so the partition can never skew between the process that
routes a query and the process that holds the factors.

Import-light on purpose: the frontend worker (serving/frontend.py) is a
no-jax, no-numpy interpreter, so only stdlib may be imported here.

The hash itself lives in ``utils/stablehash`` -- the ingest pipeline's
WAL-partition router buckets entities with the SAME function, so the
partition an event is durably ordered in always matches the shard that
serves the entity. See that module for the crc32-over-``hash()``
rationale (per-interpreter hash salting).

Port copy: ``predictionio_tpu/serving/shardmap.py`` (framework-free), verbatim,
under the port's package name; ``tests/test_torch_imports.py`` holds it
to the original.
"""

from __future__ import annotations

import json

from predictionio_tpu_torch.utils.stablehash import stable_bucket

__all__ = ["shard_of", "extract_user"]


def shard_of(user_id: str, num_shards: int) -> int:
    """The shard that owns ``user_id``'s factor rows (0-based)."""
    return stable_bucket(user_id, num_shards)


def extract_user(body: bytes) -> str | None:
    """The ``"user"`` field of a query body, or None.

    The frontend calls this before picking a ring; a malformed body or a
    userless query returns None and the caller falls back to any shard
    (item-side state is replicated, so every shard answers userless
    queries identically). Scalars are stringified exactly like the
    scorer's own ``str(query.get("user"))`` lookups, so router and
    model agree on the key.
    """
    try:
        obj = json.loads(body)
    except Exception:
        return None
    if not isinstance(obj, dict):
        return None
    user = obj.get("user")
    if user is None or isinstance(user, (dict, list, bool)):
        return None
    return str(user)
