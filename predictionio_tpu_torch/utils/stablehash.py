"""The ONE stable entity-hash definition shared by serving and ingest.

Both the serving fabric's shard router (``serving/shardmap.shard_of``)
and the ingest pipeline's WAL-partition router (``data/ingest``) bucket
entities with this function. Keeping a single definition means an event
for user u is always durably ordered in the same WAL partition that the
serving tier consults for u's factors -- the two layers can never drift.

``zlib.crc32`` rather than ``hash()``: Python string hashing is salted
per interpreter (PYTHONHASHSEED), and the router, the shard processes,
and the follower are *different* interpreters -- a salted hash would
route entity e to bucket 1 in one process and bucket 2 in another.
CRC32 is stable across processes, platforms, and releases, which also
keeps on-disk partition layouts portable between writes and any later
replay.

Import-light on purpose: the frontend worker (serving/frontend.py) is a
no-jax, no-numpy interpreter, so only stdlib may be imported here.

Port copy: ``predictionio_tpu/utils/stablehash.py`` (framework-free), verbatim
under the port's package name; ``tests/test_torch_imports.py`` holds
it to the original.
"""

from __future__ import annotations

import zlib

__all__ = ["stable_bucket"]


def stable_bucket(key: object, buckets: int) -> int:
    """The 0-based bucket that owns ``key`` out of ``buckets`` total.

    Scalars are stringified (``str(key)``) before hashing, matching the
    serving tier's ``str(query.get("user"))`` lookups, so a JSON number
    and its string form land in the same bucket.
    """
    if buckets <= 1:
        return 0
    return zlib.crc32(str(key).encode("utf-8")) % buckets
