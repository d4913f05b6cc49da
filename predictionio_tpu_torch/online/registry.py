"""Versioned model registry: immutable, CRC-guarded, instantly rollbackable.

The meta-store's EngineInstance rows answer "which TRAINING runs exist";
serving's "latest COMPLETED instance" resolution gives no way to pin,
audit, or roll back the exact bytes a server scores with -- and fold-in
models (``online.foldin``) are not training runs at all. The registry is
the missing layer: every model the continuous-learning loop (or a full
retrain it escalates to) produces is published as a monotonically
versioned, immutable generation:

    <root>/<key16>/
        v-000001/
            manifest.json   # version, source, CRC, engine params, lineage
            model.bin       # the engine.serialize_models blob, verbatim
        v-000002/...

``key16`` hashes the engine variant identity (id, version, variant path),
so two engines sharing a filesystem never cross-serve. The durability
discipline is ``data/snapshot``'s: tmp dir + fsync + atomic rename with a
rename-race retry, CRC32 over the blob checked at every load, GC keeps
the newest N generations (every retained version is a rollback target --
``pio deploy --model-version N`` or ``POST /models/swap {"version": N}``).

The directory layout and the manifest are the reference's, so each
package's ``ModelRegistry`` lists and CRC-checks the other's versions.
The blob inside is the port's pickle-free model zip
(``controller/engine.py::serialize_model``), not the reference's pickle:
a version one package published is not loadable by the other's
templates (the port refuses a pickled blob, the reference cannot
unpickle a zip).

Port copy: ``predictionio_tpu/online/registry.py`` (framework-free), verbatim
under the port's package name; ``tests/test_torch_imports.py`` holds
it to the original.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import json
import logging
import os
import shutil
import time
import zlib

logger = logging.getLogger("pio.online.registry")

#: bump on any incompatible manifest/layout change
REGISTRY_FORMAT_VERSION = 1

_BLOB_NAME = "model.bin"
_MANIFEST_NAME = "manifest.json"


class RegistryError(Exception):
    """A version is missing, torn, or corrupt -- callers surface this
    verbatim (``pio deploy --model-version`` must fail loudly, never fall
    back to a different model than the one the operator named)."""


def variant_key(variant) -> str:
    """Registry key dir for one engine variant identity."""
    material = "\x1f".join(
        (variant.variant_id, variant.engine_version, variant.path)
    )
    return hashlib.sha256(material.encode()).hexdigest()[:16]


def registry_settings(runtime_conf=None, registry_dir: str | None = None) -> str:
    """Resolve the registry root: explicit arg > runtime conf
    (``pio.registry_dir``) > ``PIO_REGISTRY_DIR`` env > the storage base
    dir -- the same resolution ladder as ``snapshot_settings``."""
    conf = runtime_conf or {}
    root = (
        registry_dir
        or conf.get("pio.registry_dir")
        or os.environ.get("PIO_REGISTRY_DIR")
    )
    if not root:
        from predictionio_tpu_torch.data.storage import base_dir

        root = os.path.join(base_dir(), "registry")
    return root


class RegistryVersion:
    """An opened, validated registry generation."""

    def __init__(self, path: str, manifest: dict):
        self.path = path
        self.manifest = manifest

    @property
    def version(self) -> int:
        return int(self.manifest["version"])

    @property
    def source(self) -> str:
        return str(self.manifest.get("source", "unknown"))

    @property
    def instance_id(self) -> str:
        return str(self.manifest.get("instance_id", ""))

    @property
    def engine_params_obj(self) -> dict | None:
        return self.manifest.get("engine_params")

    @property
    def shard_count(self) -> int:
        """Number of per-shard blobs this generation carries (0 = the
        pre-shard layout: only the full ``model.bin``)."""
        shards = self.manifest.get("shards")
        return int(shards["count"]) if shards else 0

    def load_blob(self, shard: int | None = None) -> bytes:
        """The model blob, CRC-verified on every read (a bit-rotted model
        must never silently deploy). ``shard`` selects one per-shard blob
        (``shard-K/model.bin``) from a generation published with a shard
        axis; the full blob stays at ``model.bin`` for single-process
        deploys and byte-identity A/Bs."""
        if shard is None:
            blob_path = os.path.join(self.path, _BLOB_NAME)
            want_crc = self.manifest.get("crc")
        else:
            shards = self.manifest.get("shards")
            if not shards or not (0 <= int(shard) < int(shards["count"])):
                raise RegistryError(
                    f"model version {self.version} has no shard {shard}"
                    f" (shard count: {self.shard_count})"
                )
            blob_path = os.path.join(
                self.path, _shard_dir(int(shard)), _BLOB_NAME
            )
            want_crc = shards["blobs"][int(shard)]["crc"]
        try:
            with open(blob_path, "rb") as f:
                blob = f.read()
        except OSError as exc:
            raise RegistryError(
                f"model version {self.version}: unreadable blob: {exc}"
            )
        if zlib.crc32(blob) != want_crc:
            raise RegistryError(
                f"model version {self.version}: blob CRC mismatch (torn or"
                " corrupt); roll back to another retained version"
            )
        return blob


class ModelRegistry:
    """Publish / resolve / GC model versions for one engine variant."""

    def __init__(self, root: str, key: str, keep: int = 5):
        self.dir = os.path.join(root, key)
        self.keep = max(int(keep), 1)

    @classmethod
    def for_variant(
        cls,
        variant,
        runtime_conf=None,
        registry_dir: str | None = None,
        keep: int = 5,
    ) -> "ModelRegistry":
        return cls(
            registry_settings(runtime_conf or variant.runtime_conf, registry_dir),
            variant_key(variant),
            keep=keep,
        )

    # -- lookup ------------------------------------------------------------
    def _versions(self) -> list[tuple[int, str]]:
        try:
            entries = os.listdir(self.dir)
        except OSError:
            return []
        out = []
        for name in entries:
            if name.startswith("v-"):
                try:
                    out.append((int(name[2:]), os.path.join(self.dir, name)))
                except ValueError:
                    continue
        return sorted(out)

    def versions(self) -> list[RegistryVersion]:
        """Every retained version that validates, oldest first; torn ones
        are skipped (a concurrent publisher may still be committing)."""
        out = []
        for _, path in self._versions():
            try:
                out.append(self._validate(path))
            except RegistryError as exc:
                logger.warning("skipping registry generation %s: %s", path, exc)
        return out

    def latest(self) -> RegistryVersion | None:
        for _, path in reversed(self._versions()):
            try:
                return self._validate(path)
            except RegistryError as exc:
                logger.warning("skipping registry generation %s: %s", path, exc)
        return None

    def get(self, version: int) -> RegistryVersion:
        """Resolve one explicit version; missing/corrupt raise
        :class:`RegistryError` with an operator-actionable message."""
        path = os.path.join(self.dir, f"v-{int(version):06d}")
        if not os.path.isdir(path):
            retained = [n for n, _ in self._versions()]
            raise RegistryError(
                f"model version {int(version)} not found under {self.dir}"
                f" (retained: {retained or 'none'})"
            )
        return self._validate(path)

    def _validate(self, path: str) -> RegistryVersion:
        try:
            with open(os.path.join(path, _MANIFEST_NAME)) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as exc:
            raise RegistryError(f"unreadable manifest in {path}: {exc!r}")
        if manifest.get("format_version") != REGISTRY_FORMAT_VERSION:
            raise RegistryError(
                f"{path}: format_version {manifest.get('format_version')!r}"
                f" != {REGISTRY_FORMAT_VERSION}"
            )
        blob_path = os.path.join(path, _BLOB_NAME)
        try:
            size = os.path.getsize(blob_path)
        except OSError:
            size = -1
        if size != manifest.get("blob_bytes"):
            raise RegistryError(
                f"{path}: blob is {size} bytes, manifest says"
                f" {manifest.get('blob_bytes')} (torn/truncated)"
            )
        shards = manifest.get("shards")
        if shards:
            blobs = shards.get("blobs") or []
            if len(blobs) != int(shards.get("count", -1)):
                raise RegistryError(
                    f"{path}: shard manifest lists {len(blobs)} blobs for"
                    f" count {shards.get('count')}"
                )
            for k, entry in enumerate(blobs):
                shard_path = os.path.join(path, _shard_dir(k), _BLOB_NAME)
                try:
                    shard_size = os.path.getsize(shard_path)
                except OSError:
                    shard_size = -1
                if shard_size != entry.get("bytes"):
                    raise RegistryError(
                        f"{path}: shard {k} blob is {shard_size} bytes,"
                        f" manifest says {entry.get('bytes')}"
                        " (torn/truncated)"
                    )
        return RegistryVersion(path, manifest)

    # -- publish -----------------------------------------------------------
    def publish(
        self,
        blob: bytes,
        meta: dict | None = None,
        shard_blobs: list[bytes] | None = None,
    ) -> RegistryVersion:
        """Commit ``blob`` as the next version. ``meta`` rides the manifest
        (source, instance_id, engine_params, wal_seqno, until_ms, ...) so a
        version is self-contained: deploy needs nothing but the registry.

        ``shard_blobs`` adds the shard axis: blob K lands at
        ``shard-K/model.bin`` with its own CRC in the manifest, while the
        full blob stays at ``model.bin`` -- one generation serves both a
        sharded fabric (each scorer shard loads only its partition) and a
        single-process deploy, which is what makes the byte-identity A/B
        on "the same registry generation" possible. GC is per-generation
        (rmtree), so keep-N is unchanged.
        """
        os.makedirs(self.dir, exist_ok=True)
        tmp = os.path.join(
            self.dir, f".tmp-{os.getpid()}-{time.monotonic_ns()}"
        )
        os.makedirs(tmp)
        try:
            with open(os.path.join(tmp, _BLOB_NAME), "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            shards_manifest = None
            if shard_blobs is not None:
                entries = []
                for k, shard_blob in enumerate(shard_blobs):
                    shard_dir = os.path.join(tmp, _shard_dir(k))
                    os.makedirs(shard_dir)
                    with open(os.path.join(shard_dir, _BLOB_NAME), "wb") as f:
                        f.write(shard_blob)
                        f.flush()
                        os.fsync(f.fileno())
                    _fsync_dir(shard_dir)
                    entries.append(
                        {"bytes": len(shard_blob), "crc": zlib.crc32(shard_blob)}
                    )
                shards_manifest = {"count": len(shard_blobs), "blobs": entries}
            manifest_base = {
                "format_version": REGISTRY_FORMAT_VERSION,
                "created_at": _dt.datetime.now(_dt.timezone.utc).isoformat(),
                "blob_bytes": len(blob),
                "crc": zlib.crc32(blob),
                **({"shards": shards_manifest} if shards_manifest else {}),
                **(meta or {}),
            }
            # claim the next number with an atomic rename; a concurrent
            # publisher losing the race retries with the next one. The
            # manifest (holding the number) is written per attempt.
            for _ in range(100):
                numbers = self._versions()
                number = (numbers[-1][0] + 1) if numbers else 1
                manifest = {**manifest_base, "version": number}
                raw = json.dumps(manifest).encode()
                with open(os.path.join(tmp, _MANIFEST_NAME), "wb") as f:
                    f.write(raw)
                    f.flush()
                    os.fsync(f.fileno())
                _fsync_dir(tmp)
                target = os.path.join(self.dir, f"v-{number:06d}")
                try:
                    os.rename(tmp, target)
                except OSError:
                    continue
                _fsync_dir(self.dir)
                self.gc()
                logger.info(
                    "published model version %d (%s, %d bytes) -> %s",
                    number, manifest.get("source", "?"), len(blob), target,
                )
                return RegistryVersion(target, manifest)
            raise RegistryError(
                f"could not claim a model version under {self.dir}"
            )
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    # -- GC ----------------------------------------------------------------
    def gc(self, tmp_ttl_s: float = 3600.0) -> None:
        """Keep the newest ``self.keep`` versions (each a rollback target),
        reap older ones plus abandoned tmp dirs. Only versions BELOW the
        kept window are touched, so racing publishers cannot collect each
        other's fresh commits."""
        versions = self._versions()
        for number, path in versions[: -self.keep]:
            shutil.rmtree(path, ignore_errors=True)
        now = time.time()
        try:
            entries = os.listdir(self.dir)
        except OSError:
            return
        for name in entries:
            if name.startswith(".tmp-"):
                path = os.path.join(self.dir, name)
                try:
                    if now - os.path.getmtime(path) > tmp_ttl_s:
                        shutil.rmtree(path, ignore_errors=True)
                except OSError:
                    pass


def _shard_dir(shard: int) -> str:
    return f"shard-{int(shard)}"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
