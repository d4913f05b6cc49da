"""Step checkpoints: a long training run resumes instead of restarting.

The port's counterpart of ``predictionio_tpu/workflow/checkpoint.py::
CheckpointManager`` (reference ``:111``), without orbax and without
pickle: each step is one ``step_<N>.npz`` of named arrays (loaded with
``allow_pickle=False``), written to a temporary name, fsynced and
renamed, so a crash mid-write leaves the previous step intact. A small
JSON sidecar (``meta.json``) holds facts checked BEFORE a restore (the
dataset fingerprint). The format is the port's own: it does not read or
write orbax checkpoints of the JAX package.

    ckpt = CheckpointManager(path, fresh=not resume)
    ckpt.save(3, {"users": u, "items": v, "iteration": 3})
    ckpt.latest_step()              # 3
    ckpt.restore({"users": u0, "items": v0, "iteration": 0})

``RunLock`` and ``clear_run_checkpoints`` are copies of the reference's
(``:27-110``, ``:231``): ``pio train`` from the store keys its
checkpoints by run key under ``$PIO_FS_BASEDIR/checkpoints``
(``<algorithm>-<run key>``), holds the run key's lock while it trains,
and clears them once the model blob is recorded.

In a multi-process launch rank 0 alone owns the checkpoints, the run
lock and the blob (``owns_checkpoints``, the reference's
``workflow/context.py:89-97``): ranks on one host share
``$PIO_FS_BASEDIR``, and a second writer on a key would corrupt the
first's steps.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any

import numpy as np

_STEP = re.compile(r"^step_(\d+)\.npz$")
KEEP_STEPS = 3  # newest steps kept on disk; older ones are deleted on save


def owns_checkpoints(runtime_conf=None) -> bool:
    """Whether this process writes step checkpoints: rank 0 of a launch
    (``parallel.distributed.launch_process_id``), or a process on its
    own."""
    from predictionio_tpu_torch.parallel.distributed import launch_process_id

    return launch_process_id(runtime_conf) == 0


def _checkpoint_base(base_dir: str | None = None) -> str:
    return base_dir or os.path.join(
        os.environ.get("PIO_FS_BASEDIR", os.path.expanduser("~/.pio_store")),
        "checkpoints",
    )



class RunLockHeld(RuntimeError):
    """Another live process owns this run's checkpoint namespace."""

    def __init__(self, run_key: str, pid: int):
        super().__init__(
            f"run {run_key!r} is locked by live pid {pid}: another train with"
            " the same variant+params is running. Refusing to start (a fresh"
            " train would delete its live checkpoints; --resume would adopt a"
            " RUNNING instance). Wait for it or kill it first."
        )
        self.pid = pid


class RunLock:
    """``flock``-based lockfile serializing trains that share one run_key.

    ``run_key`` is a pure function of variant+params (core_workflow), so two
    concurrent identical trains would share a checkpoint dir: the second's
    ``fresh`` wipe deletes the first's live checkpoints, and ``--resume``
    would adopt a still-RUNNING instance.

    Why flock and not a pid file: the kernel drops the lock the instant the
    holder dies (no stale-pid liveness polling, which is both racy --
    two waiters can each judge the lock stale and both 'take over' -- and
    wrong across users, where ``kill(pid, 0)`` raises EPERM for a live
    process). The pid written into the file is diagnostic only. Single-host
    by design; multi-host pods isolate via per-host PIO_FS_BASEDIR or run
    one train per coordinator.
    """

    def __init__(self, run_key: str, base_dir: str | None = None):
        base = _checkpoint_base(base_dir)
        os.makedirs(base, exist_ok=True)
        self.run_key = run_key
        self.path = os.path.join(base, f"{run_key}.lock")
        self._fd: int | None = None

    def acquire(self) -> "RunLock":
        import fcntl

        while True:
            fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except BlockingIOError:
                try:
                    pid = int(os.read(fd, 32).decode().strip() or -1)
                except (OSError, ValueError):
                    pid = -1
                os.close(fd)
                raise RunLockHeld(self.run_key, pid) from None
            except BaseException:
                os.close(fd)
                raise
            # release() unlinks the path, so the inode we just locked may
            # already be orphaned (opened before a concurrent release):
            # verify fd and path still agree, else retry on the fresh file
            try:
                if os.fstat(fd).st_ino == os.stat(self.path).st_ino:
                    break
            except FileNotFoundError:
                pass
            os.close(fd)
        os.ftruncate(fd, 0)
        os.write(fd, str(os.getpid()).encode())
        self._fd = fd
        return self

    def release(self) -> None:
        if self._fd is not None:
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass
            os.close(self._fd)  # closing the fd drops the flock
            self._fd = None

    def __enter__(self) -> "RunLock":
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class CheckpointManager:
    """Numbered step checkpoints under one directory, newest
    ``KEEP_STEPS`` kept. ``fresh=True`` (a non-resume train) deletes
    whatever is there first, so stale steps of an earlier run never
    short-circuit a from-scratch retrain."""

    def __init__(self, path: str, fresh: bool = False):
        self.path = os.path.abspath(path)
        if fresh:
            shutil.rmtree(self.path, ignore_errors=True)
        os.makedirs(self.path, exist_ok=True)

    def _steps(self) -> list[int]:
        found = (_STEP.match(name) for name in os.listdir(self.path))
        return sorted(int(m.group(1)) for m in found if m)

    def _step_path(self, step: int) -> str:
        return os.path.join(self.path, f"step_{step:08d}.npz")

    def save(self, step: int, state: dict[str, Any]) -> None:
        """Write ``state`` (name -> array or number) as step ``step``."""
        tmp = self._step_path(step) + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **{k: np.asarray(v) for k, v in state.items()})
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._step_path(step))
        for old in self._steps()[:-KEEP_STEPS]:
            os.remove(self._step_path(old))

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, state_template: dict[str, Any]) -> dict:
        """The arrays of the latest step under the template's names; each
        must have its template's shape. Numbers in the template come back
        as Python numbers."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.path}")
        out = {}
        with np.load(self._step_path(step), allow_pickle=False) as z:
            for name, like in state_template.items():
                value = z[name]
                if np.shape(like) != value.shape:
                    raise ValueError(
                        f"checkpoint {name!r} has shape {value.shape}, "
                        f"expected {np.shape(like)}"
                    )
                out[name] = value.item() if np.ndim(like) == 0 else value
        return out

    @property
    def _meta_path(self) -> str:
        return os.path.join(self.path, "meta.json")

    def write_meta(self, meta: dict) -> None:
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._meta_path)

    def read_meta(self) -> dict | None:
        try:
            with open(self._meta_path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def reset(self) -> None:
        """Discard every step and the meta sidecar (e.g. on a dataset-
        fingerprint mismatch)."""
        shutil.rmtree(self.path, ignore_errors=True)
        os.makedirs(self.path, exist_ok=True)

    def close(self) -> None:
        """Nothing is buffered: every save is on disk when it returns."""


def clear_run_checkpoints(run_key: str, base_dir: str | None = None) -> None:
    """Delete every algorithm's checkpoints for a run key (called after a
    COMPLETED train: the model blob is persisted, step checkpoints are dead
    weight -- and must not be resumable into a later retrain)."""
    import glob

    base = _checkpoint_base(base_dir)
    for path in glob.glob(os.path.join(base, f"*-{run_key}")):
        shutil.rmtree(path, ignore_errors=True)
