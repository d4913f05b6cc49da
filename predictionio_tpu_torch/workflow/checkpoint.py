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
