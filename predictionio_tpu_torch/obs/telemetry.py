"""Per-step training telemetry journal (``pio train --profile``).

Copy of ``predictionio_tpu/obs/telemetry.py`` (framework-free): one JSON
line per training step with wall time, edges/sec and the achieved
device GB/s implied by the bytes-moved model
(``ops.als_gram.half_step_bytes``), after a ``meta`` line. Lines are
flushed as written: a crashed run keeps every completed step's record.

Two departures, both additions or removals of whole functions: the
reference's ``jit_cache_size`` (the recompile counter's source) is left
out, because the port compiles nothing per shape, so its step lines
carry no ``recompile_count``, as the reference's do when that function
returns None; and ``TrainTelemetry`` also takes the port's
``TrainContext.telemetry`` calls of the minibatch trainers,
``record_epoch`` (a ``step`` record per epoch) and ``record_phase`` (a
``phase`` record), and the streamed ALS fit's ``record_stream`` (a
``stream`` record of its host -> device traffic).
"""

from __future__ import annotations

import json
import os
import time


class TrainTelemetry:
    """JSONL step journal. First line is a ``meta`` record (edge count,
    modeled bytes/iter, run shape); each ``record_step`` appends a
    ``step`` record. Single-writer (the training loop)."""

    def __init__(
        self,
        path: str,
        *,
        edges: int | None = None,
        modeled_bytes_per_iter: float | None = None,
        meta: dict | None = None,
    ):
        self.path = path
        self.edges = edges
        self.modeled_bytes_per_iter = modeled_bytes_per_iter
        self.steps = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "w")
        self._write(
            {
                "event": "meta",
                "edges": edges,
                "modeled_bytes_per_iter": modeled_bytes_per_iter,
                **(meta or {}),
            }
        )

    def _write(self, obj: dict) -> None:
        obj["ts"] = round(time.time(), 3)
        self._f.write(json.dumps(obj) + "\n")
        self._f.flush()

    def record_step(
        self,
        step: int,
        wall_s: float,
        *,
        recompile_count: int | None = None,
        extra: dict | None = None,
    ) -> dict:
        """Append one step record; returns the object written."""
        obj: dict = {
            "event": "step",
            "step": int(step),
            "wall_s": round(float(wall_s), 6),
        }
        if self.edges is not None and wall_s > 0:
            obj["edges_per_sec"] = round(self.edges / wall_s, 1)
        if self.modeled_bytes_per_iter is not None and wall_s > 0:
            obj["achieved_gbps"] = round(
                self.modeled_bytes_per_iter / wall_s / 1e9, 3
            )
        if recompile_count is not None:
            obj["recompile_count"] = int(recompile_count)
        if extra:
            obj.update(extra)
        self._write(obj)
        self.steps += 1
        return obj

    def record_epoch(self, epoch: int, wall_s: float, losses) -> dict:
        """One epoch of a minibatch trainer (NCF, SASRec) as a ``step``
        record: the epoch's wall time, its step count and the mean of
        its step losses."""
        losses = [float(x) for x in losses]
        extra = {"unit": "epoch", "steps": len(losses)}
        if losses:
            extra["loss"] = round(sum(losses) / len(losses), 6)
        return self.record_step(epoch, wall_s, extra=extra)

    def record_phase(self, name: str, wall_s: float, rows: int) -> dict:
        """One host phase outside the steps (negative sampling, an
        epoch's permutation): a ``phase`` record with its rows."""
        obj = {
            "event": "phase",
            "phase": str(name),
            "wall_s": round(float(wall_s), 6),
            "rows": int(rows),
        }
        self._write(obj)
        return obj

    def record_stream(self, stats: dict) -> dict:
        """A streamed fit's host -> device traffic
        (``parallel.stream.StreamStats`` as a dict) as a ``stream``
        record, after its step records."""
        obj = {"event": "stream", **stats}
        self._write(obj)
        return obj

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "TrainTelemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
