"""The traced stretch of a run: a ``torch.profiler`` session stepped by the
cell's own step boundaries, and the reading of its Chrome trace.

The session records only a short steady stretch (``skip`` steps, then
``warmup``, then ``active`` recorded steps), so the trace a run writes
grows with the stretch and not with the run. It records the host's operations and
ranges beside the card's (the profiler's CPU activity, which costs the
host some microseconds an operation). The stretch's device operations
are those launched between the first recorded step's start and the last
one's end; the traced window runs from the first of them to start on the
card to the last to end, so work the host queued before the stretch, or
the card finishes after it, is neither counted nor idle.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
STEP_PREFIX = "ProfilerStep#"
#: entries of each list of the result line's ``breakdown``
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 100


class Tracer:
    """A profiler session over the run's window; ``step()`` marks the end
    of one of the cell's steps (a training step)."""

    def __init__(self, skip: int, warmup: int, active: int):
        self.skip, self.warmup, self.active = skip, warmup, active
        self.directory = tempfile.mkdtemp(prefix="pio-bench-trace-")
        self.path = os.path.join(self.directory, "trace.json")
        self.prof = None
        self.written = False

    @staticmethod
    def start_cupti() -> None:
        """One throwaway session, so CUPTI starts up in set-up and not
        inside the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def __enter__(self) -> "Tracer":
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(
            activities=activities,
            schedule=schedule(wait=self.skip, warmup=self.warmup, active=self.active,
                              repeat=1),
            on_trace_ready=self._ready)
        self.prof.__enter__()
        return self

    def _ready(self, prof) -> None:
        prof.export_chrome_trace(self.path)
        self.written = True

    def step(self) -> None:
        if self.prof is not None:
            self.prof.step()

    def __exit__(self, *exc) -> None:
        prof, self.prof = self.prof, None
        if prof is not None:
            prof.__exit__(*exc)

    def first_step(self) -> int:
        """1-based index of the first recorded step."""
        return self.skip + self.warmup + 1

    def read(self) -> "Trace | None":
        """The parsed trace (None when the window ended before the
        stretch did), the file removed."""
        if not self.written:
            return None
        try:
            return Trace.load(self.path)
        finally:
            os.remove(self.path)
            os.rmdir(self.directory)


def merged(intervals) -> list[list[float]]:
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


@dataclass
class Op:
    name: str
    start: float   # microseconds
    end: float
    launch: float | None = None  # host time of the launch, for device ops


@dataclass
class Trace:
    """A Chrome trace's recorded steps, device operations (with their
    launch times) and host events. Times in microseconds."""

    steps: list[tuple[float, float]]
    device: list[Op]
    host: list[Op]
    _host_arrays: tuple | None = field(default=None, repr=False, compare=False)

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        return cls.from_events(events)

    @classmethod
    def from_events(cls, events: list[dict]) -> "Trace":
        launches = {e["args"]["correlation"]: e["ts"] for e in events
                    if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        steps, device, host = [], [], []
        for e in events:
            name, cat = e.get("name", ""), e.get("cat")
            start, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
            if name.startswith(STEP_PREFIX):
                # the host's step; the card's copy of the range is not a step
                if cat != "gpu_user_annotation":
                    steps.append((start, end))
            elif cat in DEVICE_CATS:
                corr = e.get("args", {}).get("correlation")
                device.append(Op(name, start, end, launches.get(corr)))
            elif cat in HOST_CATS:
                host.append(Op(name, start, end))
        return cls(sorted(steps), device, host)

    # -- the stretch ------------------------------------------------------

    def stretch_ops(self) -> list[Op]:
        """Device operations launched inside the recorded steps."""
        if not self.steps:
            return []
        lo, hi = self.steps[0][0], self.steps[-1][1]
        return [op for op in self.device if op.launch is not None and lo <= op.launch <= hi]

    def window(self) -> tuple[float, float] | None:
        ops = self.stretch_ops()
        if not ops:
            return None
        return min(op.start for op in ops), max(op.end for op in ops)

    def window_s(self) -> float | None:
        w = self.window()
        return None if w is None else (w[1] - w[0]) / 1e6

    def busy(self) -> list[list[float]]:
        return merged((op.start, op.end) for op in self.stretch_ops())

    def busy_s(self) -> float | None:
        if self.window() is None:
            return None
        return sum(e - s for s, e in self.busy()) / 1e6

    def idle_share(self) -> float | None:
        window, busy = self.window_s(), self.busy_s()
        if not window or busy is None:
            return None
        return 1.0 - busy / window

    def recorded_steps(self) -> int:
        return len(self.steps)

    def kernels(self, *fragments: str) -> list[Op]:
        """The stretch's device operations whose name holds a fragment."""
        return [op for op in self.stretch_ops() if any(f in op.name for f in fragments)]

    def seconds(self, ops) -> float:
        return sum(op.end - op.start for op in ops) / 1e6

    # -- the breakdown ----------------------------------------------------

    def gaps(self) -> list[tuple[float, float]]:
        w = self.window()
        if w is None:
            return []
        edges = [w[0]] + [x for s, e in self.busy() for x in (s, e)] + [w[1]]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def host_label(self, start: float, end: float) -> str:
        """What the host was doing over an idle gap: of the host events
        that cover at least half of it, the innermost (the shortest);
        ``host: between ops`` where none does (Python between calls)."""
        if self._host_arrays is None:
            self._host_arrays = (np.array([op.start for op in self.host]),
                                 np.array([op.end for op in self.host]))
        starts, ends = self._host_arrays
        half = (end - start) / 2
        overlap = np.minimum(ends, end) - np.maximum(starts, start)
        covering = np.flatnonzero(overlap >= half)
        if covering.size == 0:
            return "host: between ops"
        inner = covering[np.argmin((ends - starts)[covering])]
        return self.host[inner].name[:NAME_CHARS]

    def breakdown(self) -> dict:
        """The stretch's device operations by name and its idle gaps by
        what the host was doing, each summed and the largest first, in
        seconds."""
        ops: dict[str, float] = {}
        for op in self.stretch_ops():
            key = op.name[:NAME_CHARS]
            ops[key] = ops.get(key, 0.0) + (op.end - op.start) / 1e6
        idle: dict[str, float] = {}
        for s, e in self.gaps():
            key = self.host_label(s, e)
            idle[key] = idle.get(key, 0.0) + (e - s) / 1e6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                         [:BREAKDOWN_ENTRIES]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}
