"""The numbers that decide ``correct``, each beside its limit.

A number is a gap between what the timed path produced and the plain
reference's answer (``configs/<config>.reference.py``), scaled so that
one limit holds across rows and leaves of different sizes. A NaN or an
infinite gap fails.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def _f64(x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.detach().to(torch.float64)


def relative_gap(got: float, want: float) -> float:
    value = abs(got - want) / max(abs(want), 1e-30)
    return value if math.isfinite(value) else math.inf


def leaf_norm_gaps(got: dict, want: dict, leaves=None) -> dict:
    """Each leaf's ``| |got| - |want| | / max(|want|, median_leaf |want|)``:
    the gap between the two norms (not the norm of their difference), over
    ``leaves`` (default every leaf of ``want``); a missing leaf reads inf."""
    names = list(want) if leaves is None else list(leaves)
    want_n = {n: float(_f64(want[n]).norm()) for n in names}
    floor = float(np.median(list(want_n.values()))) if names else 0.0
    gaps = {}
    for n in names:
        gap = (abs(float(_f64(got[n]).norm()) - want_n[n]) / max(want_n[n], floor, 1e-30)
               if n in got else math.inf)
        gaps[n] = gap if math.isfinite(gap) else math.inf
    return gaps


def exact_gap(got: dict, want: dict) -> float:
    """The largest absolute difference over every entry of every leaf."""
    if set(got) != set(want):
        return math.inf
    worst = 0.0
    for n in want:
        a, b = _f64(got[n]).cpu(), _f64(want[n]).cpu()
        if a.shape != b.shape:
            return math.inf
        if a.numel():
            worst = max(worst, float((a - b).abs().max()))
    return worst if math.isfinite(worst) else math.inf
