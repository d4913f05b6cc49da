"""ALS fold-in: solve only new/touched user rows against frozen item factors.

Port of ``fold_in_users`` from ``predictionio_tpu/online/foldin.py``
(reference ``:203``). A user who just rated something gets their row
re-solved against the CURRENT item factors -- one fused gather->Gram
half-step (``ops/als_gram``, the CUDA kernel on the card) over a delta
CSR block, then the same ridge/implicit tail and solve as ``als_fit``.

Correctness contract: a folded user row equals the exact ridge solution
of that user's normal equations against the frozen item factors -- what a
full retrain's final user half-step computes, given the same item
factors. Fold-in re-solves from the user's FULL history, so it is
idempotent over replayed windows.

``fold_in_als_model`` and the ``retrain --follow`` loop read a snapshot
of the event store, which the port does not have yet; they wait for it.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from predictionio_tpu_torch.ops.ragged import pack_padded_csr
from predictionio_tpu_torch.parallel.als import (
    _factors_yty,
    half_step_fn,
    solve_rows,
)
from predictionio_tpu_torch.utils.device import resolve_device


def _pow2_ceil(n: int, floor: int = 8) -> int:
    out = floor
    while out < n:
        out *= 2
    return out


#: (id(host array), device) -> (weakref, device copy + zero row, yty).
#: Tiny by construction: a loop holds a handful of live factor tables.
_DEVICE_FACTOR_CACHE: dict = {}


def _device_factors(item_factors: np.ndarray, device: torch.device):
    """``(table [I + 1, K] f32 with the zero row appended, YtY [K, K])``
    of the frozen item factors on ``device``, cached across fold-ins.
    Between full retrains the item table is REPLACED, never mutated, so
    object identity is a sound cache key; the weakref guards id() reuse
    after garbage collection (reference ``foldin.py:128``)."""
    key = (id(item_factors), str(device))
    hit = _DEVICE_FACTOR_CACHE.get(key)
    if hit is not None and hit[0]() is item_factors:
        return hit[1]
    # prune DEAD entries only: a bulk clear would also evict the live one
    for k in [k for k, (ref, _) in _DEVICE_FACTOR_CACHE.items() if ref() is None]:
        del _DEVICE_FACTOR_CACHE[k]
    table = torch.from_numpy(np.asarray(item_factors, np.float32)).to(device)
    full = torch.cat([table, table.new_zeros((1, table.shape[1]))])
    entry = (full, _factors_yty(table))
    _DEVICE_FACTOR_CACHE[key] = (weakref.ref(item_factors), entry)
    return entry


def fold_in_users(
    item_factors: np.ndarray,
    rows: np.ndarray,
    cols: np.ndarray,
    values: np.ndarray,
    num_rows: int,
    config,
    times: np.ndarray | None = None,
    device=None,
) -> np.ndarray:
    """Solve ``num_rows`` user rows against frozen ``item_factors``.

    ``(rows, cols, values)`` is the touched users' FULL interaction COO in
    local row order (``rows`` in ``[0, num_rows)``) and model item space
    (``cols`` indexing ``item_factors``). Returns ``[num_rows, K]`` f32 --
    the exact ridge/implicit solution per row, via the same half-step tail
    ``als_fit`` runs (``config.solver``: the fused kernel for "auto" and
    "pallas", the unfused products for "xla"). Runs on ``cuda`` unless
    ``device="cpu"``.

    Shapes are padded to a pow2 ladder (rows AND history length), as in
    the reference, so a long-running loop sees a handful of shapes.
    """
    device = resolve_device(device)
    gram_fn = half_step_fn(config.solver)
    if num_rows == 0:
        return np.zeros((0, item_factors.shape[1]), np.float32)
    counts = np.bincount(np.asarray(rows, np.int64), minlength=num_rows)
    longest = int(counts.max()) if counts.size else 1
    if config.max_len:
        longest = min(longest, int(config.max_len))
    csr = pack_padded_csr(
        rows,
        cols,
        np.asarray(values, np.float32),
        num_rows=_pow2_ceil(num_rows),
        num_cols=item_factors.shape[0],
        max_len=config.max_len,
        times=times,
        pad_len=_pow2_ceil(max(longest, 1)),
    )
    table, yty = _device_factors(item_factors, device)
    block = tuple(
        torch.from_numpy(a).to(device)
        for a in (csr.indices, csr.values, csr.mask.sum(axis=1).astype(np.float32))
    )
    out = solve_rows(gram_fn, block, table, yty, config, torch.float32)
    return out[:num_rows].cpu().numpy().astype(np.float32)
