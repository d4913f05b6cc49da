"""ALS fold-in: solve only new/touched user rows against frozen item factors.

Port of ``predictionio_tpu/online/foldin.py``. A user who just rated
something gets their row re-solved against the CURRENT item factors --
one fused gather->Gram half-step (``ops/als_gram``, the CUDA kernel B1 on
the card) over a delta CSR block, then the same ridge/implicit tail and
solve as ``als_fit`` (``fold_in_users``, reference ``:203``). Untouched
rows keep their factors bit for bit; new users append rows and new items
append zero factors (they score 0 until the next full retrain, which the
staleness budget triggers once item growth makes zero rows matter).

Correctness contract: a folded user row equals the exact ridge solution
of that user's normal equations against the frozen item factors -- what a
full retrain's final user half-step computes, given the same item
factors. Fold-in re-solves from the user's FULL history, so it is
idempotent over replayed windows, which makes the retrain loop's crash
recovery safe.

``fold_in_als_model`` (reference ``:278-445``) is the fold the
``pio retrain --follow`` loop (``online/loop.py``) runs over a refreshed
training snapshot (``data/snapshot.py``): the touched users of the
window, mapped into the model by string id, the budget checked before
any solve, then ONE ``fold_in_users`` call (one B1 launch on ``cuda``).
``StalenessBudget``, ``StalenessExceeded``, ``FoldinDelta`` and
``AlsFoldResult`` are copies of the reference's.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from predictionio_tpu_torch.ops.ragged import pack_padded_csr
from predictionio_tpu_torch.parallel.als import (
    ALSModel,
    _factors_yty,
    half_step_fn,
    solve_rows,
)
from predictionio_tpu_torch.utils.device import resolve_device


class StalenessExceeded(Exception):
    """The delta outgrew the fold-in budget; escalate to a full retrain."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


@dataclass
class StalenessBudget:
    """When incremental fold-in stops being a good approximation.

    - ``max_touched_frac``: once this fraction of known users was touched
      since the last full retrain, the frozen item factors are stale for a
      large share of the matrix -- retrain instead of folding;
    - ``max_item_growth_frac``: new (zero-factor) items as a fraction of
      the known catalog; zero rows never get recommended, so growth here
      is silent quality loss;
    - ``max_user_growth_frac``: same for appended user rows (cheap but
      still an approximation against frozen items).
    """

    max_touched_frac: float = 0.2
    max_item_growth_frac: float = 0.05
    max_user_growth_frac: float = 0.5

    def check(
        self,
        touched_users: int,
        known_users: int,
        new_users: int,
        new_items: int,
        known_items: int,
    ) -> None:
        """Raise :class:`StalenessExceeded` when any threshold trips."""
        users = max(known_users, 1)
        items = max(known_items, 1)
        if touched_users / users > self.max_touched_frac:
            raise StalenessExceeded(
                f"touched-user fraction {touched_users}/{users} exceeds"
                f" {self.max_touched_frac}"
            )
        if new_items / items > self.max_item_growth_frac:
            raise StalenessExceeded(
                f"item-vocab growth {new_items}/{items} exceeds"
                f" {self.max_item_growth_frac}"
            )
        if new_users / users > self.max_user_growth_frac:
            raise StalenessExceeded(
                f"user-vocab growth {new_users}/{users} exceeds"
                f" {self.max_user_growth_frac}"
            )


@dataclass
class FoldinDelta:
    """What the retrain loop hands an algorithm's ``fold_in`` hook.

    ``snapshot`` is the refreshed columnar generation (``data/snapshot``);
    ``window_start_ms`` bounds the NEW rows (``event_time_ms >=``); the
    model must come to reflect everything in the window, and MAY re-reflect
    older rows (fold-in re-solves from full history, so overlap is free).
    ``touched_user_ids`` (entity-id strings, from the WAL tail) widens the
    touched set beyond the window when provided -- e.g. records whose
    client-supplied event time predates the window.
    """

    snapshot: object
    window_start_ms: int
    touched_user_ids: set | None = None
    budget: StalenessBudget = field(default_factory=StalenessBudget)
    #: datasource knobs riding the online handle -- DASE keeps
    #: per-component params separate, so the loop forwards them here
    extras: dict = field(default_factory=dict)
    #: entity types that received ``$set``/``$unset``/``$delete`` records
    #: in this window (from the WAL tail)
    set_entity_types: set | None = None


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


@dataclass
class AlsFoldResult:
    """A folded ALS model core plus the vocab/bookkeeping of the fold."""

    als: ALSModel
    user_index: dict
    item_ids: list
    item_index: dict
    touched_users: int
    new_users: int
    new_items: int
    #: (model user row, model item idx) pairs of the WINDOW rows only --
    #: what a trained-in seen map must absorb
    window_pairs: np.ndarray | None = None
    max_window_ms: int = 0


def fold_in_als_model(
    als: ALSModel,
    user_index: dict,
    item_ids: list,
    item_index: dict,
    delta: FoldinDelta,
    config,
    event_values: dict | None = None,
    rating_default: float = 1.0,
    device=None,
) -> AlsFoldResult | None:
    """The fold the retrain loop runs over a refreshed snapshot.

    Reads the snapshot's columns, finds the users touched inside the
    delta window (unioned with ``delta.touched_user_ids``), maps entities
    by STRING id into the model's spaces (so snapshot rebuilds that
    renumber codes cannot misalign factors), extends vocabularies for new
    users/items, and re-solves the touched rows from their full history
    through ONE ``fold_in_users`` call on ``device`` (``cuda`` unless
    ``"cpu"``). Returns None when the window holds no usable
    interaction. Raises :class:`StalenessExceeded` per ``delta.budget``
    BEFORE any solve.

    ``event_values`` scores each row by its event name; otherwise the
    rating column is used with NaN -> ``rating_default`` (the
    recommendation template's implicit-event convention).
    """
    snap = delta.snapshot
    users_c = np.asarray(snap.column("users"))
    items_c = np.asarray(snap.column("items"))
    names_c = np.asarray(snap.column("names"))
    times = np.asarray(snap.column("times"))
    ratings = np.asarray(snap.column("ratings"))
    uvocab = snap.vocab("users")
    ivocab = snap.vocab("items")
    nvocab = snap.vocab("names")

    valid = items_c >= 0
    times_ms = (times * 1000.0).astype(np.int64)
    window = valid & (times_ms >= delta.window_start_ms)
    touched_codes = np.unique(users_c[window])
    if delta.touched_user_ids:
        # WAL-reported users whose event times predate the window (client
        # timestamps): widen by string id
        code_of = {uid: code for code, uid in enumerate(uvocab)}
        extra = {
            code_of[uid]
            for uid in delta.touched_user_ids
            if uid in code_of
        }
        extra -= set(touched_codes.tolist())
        if extra:
            touched_codes = np.sort(
                np.concatenate([touched_codes, np.fromiter(extra, np.int64)])
            )
    if touched_codes.size == 0:
        return None

    history = valid & np.isin(users_c, touched_codes)
    h_users = users_c[history]
    h_items = items_c[history]
    h_names = names_c[history]
    h_times = times[history]
    h_ratings = ratings[history]

    # -- map entities into MODEL space, extending for new ones -------------
    user_index = dict(user_index)
    item_index = dict(item_index)
    item_ids = list(item_ids)
    known_users = len(user_index)
    known_items = len(item_index)
    local_of_code: dict[int, int] = {}
    model_row_of_local: list[int] = []
    new_users = 0
    for code in touched_codes.tolist():
        uid = uvocab[code]
        row = user_index.get(uid)
        if row is None:
            row = len(user_index)
            user_index[uid] = row
            new_users += 1
        local_of_code[code] = len(model_row_of_local)
        model_row_of_local.append(row)
    item_model_of_code: dict[int, int] = {}
    new_items = 0
    for code in np.unique(h_items).tolist():
        iid = ivocab[code]
        idx = item_index.get(iid)
        if idx is None:
            idx = len(item_index)
            item_index[iid] = idx
            item_ids.append(iid)
            new_items += 1
        item_model_of_code[code] = idx

    delta.budget.check(
        touched_users=int(touched_codes.size),
        known_users=known_users,
        new_users=new_users,
        new_items=new_items,
        known_items=known_items,
    )

    rank = als.item_factors.shape[1]
    item_factors = als.item_factors
    if new_items:
        # a NEW array (never a mutation): the device-table cache keys on
        # object identity
        item_factors = np.vstack(
            [item_factors, np.zeros((new_items, rank), item_factors.dtype)]
        )

    rows_local = np.fromiter(
        (local_of_code[c] for c in h_users.tolist()), np.int64,
        count=h_users.size,
    )
    cols_model = np.fromiter(
        (item_model_of_code[c] for c in h_items.tolist()), np.int64,
        count=h_items.size,
    )
    if event_values is not None:
        by_code = np.asarray(
            [float(event_values.get(n, 1.0)) for n in nvocab], np.float32
        )
        vals = by_code[h_names]
    else:
        vals = np.where(
            np.isnan(h_ratings), rating_default, h_ratings
        ).astype(np.float32)

    solved = fold_in_users(
        item_factors, rows_local, cols_model, vals,
        num_rows=len(model_row_of_local), config=config, times=h_times,
        device=device,
    )
    user_factors = als.user_factors
    if new_users:
        user_factors = np.vstack(
            [user_factors, np.zeros((new_users, rank), user_factors.dtype)]
        )
    else:
        user_factors = user_factors.copy()
    user_factors[np.asarray(model_row_of_local, np.int64)] = solved

    w_users = users_c[window]
    w_items = items_c[window]
    window_pairs = np.stack(
        [
            np.fromiter(
                (user_index[uvocab[c]] for c in w_users.tolist()), np.int64,
                count=w_users.size,
            ),
            np.fromiter(
                (item_index[ivocab[c]] for c in w_items.tolist()), np.int64,
                count=w_items.size,
            ),
        ],
        axis=1,
    ) if w_users.size else None
    return AlsFoldResult(
        als=ALSModel(user_factors=user_factors, item_factors=item_factors),
        user_index=user_index,
        item_ids=item_ids,
        item_index=item_index,
        touched_users=int(touched_codes.size),
        new_users=new_users,
        new_items=new_items,
        window_pairs=window_pairs,
        max_window_ms=int(times_ms[window].max()) if window.any() else 0,
    )
