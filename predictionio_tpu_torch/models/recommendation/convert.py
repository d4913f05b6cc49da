"""Carry a trained recommendation model into the port, and persist it.

The JAX package pickles its models, and unpickling needs its classes;
the port loads neither. So weights cross as plain arrays: the factor
tables, the id vocabularies in row order, and the seen map as parallel
(user row, item row) arrays -- what ``predictionio_tpu``'s ``als_fit``
and ``build_seen`` inputs already are.

On disk a model is a directory of two pickle-free files:

- ``factors.npz``: ``user_factors`` [U, K] f32, ``item_factors`` [I, K]
  f32, ``seen_users`` / ``seen_items`` int64 (loaded with
  ``allow_pickle=False``);
- ``vocab.json``: ``{"user_ids": [...], "item_ids": [...]}`` in row
  order, and the seen filter's ``seen_mode`` with the ``app_name`` and
  ``event_names`` a live filter reads (absent in older directories:
  ``"model"``), and the ``channel_name`` of a streamed build on a
  non-default channel.
"""

from __future__ import annotations

import json
import os

import numpy as np

from predictionio_tpu_torch.controller.base import open_model_file
from predictionio_tpu_torch.models._als_common import build_seen
from predictionio_tpu_torch.models.recommendation.engine import RecommendationModel
from predictionio_tpu_torch.parallel.als import ALSModel


def model_from_arrays(
    user_factors: np.ndarray,
    item_factors: np.ndarray,
    user_ids: list[str],
    item_ids: list[str],
    seen_users: np.ndarray,
    seen_items: np.ndarray,
    seen_mode: str = "model",
    app_name: str = "",
    event_names: list[str] | None = None,
    channel_name: str | None = None,
) -> RecommendationModel:
    """The port's ``RecommendationModel`` from the reference's arrays:
    factor row ``r`` belongs to ``user_ids[r]`` / ``item_ids[r]``, and
    ``(seen_users[e], seen_items[e])`` are interacted (row, row) pairs
    (none in ``seen_mode="live"``, which reads the ``app_name`` app's
    ``event_names`` events per query instead, on ``channel_name``)."""
    user_factors = np.ascontiguousarray(user_factors, np.float32)
    item_factors = np.ascontiguousarray(item_factors, np.float32)
    user_ids = [str(u) for u in user_ids]
    item_ids = [str(i) for i in item_ids]
    if user_factors.ndim != 2 or item_factors.ndim != 2 or (
        user_factors.shape[1] != item_factors.shape[1]
    ):
        raise ValueError(
            f"factor tables must be [U, K] and [I, K], got "
            f"{user_factors.shape} and {item_factors.shape}"
        )
    if len(user_ids) != user_factors.shape[0] or len(item_ids) != item_factors.shape[0]:
        raise ValueError(
            f"{len(user_ids)} user ids / {len(item_ids)} item ids for factor "
            f"tables of {user_factors.shape[0]} / {item_factors.shape[0]} rows"
        )
    seen_users = np.asarray(seen_users, np.int64)
    seen_items = np.asarray(seen_items, np.int64)
    if seen_users.shape != seen_items.shape:
        raise ValueError("seen_users and seen_items must be parallel arrays")
    return RecommendationModel(
        als=ALSModel(user_factors=user_factors, item_factors=item_factors),
        user_index={uid: idx for idx, uid in enumerate(user_ids)},
        item_ids=item_ids,
        item_index={iid: idx for idx, iid in enumerate(item_ids)},
        seen=build_seen(seen_users, seen_items),
        seen_mode=seen_mode,
        app_name=app_name,
        event_names=event_names,
        channel_name=channel_name,
    )


def seen_arrays(seen: dict[int, set[int]]) -> tuple[np.ndarray, np.ndarray]:
    """A seen map as parallel (user row, item row) int64 arrays, users
    ascending and each user's items ascending (``build_seen``'s input)."""
    users = sorted(seen)
    seen_users = np.repeat(
        np.asarray(users, np.int64), [len(seen[u]) for u in users]
    )
    seen_items = np.fromiter(
        (i for u in users for i in sorted(seen[u])),
        np.int64, count=seen_users.size,
    )
    return seen_users, seen_items


def save_model(model: RecommendationModel, path: str) -> None:
    """Write ``model`` as the directory ``path`` (``factors.npz`` +
    ``vocab.json``)."""
    os.makedirs(path, exist_ok=True)
    user_ids = [None] * len(model.user_index)
    for uid, row in model.user_index.items():
        user_ids[row] = uid
    seen_users, seen_items = seen_arrays(model.seen)
    np.savez(
        os.path.join(path, "factors.npz"),
        user_factors=model.als.user_factors,
        item_factors=model.als.item_factors,
        seen_users=seen_users,
        seen_items=seen_items,
    )
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump({"user_ids": user_ids, "item_ids": list(model.item_ids),
                   "seen_mode": model.seen_mode, "app_name": model.app_name,
                   "event_names": model.event_names,
                   "channel_name": model.channel_name}, f)


def load_model(path: str) -> RecommendationModel:
    """Read a model written by ``save_model``: its directory, or an open
    ``zipfile.ZipFile`` of a model blob."""
    with open_model_file(path, "factors.npz") as f, np.load(f, allow_pickle=False) as z:
        arrays = {name: z[name] for name in z.files}
    with open_model_file(path, "vocab.json") as f:
        vocab = json.load(f)
    return model_from_arrays(
        arrays["user_factors"], arrays["item_factors"],
        vocab["user_ids"], vocab["item_ids"],
        arrays["seen_users"], arrays["seen_items"],
        vocab.get("seen_mode", "model"), vocab.get("app_name", ""),
        vocab.get("event_names"), vocab.get("channel_name"),
    )
