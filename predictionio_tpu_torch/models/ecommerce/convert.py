"""Carry a trained e-commerce model into the port, and persist it.

The JAX package pickles its models; the port loads no pickle. So a model
crosses as plain arrays: the factor tables, the id vocabularies in row
order, the seen map as parallel (user row, item row) arrays and the
category index as category names with their sorted item rows -- what the
reference's ``ECommerceModel`` holds (``predictionio_tpu/models/
ecommerce/engine.py:295``).

On disk a model is a directory of two pickle-free files:

- ``factors.npz``: ``user_factors`` [U, K] f32, ``item_factors`` [I, K]
  f32, ``seen_users`` / ``seen_items`` int64, ``category_items`` int64
  (every category's item rows, concatenated in the order of
  ``vocab.json``'s ``categories``) and ``category_offsets`` int64 (the
  ``len(categories) + 1`` bounds), loaded with ``allow_pickle=False``;
- ``vocab.json``: ``user_ids``, ``item_ids``, ``categories``,
  ``app_name``, ``similar_events``, ``seen_mode``, ``channel_name`` and
  ``event_names``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from predictionio_tpu_torch.controller.base import open_model_file
from predictionio_tpu_torch.models._als_common import build_seen
from predictionio_tpu_torch.models.ecommerce.engine import ECommerceModel
from predictionio_tpu_torch.models.recommendation.convert import seen_arrays
from predictionio_tpu_torch.parallel.als import ALSModel


def model_from_arrays(
    user_factors: np.ndarray,
    item_factors: np.ndarray,
    user_ids: list[str],
    item_ids: list[str],
    seen_users: np.ndarray,
    seen_items: np.ndarray,
    category_items: dict,
    app_name: str = "",
    similar_events: list[str] | None = None,
    seen_mode: str = "model",
    channel_name: str | None = None,
    event_names: list[str] | None = None,
) -> ECommerceModel:
    """The port's ``ECommerceModel`` from the reference's arrays: factor
    row ``r`` belongs to ``user_ids[r]`` / ``item_ids[r]``,
    ``(seen_users[e], seen_items[e])`` are interacted (row, row) pairs,
    and ``category_items`` maps a category to its item rows."""
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
    return ECommerceModel(
        als=ALSModel(user_factors=user_factors, item_factors=item_factors),
        app_name=app_name,
        user_index={uid: idx for idx, uid in enumerate(user_ids)},
        item_ids=item_ids,
        item_index={iid: idx for idx, iid in enumerate(item_ids)},
        seen=build_seen(seen_users, seen_items),
        category_items={
            str(c): np.asarray(rows, np.int64) for c, rows in category_items.items()
        },
        similar_events=list(similar_events or ["view"]),
        seen_mode=seen_mode,
        channel_name=channel_name,
        event_names=event_names,
    )


def save_model(model: ECommerceModel, path: str) -> None:
    """Write ``model`` as the directory ``path`` (``factors.npz`` +
    ``vocab.json``)."""
    os.makedirs(path, exist_ok=True)
    user_ids = [None] * len(model.user_index)
    for uid, row in model.user_index.items():
        user_ids[row] = uid
    seen_users, seen_items = seen_arrays(model.seen)
    categories = list(model.category_items)
    rows = [np.asarray(model.category_items[c], np.int64) for c in categories]
    offsets = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([r.size for r in rows], out=offsets[1:])
    np.savez(
        os.path.join(path, "factors.npz"),
        user_factors=model.als.user_factors,
        item_factors=model.als.item_factors,
        seen_users=seen_users,
        seen_items=seen_items,
        category_items=np.concatenate(rows) if rows else np.zeros(0, np.int64),
        category_offsets=offsets,
    )
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump({
            "user_ids": user_ids, "item_ids": list(model.item_ids),
            "categories": categories, "app_name": model.app_name,
            "similar_events": list(model.similar_events),
            "seen_mode": model.seen_mode, "channel_name": model.channel_name,
            "event_names": model.event_names,
        }, f)


def load_model(path: str) -> ECommerceModel:
    """Read a model written by ``save_model``: its directory, or its
    folder in a model blob (``controller.base.BlobFolder``)."""
    with open_model_file(path, "factors.npz") as f, np.load(f, allow_pickle=False) as z:
        arrays = {name: z[name] for name in z.files}
    with open_model_file(path, "vocab.json") as f:
        vocab = json.load(f)
    offsets = arrays["category_offsets"]
    return model_from_arrays(
        arrays["user_factors"], arrays["item_factors"],
        vocab["user_ids"], vocab["item_ids"],
        arrays["seen_users"], arrays["seen_items"],
        {c: arrays["category_items"][offsets[k]:offsets[k + 1]]
         for k, c in enumerate(vocab["categories"])},
        vocab["app_name"], vocab["similar_events"], vocab["seen_mode"],
        vocab["channel_name"], vocab["event_names"],
    )
