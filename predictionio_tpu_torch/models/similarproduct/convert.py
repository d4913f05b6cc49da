"""Carry a trained similar-product model into the port, and persist it.

The JAX package pickles its models; the port loads no pickle. A model
crosses as plain arrays: the per-item indicator tables, the item
vocabulary in row order and the user histories -- what the reference's
``SimilarityModel`` holds (``predictionio_tpu/models/similarproduct/
engine.py:156``).

On disk a model is a directory of two pickle-free files:

- ``indicators.npz``: ``top_indices`` [I, k] int32, ``top_values``
  [I, k] f32, ``history_items`` int64 (every history, concatenated in
  the order of ``vocab.json``'s ``history_users``) and
  ``history_offsets`` int64 (their ``len(history_users) + 1`` bounds),
  loaded with ``allow_pickle=False``;
- ``vocab.json``: ``item_ids``, ``history_users``, ``history_mode``,
  ``app_name``, ``channel_name`` and ``event_names``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from predictionio_tpu_torch.controller.base import open_model_file
from predictionio_tpu_torch.models.similarproduct.engine import SimilarityModel


def ragged_arrays(lists: list) -> tuple[np.ndarray, np.ndarray]:
    """Lists of ints as (concatenated int64 values, int64 bounds)."""
    offsets = np.zeros(len(lists) + 1, np.int64)
    np.cumsum([len(x) for x in lists], out=offsets[1:])
    values = np.fromiter((v for x in lists for v in x), np.int64, count=int(offsets[-1]))
    return values, offsets


def ragged_lists(values: np.ndarray, offsets: np.ndarray) -> list[list[int]]:
    """``ragged_arrays``' inverse."""
    flat = values.tolist()
    return [flat[a:b] for a, b in zip(offsets[:-1].tolist(), offsets[1:].tolist())]


def model_from_arrays(
    top_indices: np.ndarray,
    top_values: np.ndarray,
    item_ids: list[str],
    user_history: dict,
    history_mode: str = "model",
    app_name: str = "",
    channel_name: str | None = None,
    event_names: list[str] | None = None,
) -> SimilarityModel:
    """The port's ``SimilarityModel`` from the reference's arrays:
    ``top_indices[p]`` / ``top_values[p]`` are item ``item_ids[p]``'s
    indicators, and ``user_history`` maps a user id to item rows."""
    top_indices = np.ascontiguousarray(top_indices, np.int32)
    top_values = np.ascontiguousarray(top_values, np.float32)
    item_ids = [str(i) for i in item_ids]
    if top_indices.shape != top_values.shape or top_indices.ndim != 2 or (
        top_indices.shape[0] != len(item_ids)
    ):
        raise ValueError(
            f"indicator tables must be [items, k] over {len(item_ids)} items, got "
            f"{top_indices.shape} and {top_values.shape}"
        )
    return SimilarityModel(
        item_ids=item_ids,
        item_index={iid: j for j, iid in enumerate(item_ids)},
        top_indices=top_indices,
        top_values=top_values,
        user_history={str(u): [int(i) for i in items] for u, items in user_history.items()},
        history_mode=history_mode,
        app_name=app_name,
        channel_name=channel_name,
        event_names=event_names,
    )


def save_model(model: SimilarityModel, path: str) -> None:
    """Write ``model`` as the directory ``path`` (``indicators.npz`` +
    ``vocab.json``)."""
    os.makedirs(path, exist_ok=True)
    users = list(model.user_history)
    items, offsets = ragged_arrays([model.user_history[u] for u in users])
    np.savez(
        os.path.join(path, "indicators.npz"),
        top_indices=model.top_indices, top_values=model.top_values,
        history_items=items, history_offsets=offsets,
    )
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump({
            "item_ids": list(model.item_ids), "history_users": users,
            "history_mode": model.history_mode, "app_name": model.app_name,
            "channel_name": model.channel_name, "event_names": model.event_names,
        }, f)


def load_model(path: str) -> SimilarityModel:
    """Read a model written by ``save_model``: its directory, or an open
    ``zipfile.ZipFile`` of a model blob."""
    with open_model_file(path, "indicators.npz") as f, np.load(f, allow_pickle=False) as z:
        arrays = {name: z[name] for name in z.files}
    with open_model_file(path, "vocab.json") as f:
        vocab = json.load(f)
    histories = ragged_lists(arrays["history_items"], arrays["history_offsets"])
    item_ids = vocab["item_ids"]
    # the file's own arrays and lists are already of the model's types:
    # no per-element conversion (``model_from_arrays``) at deploy
    return SimilarityModel(
        item_ids=item_ids,
        item_index={iid: j for j, iid in enumerate(item_ids)},
        top_indices=arrays["top_indices"],
        top_values=arrays["top_values"],
        user_history=dict(zip(vocab["history_users"], histories)),
        history_mode=vocab["history_mode"],
        app_name=vocab["app_name"],
        channel_name=vocab["channel_name"],
        event_names=vocab["event_names"],
    )
