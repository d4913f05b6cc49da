"""Carry a trained Universal Recommender model into the port, and persist it.

The JAX package pickles its models; the port loads no pickle. A model
crosses as plain values: the per-event inverted indicators, the item
vocabulary in row order, the per-user, per-event histories and the item
properties -- what the reference's ``URModel`` holds
(``predictionio_tpu/models/universal/engine.py:148``).

On disk a model is a directory of two pickle-free files:

- ``indicators.npz``, loaded with ``allow_pickle=False``: per event type
  ``k`` (the ``k``-th of ``vocab.json``'s ``indicator_events``) the
  inverted index as ``ind{k}_keys`` (history item rows, in the index's
  order), ``ind{k}_offsets`` (their bounds), ``ind{k}_primary`` and
  ``ind{k}_values`` (f64) (each key's (primary item, weight) entries);
  and the histories as one entry per (user, event type) in the map's
  order: ``hist_user`` (into ``history_users``), ``hist_event`` (into
  ``event_names``), ``hist_offsets`` and ``hist_items``;
- ``vocab.json``: ``event_names``, ``item_ids``, ``indicator_events``,
  ``history_users``, ``item_properties``, ``history_mode``, ``app_name``
  and ``channel_name``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from predictionio_tpu_torch.controller.base import open_model_file
from predictionio_tpu_torch.models.similarproduct.convert import (
    ragged_arrays,
    ragged_lists,
)
from predictionio_tpu_torch.models.universal.engine import URModel


def model_from_arrays(
    event_names: list[str],
    item_ids: list[str],
    indicators: dict,
    user_history: dict,
    item_properties: dict,
    history_mode: str = "model",
    app_name: str = "",
    channel_name: str | None = None,
) -> URModel:
    """The port's ``URModel`` from the reference's values: ``indicators``
    maps an event type to its inverted index (history item row ->
    [(primary item row, weight)]), ``user_history`` a user id to
    {event type -> [item rows]}."""
    item_ids = [str(i) for i in item_ids]
    return URModel(
        event_names=list(event_names),
        item_ids=item_ids,
        item_index={iid: j for j, iid in enumerate(item_ids)},
        indicators={
            str(name): {
                int(j): [(int(p), float(v)) for p, v in pairs]
                for j, pairs in inverted.items()
            }
            for name, inverted in indicators.items()
        },
        user_history={
            str(u): {str(n): [int(i) for i in items] for n, items in by_event.items()}
            for u, by_event in user_history.items()
        },
        item_properties=dict(item_properties),
        history_mode=history_mode,
        app_name=app_name,
        channel_name=channel_name,
    )


def save_model(model: URModel, path: str) -> None:
    """Write ``model`` as the directory ``path`` (``indicators.npz`` +
    ``vocab.json``)."""
    os.makedirs(path, exist_ok=True)
    arrays = {}
    indicator_events = list(model.indicators)
    for k, name in enumerate(indicator_events):
        inverted = model.indicators[name]
        keys = list(inverted)
        entries = [inverted[j] for j in keys]
        primary, offsets = ragged_arrays([[p for p, _ in e] for e in entries])
        arrays[f"ind{k}_keys"] = np.asarray(keys, np.int64)
        arrays[f"ind{k}_offsets"] = offsets
        arrays[f"ind{k}_primary"] = primary
        arrays[f"ind{k}_values"] = np.fromiter(
            (v for e in entries for _, v in e), np.float64, count=primary.size)
    users = list(model.user_history)
    event_code = {n: c for c, n in enumerate(model.event_names)}
    hist_user, hist_event, lists = [], [], []
    for row, user in enumerate(users):
        for name, items in model.user_history[user].items():
            hist_user.append(row)
            hist_event.append(event_code[name])
            lists.append(items)
    arrays["hist_items"], arrays["hist_offsets"] = ragged_arrays(lists)
    arrays["hist_user"] = np.asarray(hist_user, np.int64)
    arrays["hist_event"] = np.asarray(hist_event, np.int64)
    np.savez(os.path.join(path, "indicators.npz"), **arrays)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump({
            "event_names": list(model.event_names), "item_ids": list(model.item_ids),
            "indicator_events": indicator_events, "history_users": users,
            "item_properties": model.item_properties,
            "history_mode": model.history_mode, "app_name": model.app_name,
            "channel_name": model.channel_name,
        }, f)


def load_model(path: str) -> URModel:
    """Read a model written by ``save_model``: its directory, or an open
    ``zipfile.ZipFile`` of a model blob."""
    with open_model_file(path, "indicators.npz") as f, np.load(f, allow_pickle=False) as z:
        arrays = {name: z[name] for name in z.files}
    with open_model_file(path, "vocab.json") as f:
        vocab = json.load(f)
    indicators = {}
    for k, name in enumerate(vocab["indicator_events"]):
        primary = ragged_lists(arrays[f"ind{k}_primary"], arrays[f"ind{k}_offsets"])
        values = arrays[f"ind{k}_values"].tolist()
        bounds = arrays[f"ind{k}_offsets"].tolist()
        indicators[name] = {
            j: list(zip(ps, values[bounds[n]:bounds[n + 1]]))
            for n, (j, ps) in enumerate(zip(arrays[f"ind{k}_keys"].tolist(), primary))
        }
    users, names = vocab["history_users"], vocab["event_names"]
    history: dict = {}
    lists = ragged_lists(arrays["hist_items"], arrays["hist_offsets"])
    for row, code, items in zip(arrays["hist_user"].tolist(),
                                arrays["hist_event"].tolist(), lists):
        history.setdefault(users[row], {})[names[code]] = items
    item_ids = vocab["item_ids"]
    # the file's values are already of the model's types: no per-element
    # conversion (``model_from_arrays``) at deploy
    return URModel(
        event_names=vocab["event_names"],
        item_ids=item_ids,
        item_index={iid: j for j, iid in enumerate(item_ids)},
        indicators=indicators,
        user_history=history,
        item_properties=vocab["item_properties"],
        history_mode=vocab["history_mode"],
        app_name=vocab["app_name"],
        channel_name=vocab["channel_name"],
    )
