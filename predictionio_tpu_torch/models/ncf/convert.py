"""Carry a trained NCF model into the port, and persist it.

The JAX package pickles its ``NCFModel``; the port loads no pickle and
none of its classes. Weights cross as the flax params tree of arrays
(``model.params_from_flax``), the vocabularies as id lists in row order
and the seen map as parallel (user row, item row) arrays.

On disk a model is a directory of two pickle-free files:

- ``params.npz``: the ``NeuMF`` state dict under its own names
  (``gmf_user.weight``, ``mlp_0.weight`` ``[out, in]``, ...), plus the
  seen map as ``seen_users`` / ``seen_items`` int64 (20M pairs are
  arrays, not JSON); loaded with ``allow_pickle=False``;
- ``model.json``: ``{"user_ids": [...], "item_ids": [...], "config":
  {NCFConfig fields}}``, and the seen filter's ``seen_mode`` with the
  ``app_name`` and ``event_names`` a live filter reads (absent in older
  directories: ``"model"``).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from predictionio_tpu_torch.controller.base import open_model_file
from predictionio_tpu_torch.models._als_common import build_seen
from predictionio_tpu_torch.models.ncf.engine import NCFModel
from predictionio_tpu_torch.models.ncf.model import (
    NCFConfig,
    config_from_state,
    params_from_flax,
)

_SEEN = ("seen_users", "seen_items")


def model_from_state(
    state: dict[str, torch.Tensor],
    user_ids: list[str],
    item_ids: list[str],
    seen_users: np.ndarray,
    seen_items: np.ndarray,
    config: NCFConfig | None = None,
    seen_mode: str = "model",
    app_name: str = "",
    event_names: list[str] | None = None,
) -> NCFModel:
    """The port's ``NCFModel`` from a ``NeuMF`` state dict: table row
    ``r`` belongs to ``user_ids[r]`` / ``item_ids[r]``, and ``(seen_users[e],
    seen_items[e])`` are interacted (row, row) pairs."""
    state = {k: torch.as_tensor(v, dtype=torch.float32).contiguous() for k, v in state.items()}
    user_ids = [str(u) for u in user_ids]
    item_ids = [str(i) for i in item_ids]
    arch = config_from_state(state)
    if (arch.num_users, arch.num_items) != (len(user_ids), len(item_ids)):
        raise ValueError(
            f"{len(user_ids)} user ids / {len(item_ids)} item ids for tables of "
            f"{arch.num_users} / {arch.num_items} rows"
        )
    seen_users = np.asarray(seen_users, np.int64)
    seen_items = np.asarray(seen_items, np.int64)
    if seen_users.shape != seen_items.shape:
        raise ValueError("seen_users and seen_items must be parallel arrays")
    return NCFModel(
        state=state,
        user_index={uid: j for j, uid in enumerate(user_ids)},
        item_ids=item_ids,
        item_index={iid: j for j, iid in enumerate(item_ids)},
        seen=build_seen(seen_users, seen_items),
        config=config if config is not None else arch,
        seen_mode=seen_mode,
        app_name=app_name,
        event_names=event_names,
    )


def model_from_flax(params, user_ids, item_ids, seen_users, seen_items) -> NCFModel:
    """A model trained by the JAX package (its params tree of arrays)."""
    return model_from_state(params_from_flax(params), user_ids, item_ids,
                            seen_users, seen_items)


def save_model(model: NCFModel, path: str) -> None:
    """Write ``model`` as the directory ``path`` (``params.npz`` +
    ``model.json``)."""
    os.makedirs(path, exist_ok=True)
    user_ids = [None] * len(model.user_index)
    for uid, row in model.user_index.items():
        user_ids[row] = uid
    users = sorted(model.seen)
    seen_users = np.repeat(np.asarray(users, np.int64), [len(model.seen[u]) for u in users])
    seen_items = np.fromiter(
        (i for u in users for i in sorted(model.seen[u])), np.int64, count=seen_users.size
    )
    arrays = {k: v.detach().cpu().numpy() for k, v in model.state.items()}
    np.savez(os.path.join(path, "params.npz"), seen_users=seen_users,
             seen_items=seen_items, **arrays)
    config = dataclasses.asdict(model.config)
    config["hidden"] = list(config["hidden"])
    with open(os.path.join(path, "model.json"), "w") as f:
        json.dump({"user_ids": user_ids, "item_ids": list(model.item_ids),
                   "config": config, "seen_mode": model.seen_mode,
                   "app_name": model.app_name, "event_names": model.event_names}, f)


def load_model(path: str) -> NCFModel:
    """Read a model written by ``save_model``: its directory, or its
    folder in a model blob (``controller.base.BlobFolder``)."""
    with open_model_file(path, "params.npz") as f, np.load(f, allow_pickle=False) as z:
        arrays = {name: z[name] for name in z.files}
    with open_model_file(path, "model.json") as f:
        meta = json.load(f)
    config = dict(meta["config"])
    config["hidden"] = tuple(config["hidden"])
    state = {k: torch.from_numpy(v) for k, v in arrays.items() if k not in _SEEN}
    return model_from_state(state, meta["user_ids"], meta["item_ids"],
                            arrays["seen_users"], arrays["seen_items"],
                            NCFConfig(**config), meta.get("seen_mode", "model"),
                            meta.get("app_name", ""), meta.get("event_names"))
