"""Carry a trained SASRec model into the port, and persist it.

The JAX package pickles its ``SASRecModel``; the port loads no pickle and
none of its classes. Weights cross as the flax params tree of arrays
(``model.params_from_flax``), the vocabulary as an id list in row order
and the histories as a dict of shifted (+1) id arrays.

On disk a model is a directory of two pickle-free files:

- ``params.npz``: the ``SASRec`` state dict under its own names
  (``item_embed.weight``, ``att_0.qkv.weight`` ``[out, in]``, ...), plus
  every history as one concatenated ``history_items`` int32 array cut by
  ``history_offsets`` int64 ``[users + 1]`` (20M events are arrays, not
  JSON); loaded with ``allow_pickle=False``;
- ``model.json``: ``{"item_ids": [...], "history_users": [...],
  "config": {SASRecConfig fields}}``, and ``history_mode`` with the
  ``app_name`` and ``event_names`` a live history reads (absent in older
  directories: ``"model"``).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from predictionio_tpu_torch.controller.base import open_model_file
from predictionio_tpu_torch.models.sequence.engine import SASRecModel
from predictionio_tpu_torch.models.sequence.model import SASRecConfig, params_from_flax

_HISTORY = ("history_items", "history_offsets")


def model_from_state(state, config: SASRecConfig, item_ids, histories,
                     history_mode: str = "model", app_name: str = "",
                     event_names: list[str] | None = None) -> SASRecModel:
    """The port's ``SASRecModel`` from a ``SASRec`` state dict: item id
    ``item_ids[j]`` is vocabulary row ``j + 1``, and ``histories`` maps a
    user id to its shifted (+1) item-id sequence (none in
    ``history_mode="live"``, which reads the ``app_name`` app's
    ``event_names`` events per query instead)."""
    state = {k: torch.as_tensor(v, dtype=torch.float32).contiguous() for k, v in state.items()}
    item_ids = [str(i) for i in item_ids]
    rows = state["item_embed.weight"].shape[0]
    if rows != len(item_ids) + 1 or config.num_items != len(item_ids):
        raise ValueError(
            f"{len(item_ids)} item ids, config.num_items={config.num_items}, for an "
            f"item table of {rows} rows (one more than the items: row 0 is padding)"
        )
    return SASRecModel(
        state=state,
        config=config,
        item_ids=item_ids,
        item_index={iid: j for j, iid in enumerate(item_ids)},
        histories={str(u): np.asarray(h) for u, h in histories.items()},
        history_mode=history_mode,
        app_name=app_name,
        event_names=event_names,
    )


def model_from_flax(params, config: SASRecConfig, item_ids, histories) -> SASRecModel:
    """A model trained by the JAX package (its params tree of arrays)."""
    return model_from_state(params_from_flax(params), config, item_ids, histories)


def save_model(model: SASRecModel, path: str) -> None:
    """Write ``model`` as the directory ``path`` (``params.npz`` +
    ``model.json``)."""
    os.makedirs(path, exist_ok=True)
    users = list(model.histories)
    lengths = np.fromiter((len(model.histories[u]) for u in users), np.int64, len(users))
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    items = (np.concatenate([model.histories[u] for u in users]).astype(np.int32)
             if users else np.zeros(0, np.int32))
    arrays = {k: v.detach().cpu().numpy() for k, v in model.state.items()}
    np.savez(os.path.join(path, "params.npz"), history_items=items,
             history_offsets=offsets, **arrays)
    with open(os.path.join(path, "model.json"), "w") as f:
        json.dump({"item_ids": list(model.item_ids), "history_users": users,
                   "config": dataclasses.asdict(model.config),
                   "history_mode": model.history_mode, "app_name": model.app_name,
                   "event_names": model.event_names}, f)


def load_model(path: str) -> SASRecModel:
    """Read a model written by ``save_model``: its directory, or its
    folder in a model blob (``controller.base.BlobFolder``)."""
    with open_model_file(path, "params.npz") as f, np.load(f, allow_pickle=False) as z:
        arrays = {name: z[name] for name in z.files}
    with open_model_file(path, "model.json") as f:
        meta = json.load(f)
    items, offsets = arrays["history_items"], arrays["history_offsets"]
    histories = dict(zip(meta["history_users"], np.split(items, offsets[1:-1])))
    state = {k: torch.from_numpy(v) for k, v in arrays.items() if k not in _HISTORY}
    return model_from_state(state, SASRecConfig(**meta["config"]), meta["item_ids"], histories,
                            meta.get("history_mode", "model"), meta.get("app_name", ""),
                            meta.get("event_names"))
