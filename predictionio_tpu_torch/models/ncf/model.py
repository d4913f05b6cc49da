"""NeuMF model and its training loop on one card.

Port of ``predictionio_tpu/models/ncf/model.py``:

- ``NCFConfig``: the same fields and defaults.
- ``NeuMF``: an ``nn.Module`` whose submodules carry the flax tree's
  names (``gmf_user``, ``gmf_item``, ``mlp_user``, ``mlp_item``,
  ``mlp_0`` ... ``mlp_{d-1}``, ``out``), initialized from an explicit
  ``torch.Generator`` with flax's default distributions: embeddings
  N(0, 1/E) (``variance_scaling(1.0, "fan_in", "normal", out_axis=0)``),
  dense kernels ``lecun_normal`` (a normal truncated at two standard
  deviations, scaled so its standard deviation is ``1/sqrt(fan_in)``)
  and zero biases. The values are the port's own, not flax's.
- ``params_from_flax``: the JAX package's params tree (nested dicts of
  arrays) as a ``NeuMF`` state dict. A flax ``Dense`` kernel is
  ``[in, out]``, a ``Linear.weight`` ``[out, in]``.
- ``make_implicit_batches``: the reference's sampled negatives, byte for
  byte, with the collision test vectorized.
- ``train_ncf``: Adam over the reference's epoch permutations and batch
  slicing, a checkpoint of the params and Adam's moments every epoch,
  and resume from the latest one. The model-axis tensor parallelism of
  ``param_shardings`` is not ported: the port trains on one device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from predictionio_tpu_torch.models._flax_init import embed_normal_, f32, lecun_normal_
from predictionio_tpu_torch.utils.device import resolve_device


@dataclass
class NCFConfig:
    num_users: int
    num_items: int
    embed_dim: int = 32
    hidden: tuple = (64, 32)
    learning_rate: float = 0.01
    implicit: bool = False      # BCE over sampled negatives vs MSE on ratings
    negatives: int = 4
    batch_size: int = 4096
    epochs: int = 5
    seed: int = 0


class NeuMF(nn.Module):
    """GMF (elementwise product of user and item embeddings) and an MLP
    tower over their concatenation, fused by one output layer."""

    def __init__(self, config: NCFConfig, generator: torch.Generator | None = None):
        super().__init__()
        c = config
        self.config = c
        self.gmf_user = nn.Embedding(c.num_users, c.embed_dim)
        self.gmf_item = nn.Embedding(c.num_items, c.embed_dim)
        self.mlp_user = nn.Embedding(c.num_users, c.embed_dim)
        self.mlp_item = nn.Embedding(c.num_items, c.embed_dim)
        width = 2 * c.embed_dim
        for i, h in enumerate(c.hidden):
            setattr(self, f"mlp_{i}", nn.Linear(width, h))
            width = h
        self.out = nn.Linear(c.embed_dim + width, 1)
        self.reset_parameters(generator)

    @property
    def depth(self) -> int:
        return len(self.config.hidden)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """flax's default initializers, drawn from ``generator``."""
        for table in (self.gmf_user, self.gmf_item, self.mlp_user, self.mlp_item):
            embed_normal_(table, generator)
        for i in range(self.depth):
            lecun_normal_(getattr(self, f"mlp_{i}"), generator)
        lecun_normal_(self.out, generator)

    def forward(self, user_ids: torch.Tensor, item_ids: torch.Tensor) -> torch.Tensor:
        gmf = self.gmf_user(user_ids) * self.gmf_item(item_ids)
        h = torch.cat([self.mlp_user(user_ids), self.mlp_item(item_ids)], dim=-1)
        for i in range(self.depth):
            h = F.relu(getattr(self, f"mlp_{i}")(h))
        return self.out(torch.cat([gmf, h], dim=-1))[..., 0]


def init_model(config: NCFConfig) -> NeuMF:
    """A ``NeuMF`` initialized on the host from ``config.seed``."""
    return NeuMF(config, torch.Generator().manual_seed(config.seed))


def mlp_depth(state: Mapping[str, object]) -> int:
    """Hidden layers of a ``NeuMF`` state dict (the reference's
    ``_mlp_depth``)."""
    return sum(
        1 for k in state
        if k.startswith("mlp_") and k.endswith(".weight") and k[4:-7].isdigit()
    )


def params_from_flax(tree: Mapping[str, Mapping[str, object]]) -> dict[str, torch.Tensor]:
    """The JAX package's NCF params (``{"gmf_user": {"embedding": ...},
    "mlp_0": {"kernel": [in, out], "bias": [out]}, ...}``, arrays of any
    kind) as a ``NeuMF`` state dict of f32 host tensors."""
    state = {}
    for name, leaves in tree.items():
        if "embedding" in leaves:
            state[f"{name}.weight"] = f32(leaves["embedding"])
        else:
            state[f"{name}.weight"] = f32(leaves["kernel"]).T.contiguous()
            state[f"{name}.bias"] = f32(leaves["bias"])
    return state


def config_from_state(state: Mapping[str, torch.Tensor], **fields) -> NCFConfig:
    """The architecture fields of ``NCFConfig`` read off a state dict."""
    num_users, embed_dim = state["gmf_user.weight"].shape
    hidden = tuple(
        int(state[f"mlp_{i}.weight"].shape[0]) for i in range(mlp_depth(state))
    )
    return NCFConfig(
        num_users=int(num_users), num_items=int(state["gmf_item.weight"].shape[0]),
        embed_dim=int(embed_dim), hidden=hidden, **fields,
    )


def train_ncf(
    config: NCFConfig,
    users: np.ndarray,
    items: np.ndarray,
    labels: np.ndarray,
    device=None,
    checkpoint=None,
    log_every: int = 0,
    init_state: Mapping[str, torch.Tensor] | None = None,
    mesh_shape=None,
    telemetry=None,
):
    """Full training loop on ``device`` (``cuda`` unless ``"cpu"`` is
    named); returns ``(state dict of host f32 tensors, losses)``.

    Kept as the reference has them: ``np.random.default_rng(seed)``
    permutes the examples every epoch, batches of ``batch_size`` are cut
    in that order (the short last batch included), Adam (lr, 0.9, 0.999,
    1e-8) steps on the mean sigmoid cross-entropy (``implicit``) or the
    mean squared error. ``losses`` holds every ``log_every``-th step's
    loss (read once at the end, so logging adds no device sync).

    ``init_state`` (a ``NeuMF`` state dict) replaces the seeded init, so
    a test can start two frameworks from the same weights.
    ``checkpoint`` (a ``workflow.checkpoint.CheckpointManager``) gets the
    params, Adam's moments and step after every epoch; a run finding a
    checkpoint resumes after its epoch. Epoch ``e`` always uses the
    ``e``-th permutation of the seeded generator (a resumed run draws and
    discards the finished epochs' permutations), so a resumed run equals
    an uninterrupted one; the reference's resume reuses the first
    permutations instead.

    ``mesh_shape`` is the engine's ``pio.mesh_shape``: one device, so an
    axis above 1 (the reference's data or model parallelism) raises.

    ``telemetry`` (any object with ``record_epoch(epoch, seconds,
    losses)`` and ``record_phase(name, seconds, rows)``) gets each
    epoch's wall time, the device synced, and every step's loss of the
    epoch, read once at its end; and, as phase ``"permutation"``, the
    host seconds of each epoch's permutation of the ``rows`` examples
    (part of the epoch's time).
    """
    if mesh_shape is not None and any(int(a) > 1 for a in mesh_shape):
        raise NotImplementedError(
            f"pio.mesh_shape {list(mesh_shape)} spreads NCF training over "
            "several devices (data or model axis above 1), which the port "
            "does not do yet (ROADMAP.md slice 20); use [-1, 1]"
        )
    device = resolve_device(device)
    model = init_model(config)
    if init_state is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in init_state.items()})
    model.to(device)
    named = dict(model.named_parameters())
    optimizer = torch.optim.Adam(
        named.values(), lr=config.learning_rate, betas=(0.9, 0.999), eps=1e-8
    )
    n = int(np.asarray(users).size)
    np_rng = np.random.default_rng(config.seed)
    start_epoch = 0
    latest = checkpoint.latest_step() if checkpoint is not None else None
    if latest is not None:
        restored = checkpoint.restore(_state_template(named))
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(torch.from_numpy(restored[f"param.{name}"]))
        # Adam's moments too: zeroed moments after a resume would spike
        # the first updates
        for name, p in named.items():
            optimizer.state[p] = {
                "step": torch.tensor(float(restored["adam_step"])),
                "exp_avg": torch.from_numpy(restored[f"exp_avg.{name}"]).to(device),
                "exp_avg_sq": torch.from_numpy(restored[f"exp_avg_sq.{name}"]).to(device),
            }
        start_epoch = int(restored["epoch"]) + 1
        for _ in range(start_epoch):
            np_rng.permutation(n)

    u_d = torch.as_tensor(np.asarray(users, np.int64), device=device)
    i_d = torch.as_tensor(np.asarray(items, np.int64), device=device)
    y_d = torch.as_tensor(np.asarray(labels, np.float32), device=device)
    step = 0
    logged: list[torch.Tensor] = []
    for epoch in range(start_epoch, config.epochs):
        t0 = time.perf_counter()
        epoch_losses: list[torch.Tensor] = []
        permutation = np_rng.permutation(n)
        if telemetry is not None:
            telemetry.record_phase("permutation", time.perf_counter() - t0, n)
        order = torch.as_tensor(permutation, device=device)
        for start in range(0, n, config.batch_size):
            take = order[start : start + config.batch_size]
            logits = model(u_d[take], i_d[take])
            y = y_d[take]
            if config.implicit:
                loss = F.binary_cross_entropy_with_logits(logits, y)
            else:
                loss = ((logits - y) ** 2).mean()
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            step += 1
            if log_every and step % log_every == 0:
                logged.append(loss.detach())
            if telemetry is not None:
                epoch_losses.append(loss.detach())
        if telemetry is not None:
            read = torch.stack(epoch_losses).tolist() if epoch_losses else []
            telemetry.record_epoch(epoch, time.perf_counter() - t0, read)
        if checkpoint is not None:
            checkpoint.save(epoch, _epoch_state(named, optimizer, epoch))
    if start_epoch < config.epochs and step == 0:
        raise ValueError(
            f"no training steps ran: {n} example(s) cannot fill even one batch"
        )
    losses = torch.stack(logged).tolist() if logged else []
    state = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
    return state, losses


def _state_template(named: Mapping[str, torch.Tensor]) -> dict:
    """The checkpoint's names and shapes (``CheckpointManager.restore``
    checks each array against its template)."""
    template: dict = {"epoch": 0, "adam_step": 0}
    for name, p in named.items():
        for prefix in ("param", "exp_avg", "exp_avg_sq"):
            template[f"{prefix}.{name}"] = np.empty(tuple(p.shape), np.float32)
    return template


def _epoch_state(named, optimizer, epoch: int) -> dict:
    state: dict = {"epoch": epoch}
    for name, p in named.items():
        slot = optimizer.state[p]
        state[f"param.{name}"] = p.detach().cpu().numpy()
        state[f"exp_avg.{name}"] = slot["exp_avg"].cpu().numpy()
        state[f"exp_avg_sq.{name}"] = slot["exp_avg_sq"].cpu().numpy()
    # every parameter steps together, so one count stands for all
    state["adam_step"] = int(optimizer.state[next(iter(named.values()))]["step"])
    return state


def make_implicit_batches(
    users: np.ndarray, items: np.ndarray, num_items: int, negatives: int, rng,
    device=None,
):
    """Positive pairs + sampled negatives -> (users, items, labels).

    The reference's arrays byte for byte from the same ``rng``: the same
    ``rng.integers`` draw, and the same ``keep`` mask (a negative is
    dropped when its pair is a positive). The reference tests each
    sampled pair against a Python set of every positive pair; here a
    binary search of the keys ``u * num_items + i`` over the sorted
    positive keys runs on ``device`` (``cuda`` unless ``"cpu"`` is named;
    on the card it takes milliseconds where the host's search of 80M
    keys takes tens of seconds)."""
    device = resolve_device(device)
    neg_u = np.repeat(users, negatives)
    neg_i = rng.integers(0, num_items, size=neg_u.size)
    pos_keys = np.asarray(users, np.int64) * num_items + np.asarray(items, np.int64)
    keep = np.ones(neg_u.size, bool)
    if pos_keys.size and neg_u.size:
        pos = torch.sort(torch.from_numpy(pos_keys).to(device)).values
        neg = torch.from_numpy(neg_u.astype(np.int64) * num_items + neg_i).to(device)
        at = torch.searchsorted(pos, neg).clamp_(max=pos.numel() - 1)
        keep = (pos[at] != neg).cpu().numpy()
    all_u = np.concatenate([users, neg_u[keep]])
    all_i = np.concatenate([items, neg_i[keep]])
    all_y = np.concatenate([np.ones(users.size), np.zeros(int(keep.sum()))])
    return all_u, all_i, all_y.astype(np.float32)
