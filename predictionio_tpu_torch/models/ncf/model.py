"""NeuMF model and its training loop on the card or a mesh of ranks.

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
- ``param_shardings``: the reference's tensor-parallel rule on a state
  dict: an embedding table, or a dense weight, whose flax trailing dim
  (the embedding dim; a kernel's ``out``, a ``Linear.weight``'s rows)
  divides the ``model`` axis is sharded on it, everything else is
  replicated. ``shard_state`` / ``unshard_state`` cut a full state dict
  into a rank's shards and gather them back.
- ``train_ncf``: Adam over the reference's epoch permutations and batch
  slicing, a checkpoint of the params and Adam's moments every epoch,
  and resume from the latest one; on a mesh of several ranks the batch
  shards over ``data`` and the params (and Adam's moments) over
  ``model`` (``_MeshTrainer``).
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
from predictionio_tpu_torch.parallel import mesh as mesh_lib
from predictionio_tpu_torch.utils.device import resolve_device

#: the embedding tables of a ``NeuMF`` (every other 2-D weight is a dense layer's)
EMBEDDINGS = ("gmf_user", "gmf_item", "mlp_user", "mlp_item")


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


def param_shardings(mesh, state: Mapping[str, torch.Tensor]) -> dict[str, int | None]:
    """The reference's ``param_shardings`` on a ``NeuMF`` state dict: per
    name, the dim sharded over the mesh's ``model`` axis, or None
    (replicated). An embedding table ``[vocab, E]`` shards its embedding
    dim (``P(None, "model")``); a dense layer's ``Linear.weight`` ``[out,
    in]`` is flax's kernel ``[in, out]`` transposed, so its shard is rows of
    ``out``. A tensor that is not 2-D, or whose trailing flax dim does not
    divide over the axis (the ``[*, 1]`` output head), is replicated."""
    model_size = mesh.axis_size("model") if mesh is not None else 1
    out = {}
    for name, t in state.items():
        dim = 1 if name.split(".")[0] in EMBEDDINGS else 0  # flax's trailing dim
        shardable = t.dim() == 2 and model_size > 1 and t.shape[dim] % model_size == 0
        out[name] = dim if shardable else None
    return out


def shard_state(state: Mapping[str, torch.Tensor], mesh) -> dict[str, torch.Tensor]:
    """This rank's shards of a full ``NeuMF`` state dict (host tensors),
    as ``param_shardings`` lays them over the mesh's ``model`` axis."""
    layout = param_shardings(mesh, state)
    m, i = mesh.axis_size("model"), mesh.axis_index("model")
    local = {}
    for name, t in state.items():
        t = torch.as_tensor(t)
        dim = layout[name]
        if dim is not None:
            per = t.shape[dim] // m
            t = t.narrow(dim, i * per, per)
        local[name] = t.contiguous().clone()
    return local


def unshard_state(local: Mapping[str, torch.Tensor], mesh,
                  layout: Mapping[str, int | None]) -> dict[str, torch.Tensor]:
    """The full state dict of every rank's shards (``layout``, the full
    state's ``param_shardings``): one all-gather over ``model`` per sharded
    tensor, which every rank of the axis joins."""
    return {name: mesh_lib.all_gather(mesh, "model", t.detach(), layout[name])
            if layout[name] is not None else t.detach() for name, t in local.items()}


class _MeshTrainer:
    """One rank's share of the reference's sharded NCF step: the params
    and Adam's moments it holds (``shard_state``), its forward over them,
    the gradient reduction and the step.

    The forward computes the reference's function: an embedding table
    sharded over ``model`` is looked up on the local columns and the
    ``[B, E/m]`` rows all-gathered into ``[B, E]``; a sharded dense
    weight is all-gathered whole (``parallel.mesh.gather_shards``, whose
    backward reduce-scatters the gradient). A rank's loss is its data
    shard's summed loss over the whole batch's examples and over the
    ranks that hold the same data shard, so the ranks' losses sum to the
    reference's mean: the reduce-scatters over ``model``, then one
    all-reduce over ``data`` for the sharded params' gradients and one
    over every axis for the replicated params' (with the loss), give
    each rank the gradient of its shards."""

    def __init__(self, config: NCFConfig, full_state: Mapping[str, torch.Tensor], mesh):
        self.config, self.mesh = config, mesh
        self.layout = param_shardings(mesh, full_state)
        self.params = {name: t.to(mesh.device).requires_grad_()
                       for name, t in shard_state(full_state, mesh).items()}
        self.optimizer = torch.optim.Adam(
            self.params.values(), lr=config.learning_rate, betas=(0.9, 0.999), eps=1e-8
        )
        self.sharded = [p for n, p in self.params.items() if self.layout[n] is not None]
        self.replicated = [p for n, p in self.params.items() if self.layout[n] is None]
        self.replicas = mesh.size // mesh.axis_size("data")

    def _table(self, name: str, ids: torch.Tensor) -> torch.Tensor:
        rows = F.embedding(ids, self.params[f"{name}.weight"])
        if self.layout[f"{name}.weight"] is None:
            return rows
        return mesh_lib.gather_shards(self.mesh, "model", rows, dim=-1)

    def _dense(self, name: str, h: torch.Tensor) -> torch.Tensor:
        w = self.params[f"{name}.weight"]
        if self.layout[f"{name}.weight"] is not None:
            w = mesh_lib.gather_shards(self.mesh, "model", w, dim=0)
        return F.linear(h, w, self.params[f"{name}.bias"])

    def forward(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        gmf = self._table("gmf_user", users) * self._table("gmf_item", items)
        h = torch.cat([self._table("mlp_user", users), self._table("mlp_item", items)], dim=-1)
        for i in range(len(self.config.hidden)):
            h = F.relu(self._dense(f"mlp_{i}", h))
        return self._dense("out", torch.cat([gmf, h], dim=-1))[..., 0]

    def step(self, users, items, labels, batch_examples: int) -> torch.Tensor:
        """One Adam step on this rank's data shard of a batch of
        ``batch_examples``; returns the batch's loss (every rank's sum)."""
        logits = self.forward(users, items)
        if self.config.implicit:
            total = F.binary_cross_entropy_with_logits(logits, labels, reduction="sum")
        else:
            total = ((logits - labels) ** 2).sum()
        loss = total / (batch_examples * self.replicas)
        self.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        mesh = self.mesh
        if self.sharded:
            other = tuple(a for a in mesh.axis_names if a != "model")
            mesh_lib.all_reduce_grads(mesh, other, self.sharded)
        total = mesh_lib.all_reduce_grads(mesh, mesh.axis_names, self.replicated,
                                          loss.detach())[0]
        self.optimizer.step()
        return total

    def full_state(self) -> dict[str, torch.Tensor]:
        """The full params on every rank (host tensors; all-gathers)."""
        full = unshard_state(self.params, self.mesh, self.layout)
        return {n: t.to("cpu", copy=True) for n, t in full.items()}

    def epoch_state(self, epoch: int) -> dict:
        """The checkpoint of ``_epoch_state``'s names at full shapes: every
        rank joins the gathers."""
        state: dict = {"epoch": epoch}
        for name, t in self.full_state().items():
            state[f"param.{name}"] = t.numpy()
        for slot in ("exp_avg", "exp_avg_sq"):
            local = {n: self.optimizer.state[p][slot] if p in self.optimizer.state
                     else torch.zeros_like(p) for n, p in self.params.items()}
            for name, t in unshard_state(local, self.mesh, self.layout).items():
                state[f"{slot}.{name}"] = t.cpu().numpy()
        first = next(iter(self.params.values()))
        state["adam_step"] = (int(self.optimizer.state[first]["step"])
                              if first in self.optimizer.state else 0)
        return state

    def restore(self, restored: Mapping) -> None:
        """Take this rank's shards of a full checkpoint (every rank holds it)."""
        params = shard_state({n: torch.from_numpy(restored[f"param.{n}"]) for n in self.params},
                             self.mesh)
        moments = {slot: shard_state({n: torch.from_numpy(restored[f"{slot}.{n}"])
                                      for n in self.params}, self.mesh)
                   for slot in ("exp_avg", "exp_avg_sq")}
        with torch.no_grad():
            for name, p in self.params.items():
                p.copy_(params[name])
                self.optimizer.state[p] = {
                    "step": torch.tensor(float(restored["adam_step"])),
                    "exp_avg": moments["exp_avg"][name].to(p.device),
                    "exp_avg_sq": moments["exp_avg_sq"][name].to(p.device),
                }


def _agree_on_checkpoints(mesh, checkpoint, template: dict):
    """``(any rank checkpoints, the restored full state or None)``, the
    same on every rank: only rank 0 holds a manager, so the ranks agree
    (an all-reduce) whether any does, and a resume broadcasts rank 0's
    checkpoint, array by array, to ranks that pass ``template``'s shapes."""
    any_checkpoint = mesh_lib.all_reduce_max(mesh, int(checkpoint is not None)) > 0
    latest = checkpoint.latest_step() if checkpoint is not None else None
    latest = mesh_lib.broadcast_int(mesh, -1 if latest is None else latest)
    if latest < 0:
        return any_checkpoint, None
    restored = checkpoint.restore(template) if mesh.rank == 0 else template
    out = {}
    for key, value in template.items():
        if isinstance(value, np.ndarray):
            got = mesh_lib.broadcast_rows(mesh, torch.from_numpy(np.ascontiguousarray(
                restored[key], np.float32)))
            out[key] = got.numpy()
        else:
            out[key] = mesh_lib.broadcast_int(mesh, int(restored[key]))
    return any_checkpoint, out


def train_ncf(
    config: NCFConfig,
    users: np.ndarray,
    items: np.ndarray,
    labels: np.ndarray,
    device=None,
    checkpoint=None,
    log_every: int = 0,
    init_state: Mapping[str, torch.Tensor] | None = None,
    mesh=None,
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

    ``mesh`` (``parallel.mesh.Mesh``, the engine's ``ctx.mesh``): with
    more than one rank, training runs on ``mesh.device`` as the
    reference's on its mesh: every rank initializes the same weights and
    draws the same permutations; a batch smaller than the ``data`` axis
    is skipped, a larger one cut to a multiple of it, and this rank
    steps on rows ``[i B/d, (i + 1) B/d)`` for its ``data`` position
    ``i`` over its ``model`` shards (``_MeshTrainer``). Only rank 0 holds
    a ``checkpoint``: the ranks agree whether any does, every rank then
    joins the per-epoch gathers (rank 0 writes), and a resume broadcasts
    rank 0's epoch and state. Every rank returns the full params. None or
    a 1 x 1 mesh is the one-device loop.

    ``telemetry`` (any object with ``record_epoch(epoch, seconds,
    losses)`` and ``record_phase(name, seconds, rows)``) gets each
    epoch's wall time, the device synced, and every step's loss of the
    epoch, read once at its end; and, as phase ``"permutation"``, the
    host seconds of each epoch's permutation of the ``rows`` examples
    (part of the epoch's time).
    """
    sharded = mesh is not None and mesh.size > 1
    device = mesh.device if sharded else resolve_device(device)
    model = init_model(config)
    if init_state is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in init_state.items()})
    n = int(np.asarray(users).size)
    np_rng = np.random.default_rng(config.seed)
    start_epoch = 0
    dp = mesh.axis_size("data") if sharded else 1
    if sharded:
        trainer = _MeshTrainer(config, model.state_dict(), mesh)
        named = trainer.params
        any_checkpoint, restored = _agree_on_checkpoints(
            mesh, checkpoint, _state_template(dict(model.named_parameters())))
    else:
        model.to(device)
        named = dict(model.named_parameters())
        optimizer = torch.optim.Adam(
            named.values(), lr=config.learning_rate, betas=(0.9, 0.999), eps=1e-8
        )
        any_checkpoint = checkpoint is not None
        latest = checkpoint.latest_step() if checkpoint is not None else None
        restored = None if latest is None else checkpoint.restore(_state_template(named))
    if restored is not None:
        if sharded:
            trainer.restore(restored)
        else:
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
            if sharded:
                per = take.numel() // dp
                if not per:
                    continue
                rows = take[mesh.axis_index("data") * per:(mesh.axis_index("data") + 1) * per]
                loss = trainer.step(u_d[rows], i_d[rows], y_d[rows], per * dp)
            else:
                logits = model(u_d[take], i_d[take])
                y = y_d[take]
                if config.implicit:
                    loss = F.binary_cross_entropy_with_logits(logits, y)
                else:
                    loss = ((logits - y) ** 2).mean()
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                optimizer.step()
                loss = loss.detach()
            step += 1
            if log_every and step % log_every == 0:
                logged.append(loss)
            if telemetry is not None:
                epoch_losses.append(loss)
        if telemetry is not None:
            read = torch.stack(epoch_losses).tolist() if epoch_losses else []
            telemetry.record_epoch(epoch, time.perf_counter() - t0, read)
        if any_checkpoint:
            # on a mesh the gathers are collectives every rank joins
            state = (trainer.epoch_state(epoch) if sharded
                     else _epoch_state(named, optimizer, epoch))
            if checkpoint is not None:
                checkpoint.save(epoch, state)
    if start_epoch < config.epochs:
        if sharded:
            mesh_lib.check_steps_ran(step, n, dp, "example")
        elif step == 0:
            raise ValueError(
                f"no training steps ran: {n} example(s) cannot fill even one batch"
            )
    losses = torch.stack(logged).tolist() if logged else []
    if sharded:
        return trainer.full_state(), losses
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
