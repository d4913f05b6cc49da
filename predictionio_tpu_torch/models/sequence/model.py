"""Self-attentive sequential recommender (SASRec-style) on the card or a mesh of ranks.

Port of ``predictionio_tpu/models/sequence/model.py``:

- ``SASRecConfig``: the same fields, defaults and validation.
- ``SASRec``: an ``nn.Module`` whose submodules carry the flax tree's
  names (``item_embed``, ``pos_embed``, ``ln_att_i``, ``att_i.qkv``,
  ``att_i.proj``, ``ln_ffn_i``, ``ffn_in_i``, ``ffn_out_i``, ``ln_out``),
  initialized from a ``torch.Generator`` with flax's default
  distributions (``models/_flax_init``; LayerNorm eps 1e-6 as flax's).
  ``attention``: ``"auto"`` is the flash kernels (``ops/flash_attention``,
  B4 forward, the fused backward) on ``cuda`` and ``plain_attention`` on the
  CPU, as the reference is flash on the TPU and plain elsewhere;
  ``"flash"`` and ``"plain"`` force one. With a mesh whose ``seq`` axis is
  above 1, each rank holds a ``T/s`` block of every sequence and the
  attention runs ``seq_parallel``: ``"ring"`` (``parallel/ring_attention``,
  plain torch as the reference's body) or ``"ulysses"``
  (``parallel/ulysses``: the flash kernels, or ``plain_attention``, at
  ``H/s`` heads over the full sequence); the position embeddings start
  at the block's global offset.
- The tied output head (``logits``) and the scorer are ``torch.matmul``:
  the reference computes them outside Pallas too.
- ``sequence_loss``: the masked next-item cross-entropy of
  ``make_train_step``, the padding id 0 inside the softmax as in optax.
- ``train_sasrec``: Adam (lr, 0.9, 0.999, 1e-8) over the reference's
  ``np.random.default_rng(seed)`` permutations and batch slicing, the
  short last batch kept (the reference keeps it at one data shard). On a
  mesh of several ranks (``parallel.mesh.Mesh``, axes ``data`` and
  ``seq``): each rank takes its ``(data, seq)`` block of every batch (cut
  to a multiple of the data axis), the loss is the masked sum over the
  rank's block divided by the whole batch's target count, and one
  all-reduce over the mesh sums the gradients (and the loss) before a
  replicated Adam step.
- ``params_from_flax``: the JAX package's params tree as a state dict
  (a flax ``Dense`` kernel is ``[in, out]``, a ``Linear.weight``
  ``[out, in]``).
- ``score_next_items_batch`` / ``score_next_items``: the next-item scores
  over the vocabulary for prefixes, from a ``SASRec`` on its device.
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
from predictionio_tpu_torch.ops.flash_attention import flash_attention
from predictionio_tpu_torch.parallel.mesh import all_reduce_grads, check_steps_ran
from predictionio_tpu_torch.parallel.ring_attention import plain_attention, ring_attention
from predictionio_tpu_torch.parallel.ulysses import ulysses_attention
from predictionio_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class SASRecConfig:
    num_items: int              # real item vocab; id 0 is reserved for padding
    max_len: int = 64
    embed_dim: int = 32
    num_heads: int = 2
    num_blocks: int = 2
    ffn_dim: int = 64
    dropout: float = 0.0
    learning_rate: float = 1e-3
    batch_size: int = 256
    epochs: int = 10
    seed: int = 0
    seq_parallel: str = "ring"  # "ring" | "ulysses" (all-to-all head scatter)
    #: intra-shard attention: "auto" = the flash kernels on cuda, the
    #: materialized-score reference elsewhere; "flash" / "plain" force it
    attention: str = "auto"

    def __post_init__(self):
        if self.embed_dim % self.num_heads:
            raise ValueError(
                f"embed_dim={self.embed_dim} must be divisible by "
                f"num_heads={self.num_heads}"
            )
        if self.attention not in ("auto", "flash", "plain"):
            raise ValueError(
                f"attention={self.attention!r} must be one of"
                " 'auto' | 'flash' | 'plain'"
            )
        if self.seq_parallel not in ("ring", "ulysses"):
            raise ValueError(
                f"seq_parallel={self.seq_parallel!r}: want 'ring' or 'ulysses'"
            )

    @property
    def vocab(self) -> int:
        return self.num_items + 1  # +1 for the padding id 0


class _MultiHeadSelfAttention(nn.Module):
    """Causal multi-head self-attention over the key-validity mask: ring
    attention or Ulysses when ``mesh`` has a ``seq`` axis above 1, else
    the flash kernels or ``plain_attention``."""

    def __init__(self, config: SASRecConfig, mesh=None):
        super().__init__()
        self.config = config
        self.mesh = mesh
        d = config.embed_dim
        self.qkv = nn.Linear(d, 3 * d, bias=False)
        self.proj = nn.Linear(d, d, bias=False)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        c = self.config
        b, t, d = x.shape
        # the q, k, v thirds as [B, T, H, D] views of one projection (the
        # flash kernels read them through their strides)
        q, k, v = self.qkv(x).reshape(b, t, 3, c.num_heads, d // c.num_heads).unbind(2)
        use_flash = c.attention == "flash" or (
            c.attention == "auto" and x.device.type == "cuda"
        )
        mesh = self.mesh
        if mesh is not None and mesh.axis_size("seq") > 1:
            if c.seq_parallel == "ulysses":
                # full sequences per rank: the flash kernels are its local attention
                out = ulysses_attention(q, k, v, mesh, axis_name="seq", causal=True,
                                        mask=pad_mask, use_flash=use_flash)
            else:
                # the ring IS the online softmax across blocks (plain torch)
                out = ring_attention(q, k, v, mesh, axis_name="seq", causal=True,
                                     mask=pad_mask)
        elif use_flash:
            out = flash_attention(q, k, v, pad_mask, causal=True)
        else:
            out = plain_attention(q, k, v, causal=True, mask=pad_mask)
        return self.proj(out.reshape(b, t, d))


class SASRec(nn.Module):
    """``mesh``: the training mesh; with a ``seq`` axis above 1 ``forward``
    takes this rank's ``[B, T/s]`` block of the sequences."""

    def __init__(self, config: SASRecConfig, generator: torch.Generator | None = None,
                 mesh=None):
        super().__init__()
        c = self.config = config
        self.mesh = mesh
        e = c.embed_dim
        self.item_embed = nn.Embedding(c.vocab, e)
        self.pos_embed = nn.Embedding(c.max_len, e)
        for i in range(c.num_blocks):
            setattr(self, f"ln_att_{i}", nn.LayerNorm(e, eps=1e-6))
            setattr(self, f"att_{i}", _MultiHeadSelfAttention(c, mesh))
            setattr(self, f"ln_ffn_{i}", nn.LayerNorm(e, eps=1e-6))
            setattr(self, f"ffn_in_{i}", nn.Linear(e, c.ffn_dim))
            setattr(self, f"ffn_out_{i}", nn.Linear(c.ffn_dim, e))
        self.ln_out = nn.LayerNorm(e, eps=1e-6)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """flax's default initializers, drawn from ``generator``
        (LayerNorms keep torch's ones and zeros, which are flax's)."""
        embed_normal_(self.item_embed, generator)
        embed_normal_(self.pos_embed, generator)
        for i in range(self.config.num_blocks):
            att = getattr(self, f"att_{i}")
            for layer in (att.qkv, att.proj, getattr(self, f"ffn_in_{i}"),
                          getattr(self, f"ffn_out_{i}")):
                lecun_normal_(layer, generator)

    def _dropout(self, x: torch.Tensor) -> torch.Tensor:
        rate = self.config.dropout
        return F.dropout(x, rate, training=True) if rate and self.training else x

    def forward(self, seq: torch.Tensor) -> torch.Tensor:
        """seq: [B, T] int, 0 = padding. Returns hidden states [B, T, E]."""
        c = self.config
        pad_mask = seq > 0
        x = self.item_embed(seq) * (c.embed_dim ** 0.5)
        t = seq.shape[1]
        # a seq-sharded block's positions start at its global offset
        start = self.mesh.axis_index("seq") * t if self.mesh is not None else 0
        x = self._dropout(x + self.pos_embed.weight[start:start + t][None])
        for i in range(c.num_blocks):
            a = getattr(self, f"ln_att_{i}")(x)
            x = x + self._dropout(getattr(self, f"att_{i}")(a, pad_mask))
            f = getattr(self, f"ln_ffn_{i}")(x)
            f = getattr(self, f"ffn_out_{i}")(F.relu(getattr(self, f"ffn_in_{i}")(f)))
            x = x + self._dropout(f)
        return self.ln_out(x) * pad_mask[..., None]


def logits(net: SASRec, hidden: torch.Tensor) -> torch.Tensor:
    """Tied-embedding output head: [B, T, E] x [V, E]^T -> [B, T, V]."""
    return hidden @ net.item_embed.weight.T


def sequence_loss(net: SASRec, seq: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean next-item cross-entropy over the positions with a target
    (``target`` 0 = none), the full softmax over the vocabulary, the
    padding id included as in ``optax.softmax_cross_entropy_with_integer_labels``."""
    out = logits(net, net(seq))
    ce = F.cross_entropy(out.reshape(-1, out.shape[-1]), target.reshape(-1),
                         ignore_index=0, reduction="sum")
    return ce / (target > 0).sum().clamp_min(1)


def init_model(config: SASRecConfig, mesh=None) -> SASRec:
    """A ``SASRec`` initialized on the host from ``config.seed`` (the same
    weights on every rank of a mesh)."""
    return SASRec(config, torch.Generator().manual_seed(config.seed), mesh)


def params_from_flax(tree: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    """The JAX package's SASRec params (nested dicts of arrays of any
    kind) as a ``SASRec`` state dict of f32 host tensors: ``embedding``
    -> ``weight``; LayerNorm ``scale``/``bias`` -> ``weight``/``bias``;
    Dense ``kernel`` ``[in, out]`` -> ``weight`` ``[out, in]``."""
    state = {}
    for name, node in tree.items():
        path = f"{prefix}{name}"
        if "embedding" in node:
            state[f"{path}.weight"] = f32(node["embedding"])
        elif "scale" in node:
            state[f"{path}.weight"] = f32(node["scale"])
            state[f"{path}.bias"] = f32(node["bias"])
        elif "kernel" in node:
            state[f"{path}.weight"] = f32(node["kernel"]).T.contiguous()
            if "bias" in node:
                state[f"{path}.bias"] = f32(node["bias"])
        else:
            state.update(params_from_flax(node, f"{path}."))
    return state


def network(state: Mapping[str, torch.Tensor], config: SASRecConfig, device=None) -> SASRec:
    """A ``SASRec`` holding ``state`` on ``device`` (``cuda`` unless
    ``"cpu"`` is named), in eval mode: the serving network."""
    net = SASRec(config)
    net.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return net.to(resolve_device(device)).eval()


def train_sasrec(
    config: SASRecConfig,
    sequences: np.ndarray,   # [N, T] int padded item ids (0 = pad)
    device=None,
    log_every: int = 0,
    init_state: Mapping[str, torch.Tensor] | None = None,
    mesh=None,
    telemetry=None,
):
    """Train on next-item prediction on ``device`` (``cuda`` unless
    ``"cpu"`` is named); returns ``(state dict of host f32 tensors,
    losses)``.

    Inputs and targets are the sequence and its left shift: position t
    predicts the item at t + 1. Every epoch permutes the rows with the
    seeded ``np.random.default_rng``, and batches of ``batch_size`` are
    cut in that order, the short last batch included. ``losses`` holds
    every ``log_every``-th step's loss (read once at the end, so logging
    adds no device sync). ``init_state`` (a ``SASRec`` state dict)
    replaces the seeded init, so a test can start two frameworks from
    the same weights. ``telemetry`` (any object with
    ``record_epoch(epoch, seconds, losses)``) gets each epoch's wall time,
    the device synced, and every step's loss of the epoch.

    ``mesh`` (``parallel.mesh.Mesh``, the engine's ``ctx.mesh``): with
    more than one rank, training runs on ``mesh.device`` over
    ``_train_on_mesh`` (the reference's ``train_sasrec`` on its mesh);
    None or a 1 x 1 mesh is the one-device loop.
    """
    t = sequences.shape[1]
    if t != config.max_len:
        raise ValueError(f"sequences padded to {t}, config.max_len={config.max_len}")
    sp = mesh.axis_size("seq") if mesh is not None else 1
    if t % sp:
        raise ValueError(f"max_len={t} must divide over seq axis size {sp}")
    sharded = mesh is not None and mesh.size > 1
    device = mesh.device if sharded else resolve_device(device)
    net = init_model(config, mesh if sharded else None)
    if init_state is not None:
        net.load_state_dict({k: torch.as_tensor(v) for k, v in init_state.items()})
    net.to(device).train()
    optimizer = torch.optim.Adam(
        net.parameters(), lr=config.learning_rate, betas=(0.9, 0.999), eps=1e-8
    )
    inputs = torch.as_tensor(np.asarray(sequences, np.int64), device=device)
    targets = torch.zeros_like(inputs)
    targets[:, :-1] = inputs[:, 1:]
    np_rng = np.random.default_rng(config.seed)
    n = inputs.shape[0]
    if sharded:
        return _train_on_mesh(config, net, optimizer, inputs, targets, np_rng, mesh,
                              log_every, telemetry)
    step = 0
    logged: list[torch.Tensor] = []
    for epoch in range(config.epochs):
        t0 = time.perf_counter()
        epoch_losses: list[torch.Tensor] = []
        order = torch.as_tensor(np_rng.permutation(n), device=device)
        for start in range(0, n, config.batch_size):
            take = order[start : start + config.batch_size]
            loss = sequence_loss(net, inputs[take], targets[take])
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
    if config.epochs and step == 0:
        raise ValueError(
            f"no training steps ran: {n} sequence(s) cannot fill even one batch"
        )
    return _host_state(net), torch.stack(logged).tolist() if logged else []


def _host_state(net: nn.Module) -> dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in net.state_dict().items()}


def _train_on_mesh(config, net, optimizer, inputs, targets, np_rng, mesh, log_every,
                   telemetry):
    """The reference's sharded loop on one rank of ``mesh``: every rank
    holds every sequence and draws the same permutation; a batch is cut
    to a multiple of the ``data`` axis (skipped when that leaves nothing)
    and this rank takes rows ``[i B/d, (i + 1) B/d)`` for its ``data``
    position ``i`` and columns ``[j T/s, (j + 1) T/s)`` for its ``seq``
    position ``j``. Its loss is the masked cross-entropy summed over its
    block over the whole batch's target count (known to every rank, which
    holds the batch: the all-reduce of the per-rank counts), divided by
    the ranks that hold the same block (a ``model`` axis, which SASRec
    does not shard over); the ranks' losses then sum to the reference's
    masked mean. One all-reduce over every axis sums the gradients and
    the losses; Adam steps on every rank alike."""
    dp, sp = mesh.axis_size("data"), mesh.axis_size("seq")
    di, si = mesh.axis_index("data"), mesh.axis_index("seq")
    replicas = mesh.size // (dp * sp)
    t_local = inputs.shape[1] // sp
    params = list(net.parameters())
    n = inputs.shape[0]
    step = 0
    logged: list[torch.Tensor] = []
    for epoch in range(config.epochs):
        t0 = time.perf_counter()
        epoch_losses: list[torch.Tensor] = []
        order = torch.as_tensor(np_rng.permutation(n), device=inputs.device)
        for start in range(0, n, config.batch_size):
            take = order[start : start + config.batch_size]
            per = take.numel() // dp
            if not per:
                continue
            count = (targets[take[: per * dp]] > 0).sum().clamp_min(1)
            rows = take[di * per:(di + 1) * per]
            cols = slice(si * t_local, (si + 1) * t_local)
            tgt = targets[rows][:, cols]
            out = logits(net, net(inputs[rows][:, cols]))
            ce = F.cross_entropy(out.reshape(-1, out.shape[-1]), tgt.reshape(-1),
                                 ignore_index=0, reduction="sum")
            loss = ce / (count * replicas)
            optimizer.zero_grad(set_to_none=False)
            loss.backward()
            total = all_reduce_grads(mesh, mesh.axis_names, params, loss.detach())[0]
            optimizer.step()
            step += 1
            if log_every and step % log_every == 0:
                logged.append(total)
            if telemetry is not None:
                epoch_losses.append(total)
        if telemetry is not None:
            read = torch.stack(epoch_losses).tolist() if epoch_losses else []
            telemetry.record_epoch(epoch, time.perf_counter() - t0, read)
    if config.epochs:
        check_steps_ran(step, n, dp, "sequence")
    return _host_state(net), torch.stack(logged).tolist() if logged else []


def pack_prefixes(prefixes, max_len: int) -> tuple[np.ndarray, np.ndarray]:
    """``(seqs [B, max_len] int64, last [B])``: each prefix's last
    ``max_len`` ids, right-padded with 0, and the position of its last
    id."""
    seqs = np.zeros((len(prefixes), max_len), np.int64)
    last = np.zeros((len(prefixes),), np.int64)
    for i, p in enumerate(prefixes):
        tail = np.asarray(p, np.int64)[-max_len:]
        seqs[i, : len(tail)] = tail
        last[i] = max(len(tail) - 1, 0)
    return seqs, last


@torch.no_grad()
def next_item_scores(net: SASRec, seqs: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """Scores over the whole vocabulary (padding column 0 included) of
    the item after position ``last[b]`` of ``seqs[b]``: one forward and
    one ``[B, E] x [E, V]`` product, on ``net``'s device."""
    hidden = net(seqs)                                       # [B, T, E]
    h_last = hidden[torch.arange(seqs.shape[0], device=seqs.device), last]
    return h_last @ net.item_embed.weight.T                  # [B, V]


def score_next_items_batch(net: SASRec, prefixes) -> np.ndarray:
    """Scores over the item vocab for the next item after each prefix.

    ``prefixes``: list of 1-D id arrays (no padding); each uses its last
    ``max_len`` entries. Returns ``[B, num_items]`` (column i scores item
    id i + 1 -- id 0 is the padding token and is dropped). The batch runs
    as one forward at its own size: eager torch has no compiled shapes
    to bucket, so the reference's power-of-two padding is not kept.
    """
    if not len(prefixes):
        return np.zeros((0, net.config.num_items), np.float32)
    seqs, last = pack_prefixes(prefixes, net.config.max_len)
    device = net.item_embed.weight.device
    scores = next_item_scores(net, torch.from_numpy(seqs).to(device),
                              torch.from_numpy(last).to(device))
    return scores[:, 1:].cpu().numpy()


def score_next_items(net: SASRec, prefix: np.ndarray) -> np.ndarray:
    """Single-prefix convenience over :func:`score_next_items_batch`."""
    return score_next_items_batch(net, [prefix])[0]
