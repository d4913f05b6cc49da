"""The device mesh over ``torch.distributed`` ranks, and its collectives.

Port of ``predictionio_tpu/parallel/mesh.py``. Conventions as there:
axes ``("data", "model")``; batch-parallel arrays shard their leading dim
over ``data``, model-parallel factor blocks over ``model``. A JAX mesh is
a grid of devices in one program; here each point of the grid is one
rank (one process, one device), and ``Mesh`` holds the axis names, the
shape, this rank's coordinates and one process subgroup per axis (the
ranks that differ only along it). Every rank builds every subgroup in
the same order, as ``torch.distributed.new_group`` requires. A 1 x 1
mesh (one process, no group) has no subgroups, and each collective is
then the identity, so the single-process paths run as they always did.

The collectives the ALS half-steps use (reference: ``jax.lax`` inside
``shard_map``): ``all_gather_rows`` (``all_gather`` over one or more
axes, rows concatenated in mesh order), ``reduce_scatter_rows``
(``psum_scatter(..., tiled=True)``) and ``all_reduce_sum`` (``psum``).
They run over the axis's subgroup, or over the whole mesh for a tuple of
every axis. The transport is the group's backend:

- NCCL takes the tensors where they are (on this rank's card); a host
  tensor goes to the card for the call and comes back (NCCL refuses host
  tensors).
- gloo, what ranks sharing one card use
  (``parallel.distributed.BACKEND_RULE``), takes the card's tensors as
  they are: torch 2.11's gloo does all-gather, reduce-scatter,
  all-reduce and broadcast on CUDA tensors (probed on an H100), copying
  them through host memory itself, so nothing is staged here. The
  kernels and the solves still run on the card.

The launch-wide agreements (the streaming reader's scan bound and
snapshot, the resume step and factors of a checkpointed fit) run over
the same collectives: ``broadcast_int``, ``broadcast_rows``,
``all_reduce_min`` / ``all_reduce_max`` and ``barrier`` take a mesh, the
training mesh or ``world_mesh()`` (every rank on one axis, over the
process group itself).

Each collective that crosses ranks adds one to ``CALLS["backend:name"]``
(``collective_counts``): the traffic a train issued, which
``chip_smoke.py``'s dist_train part prints per rank.

``local_mesh``, ``require_axes``, ``fetch_global`` (the all-gather of
row shards), ``put_global`` (this rank's slice of a host array every
rank holds), ``shard_rows`` (zero-padded to the axis size, then this
rank's slice) and ``check_steps_ran`` follow the reference.
``seq_parallel_shard_map`` raises ``NotImplementedError`` (ROADMAP.md
slice 20).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

#: collectives that crossed ranks, by ``"backend:name"``
CALLS: Counter = Counter()


def collective_counts() -> dict:
    """``{"backend:name": calls}`` of the collectives so far."""
    return dict(CALLS)


@dataclass
class Mesh:
    """A ``(data, model)``-style grid of ranks: ``axis_names``, ``sizes``,
    this rank's ``coords``, its ``device`` and, per axis of size above 1,
    the process subgroup along it (``groups``). ``backend`` is the
    group's (None without a process group)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    coords: tuple[int, ...]
    device: torch.device
    backend: str | None = None
    groups: dict = field(default_factory=dict, repr=False)

    @classmethod
    def build(cls, axes: tuple[str, ...], sizes: tuple[int, ...], device,
              backend: str | None) -> "Mesh":
        """The mesh of this rank (row-major coordinates of its rank); the
        subgroups are made on every rank in one order."""
        dist = torch.distributed
        world = dist.get_world_size() if backend is not None else 1
        rank = dist.get_rank() if backend is not None else 0
        grid = np.arange(world).reshape(sizes)
        coords = tuple(int(c) for c in np.unravel_index(rank, sizes))
        groups = {}
        for a, axis in enumerate(axes):
            if sizes[a] == 1:
                continue
            # the ranks along ``axis``, one line per setting of the others
            lines = np.moveaxis(grid, a, -1).reshape(-1, sizes[a])
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[axis] = group
        return cls(tuple(axes), tuple(int(s) for s in sizes), coords,
                   torch.device(device), backend, groups)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    @property
    def rank(self) -> int:
        """This rank's position in the mesh (row-major): its process rank."""
        return int(np.ravel_multi_index(self.coords, self.sizes))

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)] if axis in self.axis_names else 0

    def _group(self, axes: tuple[str, ...]):
        """``(process group, ranks)`` of a collective over ``axes``: the
        axis's subgroup, the whole group for every axis of size above 1,
        or ``(None, 1)`` when only this rank takes part."""
        live = tuple(a for a in self.axis_names if a in axes and self.axis_size(a) > 1)
        if not live:
            return None, 1
        if len(live) == 1:
            return self.groups[live[0]], self.axis_size(live[0])
        if set(live) != {a for a in self.axis_names if self.axis_size(a) > 1}:
            raise ValueError(f"a collective over {axes} of a {self.shape} mesh")
        return torch.distributed.group.WORLD, self.size


def world_mesh() -> Mesh:
    """Every rank of the launch on one axis, ``"world"``, over the process
    group ``init_distributed`` brought up (no subgroup is made, so any
    rank may build it at any time); without a group, or with one rank, a
    1-rank mesh whose collectives are the identity."""
    from predictionio_tpu_torch.parallel.distributed import distributed_info

    info = distributed_info()
    if info is None or info["world_size"] == 1:
        return Mesh(("world",), (1,), (0,), torch.device("cpu"))
    return Mesh(("world",), (info["world_size"],), (info["rank"],),
                torch.device(info["device"]), info["backend"],
                {"world": torch.distributed.group.WORLD})


def local_mesh(data: int | None = None, model: int = 1, device=None) -> Mesh:
    """The ``(data, model)`` mesh over the launch's ranks; ``data=None``
    takes all ranks the model axis leaves (one process: 1 x 1)."""
    from predictionio_tpu_torch.parallel.distributed import build_mesh

    return build_mesh([-1 if data is None else data, model], ("data", "model"),
                      device=device)


def require_axes(mesh: Mesh, axes, what: str) -> None:
    """Fail fast when a spec/collective axis name is not bound by this
    mesh. The runtime twin of ``pio check``'s S001/S002: today every
    mesh is ``local_mesh()``'s ``("data", "model")`` singleton, but the
    MPMD slice directions mint per-engine meshes with their own axis
    sets -- an eager ValueError naming both sides beats jax's late
    unbound-axis-name error deep inside a trace."""
    missing = [a for a in axes if a is not None and a not in mesh.axis_names]
    if missing:
        raise ValueError(
            f"{what}: axis name(s) {missing} not bound by this mesh "
            f"(axes={list(mesh.axis_names)}) -- build the spec from the "
            f"mesh's own axis names or thread the intended mesh here"
        )


def _transport(mesh: Mesh, name: str, tensors: list[torch.Tensor]) -> tuple[list, object]:
    """The tensors as the group's backend takes them (NCCL: on the rank's
    card) and where results go back; counts the call."""
    CALLS[f"{mesh.backend}:{name}"] += 1
    home = tensors[0].device
    if mesh.backend == "nccl" and home.type == "cpu":
        return [t.to(mesh.device) for t in tensors], home
    return list(tensors), home


def all_gather_rows(mesh: Mesh, axes: tuple[str, ...], local: torch.Tensor) -> torch.Tensor:
    """Every rank's ``local`` rows along ``axes``, concatenated in mesh
    order on dim 0 (``jax.lax.all_gather(..., tiled=True)``)."""
    group, n = mesh._group(axes)
    if group is None:
        return local
    (x,), home = _transport(mesh, "all_gather", [local.contiguous()])
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    torch.distributed.all_gather_into_tensor(out, x, group=group)
    return out.to(home)


def reduce_scatter_rows(mesh: Mesh, axes: tuple[str, ...], x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``x`` along ``axes``, split on dim 0 into
    as many chunks as ranks; this rank keeps the chunk of its position
    (``jax.lax.psum_scatter(..., scatter_dimension=0, tiled=True)``)."""
    group, n = mesh._group(axes)
    if group is None:
        return x
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks")
    (y,), home = _transport(mesh, "reduce_scatter", [x.contiguous()])
    out = torch.empty((y.shape[0] // n,) + tuple(y.shape[1:]), dtype=y.dtype, device=y.device)
    torch.distributed.reduce_scatter(out, list(y.chunk(n)), group=group)
    return out.to(home)


def all_reduce_sum(mesh: Mesh, axes: tuple[str, ...], x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``x`` along ``axes`` (``jax.lax.psum``)."""
    group, _ = mesh._group(axes)
    if group is None:
        return x
    (y,), home = _transport(mesh, "all_reduce", [x.clone()])
    torch.distributed.all_reduce(y, group=group)
    return y.to(home)


def all_reduce_max(mesh: Mesh, value: int) -> int:
    """The largest ``value`` over the whole mesh (control-flow agreement:
    every rank takes the branch one of them needs)."""
    return _all_reduce_int(mesh, value, torch.distributed.ReduceOp.MAX)


def all_reduce_min(mesh: Mesh, value: int) -> int:
    """The smallest ``value`` over the whole mesh: the branch every rank
    can take."""
    return _all_reduce_int(mesh, value, torch.distributed.ReduceOp.MIN)


def _all_reduce_int(mesh: Mesh, value: int, op) -> int:
    group, _ = mesh._group(mesh.axis_names)
    if group is None:
        return int(value)
    (y,), _ = _transport(mesh, "all_reduce", [torch.tensor([int(value)], dtype=torch.int64)])
    torch.distributed.all_reduce(y, op=op, group=group)
    return int(y.item())


def broadcast_rows(mesh: Mesh, x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Process rank ``src``'s ``x`` on every rank of the mesh; each rank
    passes a tensor of the same shape and dtype."""
    group, _ = mesh._group(mesh.axis_names)
    if group is None:
        return x
    (y,), home = _transport(mesh, "broadcast", [x.clone()])
    torch.distributed.broadcast(y, src, group=group)
    return y.to(home)


def broadcast_int(mesh: Mesh, value: int, src: int = 0) -> int:
    """Process rank ``src``'s ``value`` on every rank of the mesh."""
    return int(broadcast_rows(mesh, torch.tensor([int(value)], dtype=torch.int64), src)[0])


def barrier(mesh: Mesh) -> None:
    """Every rank of the mesh reaches this point before any leaves it."""
    _all_reduce_int(mesh, 0, torch.distributed.ReduceOp.SUM)


def fetch_global(mesh: Mesh, local: torch.Tensor, axis: str = "data") -> np.ndarray:
    """Host copy of an array row-sharded over ``axis``: the all-gather of
    every rank's rows (on a 1 x 1 mesh, ``local`` itself)."""
    require_axes(mesh, (axis,), "fetch_global")
    return all_gather_rows(mesh, (axis,), local).cpu().numpy()


def put_global(mesh: Mesh, a, axis: str | None = "data") -> torch.Tensor:
    """This rank's slice of a host array every rank holds IN FULL (each
    read the same event store / initialized from the same seed), on
    ``mesh.device``: rows ``[i * n / s, (i + 1) * n / s)`` for position
    ``i`` of ``s`` along ``axis``; ``axis=None`` places the whole array
    (replicated)."""
    host = np.ascontiguousarray(a)
    if axis is not None:
        require_axes(mesh, (axis,), "put_global")
        s, i = mesh.axis_size(axis), mesh.axis_index(axis)
        if host.shape[0] % s:
            raise ValueError(f"{host.shape[0]} rows do not shard over the {s}-way {axis} axis")
        per = host.shape[0] // s
        host = host[i * per:(i + 1) * per]
    return torch.from_numpy(np.ascontiguousarray(host)).to(mesh.device)


def shard_rows(mesh: Mesh, *arrays, axis: str = "data"):
    """Pad rows to the axis size, then this rank's slice of each."""
    require_axes(mesh, (axis,), "shard_rows")
    n_shards = mesh.axis_size(axis)
    out = []
    for arr in arrays:
        arr = np.asarray(arr)
        rows = arr.shape[0]
        padded = -(-rows // n_shards) * n_shards
        if padded != rows:
            pad_width = [(0, padded - rows)] + [(0, 0)] * (arr.ndim - 1)
            arr = np.pad(arr, pad_width)
        out.append(put_global(mesh, arr, axis))
    return out[0] if len(out) == 1 else tuple(out)


def check_steps_ran(steps: int, n_examples: int, data_axis_size: int, what: str):
    """Raise when a training loop completed without a single step: the data
    can't fill even one batch across the data axis (shared guard for the
    sharded model templates)."""
    if steps == 0:
        raise ValueError(
            f"no training steps ran: {n_examples} {what}(s) cannot fill even "
            f"one batch across the {data_axis_size}-way data axis -- use "
            "fewer devices or more data"
        )


def seq_parallel_shard_map(body, mesh: Mesh, axis_name: str, check_vma: bool = True):
    """Sequence-parallel attention (ring attention, Ulysses) over a mesh
    axis is not ported yet: ROADMAP.md slice 20."""
    raise NotImplementedError(
        "sequence-parallel attention over a mesh axis is not ported yet: "
        "ROADMAP.md slice 20"
    )
