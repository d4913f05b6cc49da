"""The device mesh over ``torch.distributed`` ranks, and its collectives.

Port of ``predictionio_tpu/parallel/mesh.py``. Conventions as there:
axes ``("data", "model")``; batch-parallel arrays shard their leading dim
over ``data``, model-parallel factor blocks over ``model``. A JAX mesh is
a grid of devices in one program; here each point of the grid is one
rank (one process, one device), and ``Mesh`` holds the axis names, the
shape, the rank grid (the process rank at each mesh position), this
rank's coordinates and one process subgroup per axis (the ranks that
differ only along it). Every rank builds every subgroup in the same
order, as ``torch.distributed.new_group`` requires. A 1 x 1 mesh (one
process, no group) has no subgroups, and each collective is then the
identity, so the single-process paths run as they always did.

The grid need not be row-major: a hybrid mesh (``build_mesh``'s
``dcn_mesh_shape``) lays each host's ranks out as a block. A process
group numbers its members by process rank, not by mesh position, so
every collective that orders rows or chunks (``all_gather_rows``,
``reduce_scatter_rows``, ``all_to_all``) maps between the two itself:
rows and chunks go in mesh order whatever the grid.

The collectives the ALS half-steps use (reference: ``jax.lax`` inside
``shard_map``): ``all_gather_rows`` (``all_gather`` over one or more
axes, rows concatenated in mesh order), ``reduce_scatter_rows``
(``psum_scatter(..., tiled=True)``) and ``all_reduce_sum`` (``psum``).
They run over the axis's subgroup, or over the whole mesh for a tuple of
every axis. The sequence-parallel attention and NCF's model-axis shards
add three along one axis (``jax.lax`` inside ``shard_map``, where JAX
differentiates them; here ``torch.autograd.Function``s): ``all_to_all``
(tiled, one ``all_to_all_single``; its backward swaps the two axes),
``ppermute`` (a ring shift over the axis's subgroup, one
``batch_isend_irecv``; its backward shifts back) and ``all_gather``
along a dim (``gather_shards`` is its differentiable form, whose
backward reduce-scatters); ``all_reduce_grads`` sums a trainer's
gradients (and its loss) in one all-reduce. The transport is the
group's backend:

- NCCL takes the tensors where they are (on this rank's card); a host
  tensor goes to the card for the call and comes back (NCCL refuses host
  tensors).
- gloo, what ranks sharing one card use
  (``parallel.distributed.BACKEND_RULE``), takes the card's tensors as
  they are: torch 2.11's gloo does all-gather, reduce-scatter,
  all-reduce, broadcast and ``all_to_all_single`` on CUDA tensors
  (probed on an H100), copying them through host memory itself. Its
  point-to-point sends refuse CUDA tensors ("Bad address"), so
  ``ppermute`` (``GLOO_HOST_ONLY``) copies them to the host for the call
  and back, counted as ``"gloo:staged_ppermute"``. Its list
  ``all_to_all`` is missing; the single-tensor form is used. The
  kernels and all the arithmetic stay on the card.

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
row shards), ``put_global`` (this rank's slice of an array every rank
holds), ``shard_rows`` (zero-padded to the axis size, then this
rank's slice), ``shard_examples`` (``shard_rows`` with zero-weight pad
rows) and ``check_steps_ran`` follow the reference.
``seq_parallel_shard_map`` is the reference's ``shard_map`` specs as a
per-rank contract (each rank runs the body on its ``(data, seq)``
blocks).
"""

from __future__ import annotations

import weakref
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
    group's (None without a process group); ``grid`` the process rank at
    each mesh position (default row-major)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    coords: tuple[int, ...]
    device: torch.device
    backend: str | None = None
    groups: dict = field(default_factory=dict, repr=False)
    #: per axis of size above 1, the process ranks of this rank's subgroup
    #: in axis order (a point-to-point peer is named by its process rank)
    group_ranks: dict = field(default_factory=dict, repr=False)
    grid: np.ndarray | None = field(default=None, repr=False)

    def __post_init__(self):
        if self.grid is None:
            self.grid = np.arange(self.size).reshape(self.sizes)
        if self.groups:
            _MESHES_WITH_GROUPS.append(weakref.ref(self))

    @classmethod
    def build(cls, axes: tuple[str, ...], sizes: tuple[int, ...], device,
              backend: str | None, grid=None) -> "Mesh":
        """The mesh of this rank over ``grid`` (the process rank at each
        position; default row-major, rank ``r`` at the row-major
        coordinates of ``r``); the subgroups are made on every rank in
        one order."""
        dist = torch.distributed
        world = dist.get_world_size() if backend is not None else 1
        rank = dist.get_rank() if backend is not None else 0
        grid = (np.arange(world) if grid is None else np.asarray(grid)).reshape(sizes)
        if sorted(grid.ravel().tolist()) != list(range(world)):
            raise ValueError(f"rank grid {grid.tolist()} does not hold each of {world} ranks once")
        coords = tuple(int(c) for c in np.argwhere(grid == rank)[0])
        groups, group_ranks = {}, {}
        for a, axis in enumerate(axes):
            if sizes[a] == 1:
                continue
            # the ranks along ``axis``, one line per setting of the others
            lines = np.moveaxis(grid, a, -1).reshape(-1, sizes[a])
            for line in lines:
                members = [int(r) for r in line]
                group = dist.new_group(members)
                if rank in members:
                    groups[axis], group_ranks[axis] = group, members
        return cls(tuple(axes), tuple(int(s) for s in sizes), coords,
                   torch.device(device), backend, groups, group_ranks, grid)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    @property
    def rank(self) -> int:
        """This rank's position in the mesh (row-major over its
        coordinates). It is the process rank only on a row-major grid;
        process 0 is at position 0 of every grid ``build_mesh`` makes."""
        return int(np.ravel_multi_index(self.coords, self.sizes))

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)] if axis in self.axis_names else 0

    def _group(self, axes: tuple[str, ...]):
        """``(process group, members)`` of a collective over ``axes``: the
        axis's subgroup, or the whole group for every axis of size above
        1, with its members' process ranks in mesh order; ``(None,
        [rank])`` when only this rank takes part."""
        live = tuple(a for a in self.axis_names if a in axes and self.axis_size(a) > 1)
        if not live:
            return None, [None]
        if len(live) == 1:
            return self.groups[live[0]], self.group_ranks[live[0]]
        if set(live) != {a for a in self.axis_names if self.axis_size(a) > 1}:
            raise ValueError(f"a collective over {axes} of a {self.shape} mesh")
        return torch.distributed.group.WORLD, [int(r) for r in self.grid.ravel()]


#: every mesh holding process groups, weakly: ``release_subgroups`` drops them
_MESHES_WITH_GROUPS: list = []


def release_subgroups() -> None:
    """Drop every mesh's process-group handles (``parallel/distributed.py::
    shutdown_distributed``, after the process group is destroyed). A
    group a live mesh still held at interpreter exit was torn down with
    the C++ statics and could abort the process after its work was done
    (SIGABRT, "terminate called without an active exception")."""
    for ref in _MESHES_WITH_GROUPS:
        mesh = ref()
        if mesh is not None:
            mesh.groups.clear()
    _MESHES_WITH_GROUPS.clear()


def _group_order(members: list[int]) -> list[int] | None:
    """For each mesh position of ``members`` (process ranks in mesh
    order), its rank in the process group, which numbers its members in
    ascending process rank; None where the two orders agree."""
    ranked = sorted(members)
    order = [ranked.index(m) for m in members]
    return None if order == list(range(len(members))) else order


def _inverse(order: list[int]) -> list[int]:
    """The mesh position of each group rank (``order`` inverted)."""
    inv = [0] * len(order)
    for position, group_rank in enumerate(order):
        inv[group_rank] = position
    return inv


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
                {"world": torch.distributed.group.WORLD},
                {"world": list(range(info["world_size"]))})


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


#: collectives gloo does not take CUDA tensors for (probed on an H100,
#: torch 2.11): ``_transport`` stages their tensors through host memory
#: itself and counts each staging as ``"gloo:staged_<name>"``
GLOO_HOST_ONLY = frozenset({"ppermute"})


def _transport(mesh: Mesh, name: str, tensors: list[torch.Tensor]) -> tuple[list, object]:
    """The tensors as the group's backend takes them (NCCL: on the rank's
    card; gloo: as they are, or on the host for ``GLOO_HOST_ONLY``) and
    where results go back; counts the call."""
    CALLS[f"{mesh.backend}:{name}"] += 1
    home = tensors[0].device
    if mesh.backend == "nccl" and home.type == "cpu":
        return [t.to(mesh.device) for t in tensors], home
    if mesh.backend == "gloo" and home.type == "cuda" and name in GLOO_HOST_ONLY:
        CALLS[f"gloo:staged_{name}"] += 1
        return [t.cpu() for t in tensors], home
    return list(tensors), home


def all_gather_rows(mesh: Mesh, axes: tuple[str, ...], local: torch.Tensor) -> torch.Tensor:
    """Every rank's ``local`` rows along ``axes``, concatenated in mesh
    order on dim 0 (``jax.lax.all_gather(..., tiled=True)``)."""
    group, members = mesh._group(axes)
    if group is None:
        return local
    n = len(members)
    (x,), home = _transport(mesh, "all_gather", [local.contiguous()])
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    torch.distributed.all_gather_into_tensor(out, x, group=group)
    order = _group_order(members)
    if order is not None:  # the chunks came in group-rank order
        out = out.unflatten(0, (n, x.shape[0]))[torch.tensor(order, device=out.device)]
        out = out.flatten(0, 1)
    return out.to(home)


def reduce_scatter_rows(mesh: Mesh, axes: tuple[str, ...], x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``x`` along ``axes``, split on dim 0 into
    as many chunks as ranks; this rank keeps the chunk of its position
    (``jax.lax.psum_scatter(..., scatter_dimension=0, tiled=True)``)."""
    group, members = mesh._group(axes)
    if group is None:
        return x
    n = len(members)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks")
    (y,), home = _transport(mesh, "reduce_scatter", [x.contiguous()])
    out = torch.empty((y.shape[0] // n,) + tuple(y.shape[1:]), dtype=y.dtype, device=y.device)
    chunks = list(y.chunk(n))  # chunk p for mesh position p
    order = _group_order(members)
    if order is not None:      # the list goes out in group-rank order
        chunks = [chunks[p] for p in _inverse(order)]
    torch.distributed.reduce_scatter(out, chunks, group=group)
    return out.to(home)


def all_reduce_sum(mesh: Mesh, axes: tuple[str, ...], x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``x`` along ``axes`` (``jax.lax.psum``)."""
    group, _ = mesh._group(axes)
    if group is None:
        return x
    (y,), home = _transport(mesh, "all_reduce", [x.clone()])
    torch.distributed.all_reduce(y, group=group)
    return y.to(home)


def all_reduce_grads(mesh: Mesh, axes: tuple[str, ...], params, *extra) -> torch.Tensor:
    """Sum every param's ``.grad`` and the scalars ``extra`` along ``axes``
    in one all-reduce; the gradients are replaced in place and the summed
    ``extra`` returned."""
    flat = torch.cat([p.grad.reshape(-1) for p in params] + [x.reshape(1) for x in extra])
    flat = all_reduce_sum(mesh, axes, flat)
    at = 0
    for p in params:
        p.grad.copy_(flat[at:at + p.numel()].view_as(p))
        at += p.numel()
    return flat[at:]


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
    """This rank's slice of an array every rank holds IN FULL (each read
    the same event store / initialized from the same seed; host numpy or
    a tensor, sliced where it lies), on ``mesh.device``: rows ``[i * n /
    s, (i + 1) * n / s)`` for position ``i`` of ``s`` along ``axis``;
    ``axis=None`` places the whole array (replicated)."""
    full = a if isinstance(a, torch.Tensor) else np.ascontiguousarray(a)
    if axis is not None:
        require_axes(mesh, (axis,), "put_global")
        s, i = mesh.axis_size(axis), mesh.axis_index(axis)
        if full.shape[0] % s:
            raise ValueError(f"{full.shape[0]} rows do not shard over the {s}-way {axis} axis")
        per = full.shape[0] // s
        full = full[i * per:(i + 1) * per]
    if isinstance(full, torch.Tensor):
        return full.to(mesh.device)
    return torch.from_numpy(np.ascontiguousarray(full)).to(mesh.device)


def shard_rows(mesh: Mesh, *arrays, axis: str = "data"):
    """Pad rows (zeros) to the axis size, then this rank's slice of each
    (host numpy or tensors, as ``put_global`` takes them)."""
    require_axes(mesh, (axis,), "shard_rows")
    n_shards = mesh.axis_size(axis)
    out = []
    for arr in arrays:
        arr = arr if isinstance(arr, torch.Tensor) else np.asarray(arr)
        rows = arr.shape[0]
        padded = -(-rows // n_shards) * n_shards
        if padded != rows and isinstance(arr, torch.Tensor):
            arr = torch.cat([arr, arr.new_zeros((padded - rows,) + tuple(arr.shape[1:]))])
        elif padded != rows:
            pad_width = [(0, padded - rows)] + [(0, 0)] * (arr.ndim - 1)
            arr = np.pad(arr, pad_width)
        out.append(put_global(mesh, arr, axis))
    return out[0] if len(out) == 1 else tuple(out)


def shard_examples(mesh: Mesh | None, x, y):
    """The full-batch trainers' data-parallel entry (Naive Bayes,
    logistic regression): ``(x, y, w, mesh)``, this rank's rows of the
    examples over ``data`` (f32 ``x``, ``y`` as given; host numpy or
    tensors) on ``mesh.device`` with their weights ``w``, zero for the
    pad rows that make ``n`` divide the axis (so weighted means and
    masked counts stay exact). With no mesh, or a mesh without a
    ``data`` axis, the host arrays and unit weights, and ``mesh`` comes
    back None: the run is unsharded."""
    n = x.shape[0] if isinstance(x, torch.Tensor) else np.asarray(x).shape[0]
    weights = np.ones(n, dtype=np.float32)
    if mesh is not None and "data" not in mesh.axis_names:
        mesh = None
    if mesh is None:
        return np.asarray(x), np.asarray(y), weights, None
    x = x.to(torch.float32) if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)
    x_t, y_t, w_t = shard_rows(mesh, x, y, weights)
    return x_t, y_t, w_t, mesh


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


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """A bool tensor as uint8 (what every backend moves); others as they are."""
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def all_gather(mesh: Mesh, axis: str, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated in axis order on
    ``dim`` (``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``); bool
    tensors travel as uint8."""
    if mesh.axis_size(axis) == 1:
        return x
    moved = _as_bytes(x).movedim(dim, 0).contiguous()
    got = all_gather_rows(mesh, (axis,), moved).movedim(0, dim)
    return got.to(x.dtype)


def _all_to_all(mesh: Mesh, axis: str, x: torch.Tensor, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    group, members = mesh._group((axis,))
    n = len(members)
    if x.shape[split_axis] % n:
        raise ValueError(
            f"all_to_all: dim {split_axis} of {tuple(x.shape)} does not split over "
            f"the {n}-way {axis} axis"
        )
    chunks = _as_bytes(x).chunk(n, dim=split_axis)  # chunk p to mesh position p
    order = _group_order(members)
    if order is not None:  # sent and received in group-rank order
        chunks = [chunks[p] for p in _inverse(order)]
    (y,), home = _transport(mesh, "all_to_all", [torch.stack(chunks).contiguous()])
    out = torch.empty_like(y)
    torch.distributed.all_to_all_single(out, y, group=group)
    got = out.to(home).unbind(0)
    if order is not None:
        got = [got[g] for g in order]
    return torch.cat(got, dim=concat_axis).to(x.dtype)


class _AllToAll(torch.autograd.Function):
    """``all_to_all``; its transpose, the backward, swaps the two axes."""

    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, split_axis, concat_axis)
        return _all_to_all(mesh, axis, x, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_axis, concat_axis = ctx.args
        return _all_to_all(mesh, axis, g, concat_axis, split_axis), None, None, None, None


def all_to_all(mesh: Mesh, axis: str, x: torch.Tensor, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    ``x`` cut into as many chunks along ``split_axis`` as ``axis`` has
    ranks, chunk ``j`` sent to the ``j``-th rank, the received chunks
    concatenated along ``concat_axis`` in axis order (one
    ``all_to_all_single``). Differentiable: the gradient takes the
    all-to-all with the two axes swapped."""
    if mesh.axis_size(axis) == 1:
        return x
    split_axis, concat_axis = split_axis % x.dim(), concat_axis % x.dim()
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis)


def _shift(mesh: Mesh, axis: str, x: torch.Tensor, offset: int) -> torch.Tensor:
    group, ranks = mesh._group((axis,))
    n, me = len(ranks), mesh.axis_index(axis)
    (y,), home = _transport(mesh, "ppermute", [_as_bytes(x).contiguous()])
    out = torch.empty_like(y)
    dist = torch.distributed
    ops = [dist.P2POp(dist.isend, y, ranks[(me + offset) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(me - offset) % n], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out.to(home).to(x.dtype)


class _Shift(torch.autograd.Function):
    """``ppermute`` by ``offset``; the backward shifts back by ``-offset``."""

    @staticmethod
    def forward(ctx, x, mesh, axis, offset):
        ctx.args = (mesh, axis, offset)
        return _shift(mesh, axis, x, offset)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, offset = ctx.args
        return _shift(mesh, axis, g, -offset), None, None, None


def ppermute(mesh: Mesh, axis: str, x: torch.Tensor, offset: int = 1) -> torch.Tensor:
    """The ring shift ``jax.lax.ppermute(x, axis, [(j, (j + offset) % n)])``:
    the ``j``-th rank of ``axis`` sends ``x`` to rank ``j + offset`` and
    returns what rank ``j - offset`` sent (one ``batch_isend_irecv`` over
    the axis's subgroup, peers named by process rank). Differentiable:
    the gradient takes the shift back."""
    if mesh.axis_size(axis) == 1:
        return x
    return _Shift.apply(x, mesh, axis, offset)


def _reduce_scatter(mesh: Mesh, axis: str, x: torch.Tensor, dim: int) -> torch.Tensor:
    moved = x.movedim(dim, 0).contiguous()
    return reduce_scatter_rows(mesh, (axis,), moved).movedim(0, dim)


class _GatherShards(torch.autograd.Function):
    """``all_gather`` along ``dim``; the backward reduce-scatters it."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return all_gather(mesh, axis, x, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return _reduce_scatter(mesh, axis, g, dim), None, None, None


def gather_shards(mesh: Mesh, axis: str, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The full tensor of ``x``'s shards along ``axis`` (``all_gather``
    on ``dim``), differentiable: the gradient is the reduce-scatter of
    every rank's gradient of the full tensor, this rank's chunk of the
    sum. Each rank's loss is its share of the mesh's loss, so the sum
    over the axis is the gradient of the whole."""
    if mesh.axis_size(axis) == 1:
        return x
    return _GatherShards.apply(x, mesh, axis, dim % x.dim())


def seq_parallel_shard_map(body, mesh: Mesh, axis_name: str):
    """The reference's ``shard_map`` specs for the sequence-parallel
    attention strategies, as a per-rank contract: ``fn(q, k, v, mask)``
    runs ``body`` on this rank's blocks, q, k, v ``[B/d, T/s, H, D]`` (the
    batch over ``data`` when the mesh has that axis, the sequence over
    ``axis_name``) and the key mask ``[B/d, T/s]``. ``require_axes``
    fails first, with the reference's text, on a mesh without
    ``axis_name``."""
    require_axes(mesh, (axis_name,), "seq_parallel_shard_map")

    def fn(q, k, v, mask):
        if k.shape != q.shape or v.shape != q.shape or tuple(mask.shape) != tuple(q.shape[:2]):
            raise ValueError(
                f"seq_parallel_shard_map: q, k, v {tuple(q.shape)}, {tuple(k.shape)}, "
                f"{tuple(v.shape)} and mask {tuple(mask.shape)} are not one rank's "
                "[B, T, H, D] / [B, T] blocks"
            )
        return body(q, k, v, mask)

    return fn
