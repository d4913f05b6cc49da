"""The multi-process launch contract on ``torch.distributed``.

Port of ``predictionio_tpu/parallel/distributed.py``. The reference
scales out through ``jax.distributed``: one process per host, a
coordinator address, then one global device list. The port runs one
process per card (or several processes sharing one card) and joins them
in a ``torch.distributed`` process group:

- ``init_distributed``: idempotent, from explicit args or the launcher
  contract's ``PIO_COORDINATOR`` / ``PIO_NUM_PROCESSES`` /
  ``PIO_PROCESS_ID`` env (set three variables per process, run the same
  ``pio train`` everywhere). It returns False when there is no
  coordinator, as the reference's does. The rendezvous is the
  ``tcp://COORDINATOR`` one (a ``TCPStore`` that rank 0 hosts), made
  explicitly so that each rank first learns which ranks share its host:
  rank ``r`` takes card ``local_rank % cuda.device_count()``.
- The backend, by one rule (``BACKEND_RULE``): ``nccl`` when each rank
  has a card of its own (the ranks on this host are no more than its
  cards), ``gloo`` on the CPU or when ranks share one card (NCCL refuses
  two ranks on one device). It picks a transport only: tensors and
  kernels stay on the card either way (``parallel/mesh.py`` says how a
  collective crosses a gloo group). ``distributed_info`` reports the
  choice and the rule; ``init_distributed`` logs them.
- ``build_mesh``: the ``("data", "model")`` mesh over the ranks
  (``parallel.mesh.Mesh``), a ``-1`` entry absorbing the remaining
  ranks as the reference's ``_resolve_wildcard`` does. A shape needing
  more ranks than the launch has raises; so does one leaving a rank out
  (an idle rank would hang its peers' collectives). ``dcn_mesh_shape``
  builds the reference's hybrid mesh (``hybrid_rank_grid``): the global
  axis sizes are the elementwise product of the two shapes, and each
  granule's ranks form a block of the grid. The granule is the host (the
  ranks ``init_distributed`` found under one ``socket.gethostname()``),
  where the reference takes the slice, or the process on platforms
  without slices; the bad shapes raise the reference's texts, a rank
  standing for its "device".
- ``host_local_batch``: each rank passes the rows it loaded and gets
  them back as its shard, on its device; the row counts must agree
  along the sharded axis.

The collectives themselves, the launch-wide agreements included, are
``parallel/mesh.py``'s (``world_mesh`` spans every rank).

An initialization or collective failure raises: nothing here falls back
to one process. ``launch_process_id``, ``strip_launch_conf``,
``LAUNCH_SCOPED_KEYS`` and ``LAUNCH_SCOPED_ENV`` are the reference's.
"""

from __future__ import annotations

import atexit
import datetime as _dt
import logging
import os
import socket

import torch

logger = logging.getLogger("pio.distributed")

#: runtime-conf keys that describe THIS launch, not the engine: they must
#: not be replayed from a persisted EngineInstance (a serving process would
#: try to join the long-dead training coordinator as the wrong rank)
LAUNCH_SCOPED_KEYS = ("pio.coordinator", "pio.num_processes", "pio.process_id")
LAUNCH_SCOPED_ENV = ("PIO_COORDINATOR", "PIO_NUM_PROCESSES", "PIO_PROCESS_ID")

#: the backend rule ``init_distributed`` applies (printed by chip_smoke)
BACKEND_RULE = (
    "nccl when each rank has a card of its own (ranks on the host <= its "
    "cards); gloo on the CPU or when ranks share one card"
)

#: how long a rank waits for its peers (rendezvous and each collective)
TIMEOUT = _dt.timedelta(seconds=600)

#: what ``init_distributed`` chose, None before it ran
_INFO: dict | None = None


def launch_process_id(runtime_conf=None) -> int:
    """This process's rank under the launcher contract, 0 when standalone.

    Usable BEFORE jax.distributed initializes (which happens lazily inside
    mesh construction): run_train needs the rank up front to decide which
    process owns the persistence side effects (lock, instance row, model
    blob, step checkpoints).
    """
    if runtime_conf and runtime_conf.get("pio.process_id") is not None:
        return int(runtime_conf["pio.process_id"])
    return int(os.environ.get("PIO_PROCESS_ID", "0") or 0)


def strip_launch_conf(runtime_conf: dict | None) -> dict:
    """Drop launch-scoped keys before persisting runtime conf."""
    return {
        k: v for k, v in (runtime_conf or {}).items()
        if k not in LAUNCH_SCOPED_KEYS
    }


def world_size() -> int:
    """The process group's size, 1 when no group is up."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def distributed_info() -> dict | None:
    """``{"backend", "rule", "rank", "world_size", "local_rank",
    "local_size", "device", "hosts"}`` of the group ``init_distributed``
    brought up (``hosts``: each rank's host name), or None."""
    return None if _INFO is None else dict(_INFO)


def choose_backend(device: torch.device, local_size: int) -> str:
    """``BACKEND_RULE``: ``nccl`` for a card per rank, else ``gloo``."""
    if device.type == "cuda" and local_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device, local_rank: int) -> torch.device:
    """The device of the ``local_rank``-th rank of a host: ``cuda:(local_rank
    % cards)`` unless the caller asks for the CPU (``resolve_device``'s
    rule: a card, or a ``RuntimeError`` without one)."""
    from predictionio_tpu_torch.utils.device import resolve_device

    base = resolve_device(device)
    if base.type == "cpu":
        return base
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> bool:
    """Join the launch's process group (idempotent).

    Args fall back to ``PIO_COORDINATOR`` (``host:port``) /
    ``PIO_NUM_PROCESSES`` / ``PIO_PROCESS_ID``. Returns True when running
    multi-process after the call, False for the single-process (no
    coordinator) case. ``device`` is where this rank computes (``cuda``
    unless ``"cpu"`` is named). A peer that never arrives raises after
    ``TIMEOUT``."""
    global _INFO
    dist = torch.distributed
    coordinator = coordinator or os.environ.get("PIO_COORDINATOR")
    if not coordinator and _INFO is None:
        return False
    if _INFO is not None:
        if coordinator:
            logger.warning(
                "distributed runtime already initialized; ignoring "
                "coordinator=%s", coordinator,
            )
        return dist.get_world_size() > 1
    num_processes = int(
        num_processes
        if num_processes is not None
        else os.environ.get("PIO_NUM_PROCESSES", "1")
    )
    process_id = int(
        process_id if process_id is not None else os.environ.get("PIO_PROCESS_ID", "0")
    )
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside a launch of {num_processes}")
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator {coordinator!r} is not HOST:PORT")
    store = dist.TCPStore(host, int(port), num_processes, process_id == 0,
                          timeout=TIMEOUT)
    # which ranks share this host: the rank's card and the backend follow
    store.set(f"pio/host/{process_id}", socket.gethostname())
    hosts = [store.get(f"pio/host/{r}").decode() for r in range(num_processes)]
    mine = hosts[process_id]
    local_rank = hosts[:process_id].count(mine)
    local_size = hosts.count(mine)
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = choose_backend(dev, local_size)
    dist.init_process_group(
        backend, store=dist.PrefixStore("pio/group", store), rank=process_id,
        world_size=num_processes, timeout=TIMEOUT,
    )
    # leave the group before the interpreter tears down: a process that
    # exits with the group's threads alive can abort
    atexit.register(shutdown_distributed)
    _INFO = {
        "backend": backend, "rule": BACKEND_RULE, "rank": process_id,
        "world_size": num_processes, "local_rank": local_rank,
        "local_size": local_size, "device": str(dev), "hosts": hosts,
    }
    logger.info(
        "distributed runtime up: process %d/%d via tcp://%s on %s, backend %s (%s)",
        process_id, num_processes, coordinator, dev, backend, BACKEND_RULE,
    )
    return num_processes > 1


def shutdown_distributed() -> None:
    """Leave the process group (tests and the end of a worker), then drop
    the meshes' subgroup handles and collect them while the interpreter
    is whole (``parallel/mesh.py::release_subgroups``)."""
    global _INFO
    import gc

    from predictionio_tpu_torch.parallel.mesh import release_subgroups

    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
        release_subgroups()
        gc.collect()
    _INFO = None


def build_mesh(
    mesh_shape: list[int],
    axes: tuple[str, ...],
    dcn_mesh_shape: list[int] | None = None,
    device=None,
):
    """The mesh (``parallel.mesh.Mesh``) over the launch's ranks.

    ``mesh_shape`` lists each axis's size; one ``-1`` entry absorbs the
    remaining ranks. Rank ``r`` sits at the row-major coordinates of ``r``
    (the reference's process-contiguous device order). ``dcn_mesh_shape``,
    when given, is the per-axis factor across hosts: ``mesh_shape`` is
    then each host's shape and the ranks lie as ``hybrid_rank_grid`` lays
    them. ``device`` is this rank's device when no group is up
    (``init_distributed`` chose it otherwise)."""
    from predictionio_tpu_torch.parallel.mesh import Mesh

    if len(mesh_shape) != len(axes):
        raise ValueError(
            f"mesh_shape {mesh_shape} and mesh_axes {axes} have different ranks"
        )
    world = world_size()
    grid = None
    if dcn_mesh_shape is not None:
        hosts = _INFO["hosts"] if _INFO is not None else [socket.gethostname()]
        grid = hybrid_layout(mesh_shape, axes, dcn_mesh_shape, hosts)
        resolved = list(grid.shape)
    else:
        resolved = _resolve_wildcard(mesh_shape, world)
    total = _prod(resolved)
    if total > world:
        raise ValueError(
            f"mesh shape {resolved} needs {total} ranks, have {world}"
        )
    if total < world:
        raise ValueError(
            f"mesh shape {resolved} covers {total} of the launch's {world} ranks; "
            "every rank trains (use a -1 wildcard to absorb them)"
        )
    if _INFO is not None:
        dev = torch.device(_INFO["device"])
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(
                f"this rank joined the group on {dev}; a mesh on {device} cannot use it"
            )
    else:
        from predictionio_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device)  # one process: the caller's device as named
    mesh = Mesh.build(tuple(axes), tuple(resolved), dev,
                      None if _INFO is None else _INFO["backend"], grid)
    logger.info("mesh: %s over %d rank(s) on %s%s", dict(zip(axes, resolved)), total, dev,
                "" if grid is None else f", hybrid (dcn {list(dcn_mesh_shape)})")
    return mesh


def hybrid_layout(mesh_shape: list[int], axes: tuple[str, ...], dcn_mesh_shape: list[int],
                  hosts: list[str]):
    """The rank grid of the hybrid mesh ``mesh_shape`` x ``dcn_mesh_shape``
    over a launch whose rank ``r`` runs on ``hosts[r]``: the reference's
    checks (``predictionio_tpu/parallel/distributed.py:144-182``, a rank
    for each device, with its texts), then ``hybrid_rank_grid``."""
    if len(dcn_mesh_shape) != len(axes):
        raise ValueError(
            f"dcn_mesh_shape {dcn_mesh_shape} and mesh_axes {axes} have "
            "different ranks"
        )
    world = len(hosts)
    dcn_total = _prod(dcn_mesh_shape)
    if world % dcn_total:
        raise ValueError(
            f"dcn_mesh_shape {dcn_mesh_shape} (product {dcn_total}) does "
            f"not divide the {world}-device fleet"
        )
    resolved = _resolve_wildcard(mesh_shape, world // dcn_total)
    total = _prod(resolved) * dcn_total
    if total != world:
        raise ValueError(
            f"mesh shape {resolved} x dcn {dcn_mesh_shape} covers {total} "
            f"device(s) but the fleet has {world}; a hybrid mesh "
            "must use every device (use -1 wildcards to auto-fill)"
        )
    return hybrid_rank_grid(resolved, dcn_mesh_shape, hosts)


def hybrid_rank_grid(mesh_shape: list[int], dcn_mesh_shape: list[int], hosts: list[str]):
    """``jax.experimental.mesh_utils.create_hybrid_device_mesh(mesh_shape,
    dcn_mesh_shape, process_is_granule=True)`` over ranks, with the host
    as the granule: the ranks grouped by ``hosts[r]``, the groups in
    order of their lowest rank and each group's ranks in rank order; each
    group reshaped to ``mesh_shape``, the groups laid out over
    ``dcn_mesh_shape``, the blocks joined (``np.block``). Process 0 lands
    at position 0. Raises the reference's errors for a host count other
    than the DCN product and a host whose ranks do not fill
    ``mesh_shape``."""
    import numpy as np

    granules: dict[str, list[int]] = {}
    for rank, host in enumerate(hosts):
        granules.setdefault(host, []).append(rank)
    ordered = list(granules.values())
    if _prod(dcn_mesh_shape) != len(ordered):
        raise ValueError(
            f"Number of slices {len(ordered)} must equal the product of "
            f"dcn_mesh_shape {dcn_mesh_shape}"
        )
    shape = tuple(int(s) for s in mesh_shape)
    per_granule = []
    for ranks in ordered:
        if _prod(shape) != len(ranks):
            raise ValueError(
                f"Number of devices {len(ranks)} must equal the product "
                f"of mesh_shape {shape}"
            )
        per_granule.append(np.array(ranks).reshape(shape))
    granule_mesh = np.arange(len(ordered)).reshape(dcn_mesh_shape)
    blocks = np.vectorize(lambda i: per_granule[i], otypes=[object])(granule_mesh)
    return np.block(blocks.tolist())


def host_local_batch(mesh, axis: str, local_arrays):
    """Each rank's rows (a pytree of numpy arrays) as its shard of a batch
    sharded over ``axis``: the same pytree of tensors on ``mesh.device``.
    Every rank of the axis must pass the same number of rows (the
    reference's ``make_array_from_process_local_data`` contract)."""
    from predictionio_tpu_torch.parallel.mesh import all_gather_rows, require_axes

    import numpy as np

    require_axes(mesh, (axis,), "host_local_batch")

    def put(x):
        arr = np.ascontiguousarray(x)
        rows = torch.tensor([arr.shape[0] if arr.ndim else 1], dtype=torch.int64)
        counts = all_gather_rows(mesh, (axis,), rows)
        if int(counts.min()) != int(counts.max()):
            raise ValueError(
                f"host_local_batch: the {axis} axis's ranks hold {counts.tolist()} rows"
            )
        return torch.from_numpy(arr).to(mesh.device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return put(node)

    return walk(local_arrays)


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _resolve_wildcard(shape: list[int], n_devices: int) -> list[int]:
    resolved = [int(s) for s in shape]
    if resolved.count(-1) > 1:
        raise ValueError(f"mesh shape {shape} has more than one -1")
    if -1 in resolved:
        known = _prod(s for s in resolved if s != -1)
        resolved[resolved.index(-1)] = max(n_devices // known, 1)
    return resolved
