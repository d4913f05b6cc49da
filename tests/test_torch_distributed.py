"""The port's launch contract and mesh (``parallel/distributed.py``,
``parallel/mesh.py``) on the CPU, against the JAX package's.

In one process: the launch helpers equal the reference's, the default
mesh is 1 x 1 and its collectives are the identity, and the shapes the
port refuses raise (more ranks than the launch has, a rank left out;
sequence-parallel attention on a mesh without the axis, with the
reference's text; the hybrid meshes are ``test_torch_hybrid_mesh.py``'s). Across processes:
``run_workers`` launches gloo workers of the port under the launch
contract (``PIO_COORDINATOR`` / ``PIO_NUM_PROCESSES`` / ``PIO_PROCESS_ID``)
with a timeout that kills every worker, and the collectives, the mesh's
subgroups and ``host_local_batch`` are checked inside them. The port of
``tests/test_multiprocess_distributed.py::
test_two_process_als_matches_single_process`` closes the file: two ranks
train the data-sharded fit and equal JAX's fit on the same 2 x 1 mesh of
virtual devices within 1e-4 (the reference's own two-process test allows
2e-2; the port's ranks sum in the order one device does, so its gap is
the one-process port's).
"""

import inspect
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from predictionio_tpu.parallel import distributed as jax_distributed
from predictionio_tpu.parallel import mesh as jax_mesh
from predictionio_tpu_torch.parallel import distributed, mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(script: str, n: int = 2, timeout: float = 120, env: dict | None = None,
                args: tuple = ()) -> list[str]:
    """Run ``script`` (Python source) as ``n`` ranks of one launch, each
    with the launch contract's env (a fresh coordinator port) and the
    repo on its path; assert each exits 0 printing OK, and return their
    outputs. A timeout kills ALL workers (a hung collective must not leak
    a sibling into later tests)."""
    coordinator = f"127.0.0.1:{free_port()}"
    procs = []
    for rank in range(n):
        worker_env = dict(os.environ, PYTHONPATH=REPO, PIO_COORDINATOR=coordinator,
                          PIO_NUM_PROCESSES=str(n), PIO_PROCESS_ID=str(rank),
                          OMP_NUM_THREADS="1", **(env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(script), *map(str, args)],
            cwd=REPO, env=worker_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ))
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "OK" in out, out
    return outs


def test_launch_helpers_equal_the_reference(monkeypatch):
    conf = {"pio.coordinator": "h:1", "pio.num_processes": 2, "pio.process_id": 1,
            "pio.mesh_shape": [2, 1]}
    assert distributed.LAUNCH_SCOPED_KEYS == jax_distributed.LAUNCH_SCOPED_KEYS
    assert distributed.LAUNCH_SCOPED_ENV == jax_distributed.LAUNCH_SCOPED_ENV
    assert distributed.strip_launch_conf(conf) == jax_distributed.strip_launch_conf(conf)
    assert distributed.strip_launch_conf(conf) == {"pio.mesh_shape": [2, 1]}
    for runtime_conf in (conf, None, {}):
        assert distributed.launch_process_id(runtime_conf) == \
            jax_distributed.launch_process_id(runtime_conf)
    monkeypatch.setenv("PIO_PROCESS_ID", "3")
    monkeypatch.setenv("PIO_NUM_PROCESSES", "4")
    assert distributed.launch_process_id() == jax_distributed.launch_process_id() == 3
    for shape, n in (([-1, 1], 8), ([2, -1], 8), ([4, 2], 8), ([-1, 3], 2)):
        assert distributed._resolve_wildcard(shape, n) == \
            jax_distributed._resolve_wildcard(shape, n)


def _dotted_names(module) -> set:
    """Every dotted name (``a.b.c``) the module's code refers to."""
    import ast
    import inspect

    out = set()
    for node in ast.walk(ast.parse(inspect.getsource(module))):
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            out.add(".".join([node.id] + parts[::-1]))
    return out


def test_torch_distributed_is_the_only_transport():
    """The launch contract and the collectives go through
    ``torch.distributed`` (``init_process_group``, the all-gather and
    reduce-scatter) and nothing of ``jax.distributed``: the port's code
    names no ``jax`` at all (``tests/test_torch_imports.py`` guards the
    imports)."""
    from predictionio_tpu_torch.parallel import als

    names = set().union(*(_dotted_names(m) for m in (distributed, mesh, als)))
    assert not any(n == "jax" or n.startswith("jax.") for n in names)
    assert "dist.init_process_group" in _dotted_names(distributed)
    assert "dist.new_group" in _dotted_names(mesh)
    assert {"torch.distributed.all_gather_into_tensor", "torch.distributed.reduce_scatter",
            "torch.distributed.all_reduce"} <= names


def test_no_coordinator_is_one_process(monkeypatch):
    monkeypatch.delenv("PIO_COORDINATOR", raising=False)
    assert distributed.init_distributed() is False
    assert distributed.world_size() == 1 and distributed.distributed_info() is None
    world = mesh.world_mesh()
    assert world.size == 1 and world.rank == 0 and world.backend is None
    assert mesh.broadcast_int(world, 7) == 7 and mesh.all_reduce_min(world, 5) == 5
    mesh.barrier(world)
    assert mesh.collective_counts() == {}


def test_one_process_mesh_keeps_the_named_card(monkeypatch):
    """Without a process group the mesh sits on the device the caller
    named (``cuda:1`` stays ``cuda:1``); only ``init_distributed`` maps a
    rank to a card."""
    monkeypatch.delenv("PIO_COORDINATOR", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    m = distributed.build_mesh([-1, 1], ("data", "model"), device="cuda:1")
    assert m.device == torch.device("cuda", 1) and m.size == 1


def test_backend_rule(monkeypatch):
    """NCCL when each rank of a host has a card of its own, gloo on the
    CPU or when ranks share a card."""
    assert distributed.choose_backend(torch.device("cpu"), 1) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert distributed.choose_backend(torch.device("cuda", 0), 1) == "nccl"
    assert distributed.choose_backend(torch.device("cuda", 0), 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert distributed.choose_backend(torch.device("cuda", 1), 4) == "nccl"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    assert distributed.rank_device("cuda", 5) == torch.device("cuda", 1)
    assert distributed.rank_device("cpu", 5) == torch.device("cpu")
    assert "gloo" in distributed.BACKEND_RULE and "nccl" in distributed.BACKEND_RULE


def test_bad_launches_raise():
    with pytest.raises(ValueError, match="outside a launch"):
        distributed.init_distributed("127.0.0.1:1", 2, 2, device="cpu")
    with pytest.raises(ValueError, match="HOST:PORT"):
        distributed.init_distributed("localhost", 2, 0, device="cpu")
    assert distributed.distributed_info() is None


def test_one_process_mesh_is_1x1_and_collectives_are_identity():
    m = mesh.local_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.size == 1 and m.rank == 0
    assert m.coords == (0, 0) and m.device == torch.device("cpu") and m.backend is None
    x = torch.arange(6.0).reshape(3, 2)
    for axes in (("data",), ("model",), ("data", "model")):
        assert mesh.all_gather_rows(m, axes, x) is x
        assert mesh.reduce_scatter_rows(m, axes, x) is x
        assert mesh.all_reduce_sum(m, axes, x) is x
    assert mesh.all_reduce_max(m, 3) == 3 and mesh.all_reduce_min(m, 3) == 3
    assert mesh.broadcast_rows(m, x) is x and mesh.broadcast_int(m, 4) == 4
    np.testing.assert_array_equal(mesh.fetch_global(m, x), x.numpy())
    a = np.arange(10.0).reshape(5, 2)
    np.testing.assert_array_equal(mesh.put_global(m, a).numpy(), a)
    # zero-padded to the axis size, as the reference's (one shard: none)
    jm = jax_mesh.local_mesh(1, 1)
    np.testing.assert_array_equal(mesh.shard_rows(m, a).numpy(),
                                  np.asarray(jax_mesh.shard_rows(jm, a)))
    assert mesh.collective_counts() == {}  # the identity crosses no rank
    batch = distributed.host_local_batch(m, "data", {"x": a, "y": [a[:, 0]]})
    np.testing.assert_array_equal(batch["y"][0].numpy(), a[:, 0])


def test_mesh_refusals():
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        distributed.build_mesh([2, 1], ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="different ranks"):
        distributed.build_mesh([1, 1], ("data",), device="cpu")
    with pytest.raises(ValueError, match="more than one -1"):
        distributed.build_mesh([-1, -1], ("data", "model"), device="cpu")
    m = mesh.local_mesh(device="cpu")
    with pytest.raises(ValueError, match="not bound by this mesh") as got:
        mesh.require_axes(m, ("seq",), "probe")
    with pytest.raises(ValueError) as want:
        jax_mesh.require_axes(jax_mesh.local_mesh(1, 1), ("seq",), "probe")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="no training steps ran"):
        mesh.check_steps_ran(0, 3, 8, "rating")
    mesh.check_steps_ran(1, 3, 8, "rating")


def test_seq_parallel_needs_a_bound_seq_axis():
    """Sequence parallelism over an axis the mesh does not bind fails
    first with the reference's unbound-axis error."""
    with pytest.raises(ValueError, match="not bound by this mesh") as got:
        mesh.seq_parallel_shard_map(None, mesh.local_mesh(device="cpu"), "seq")
    with pytest.raises(ValueError) as want:
        jax_mesh.seq_parallel_shard_map(None, jax_mesh.local_mesh(1, 1), "seq")
    assert str(got.value) == str(want.value)


_COLLECTIVES = """
import sys
import numpy as np
import torch
from predictionio_tpu_torch.parallel import distributed, mesh as M

d, m = int(sys.argv[1]), int(sys.argv[2])
device = sys.argv[3] if len(sys.argv) > 3 else "cpu"
backend = "nccl" if device == "cuda" else "gloo"  # cuda: a card a rank
assert distributed.init_distributed(device=device)
info = distributed.distributed_info()
assert info["backend"] == backend and info["local_size"] == d * m, info
mesh = distributed.build_mesh([d, -1], ("data", "model"), device=device)
on = mesh.device
rank = torch.distributed.get_rank()
assert mesh.rank == rank and mesh.shape == {"data": d, "model": m}
di, mi = mesh.axis_index("data"), mesh.axis_index("model")
assert (di, mi) == (rank // m, rank % m)
x = torch.full((2, 3), float(rank))  # on the host: NCCL lifts it to the card and back
# all-gather over one axis: the axis's ranks in order; over both: all
got = M.all_gather_rows(mesh, ("model",), x)
assert got[:, 0].tolist() == [float(di * m + j) for j in range(m) for _ in range(2)]
got = M.all_gather_rows(mesh, ("data",), x)
assert got[:, 0].tolist() == [float(i * m + mi) for i in range(d) for _ in range(2)]
got = M.all_gather_rows(mesh, ("data", "model"), x)
assert got[:, 0].tolist() == [float(r) for r in range(d * m) for _ in range(2)]
# reduce-scatter: the sum, this rank's chunk of it
y = torch.arange(4.0 * m, device=on).reshape(2 * m, 2) * (rank + 1)
got = M.reduce_scatter_rows(mesh, ("model",), y)
scale = sum(di * m + j + 1 for j in range(m))
want = (torch.arange(4.0 * m, device=on).reshape(2 * m, 2) * scale)[2 * mi:2 * mi + 2]
assert torch.equal(got, want), (got, want)
assert float(M.all_reduce_sum(mesh, ("data", "model"), torch.ones(1))) == d * m
assert M.all_reduce_max(mesh, rank) == d * m - 1
# the launch-wide agreements: over every rank, on the mesh or the world
world = M.world_mesh()
assert world.size == d * m and world.rank == rank and world.backend == backend
for over in (mesh, world):
    assert M.broadcast_int(over, 100 + rank) == 100
    assert M.all_reduce_min(over, rank + 5) == 5
    got = M.broadcast_rows(over, torch.full((2, 2), 7.0 if rank == 0 else float(rank)))
    assert (got == 7.0).all(), got
    M.barrier(over)
# host_local_batch: each rank's rows come back as its shard
batch = distributed.host_local_batch(mesh, "data", {"x": np.full((3, 2), rank)})
assert batch["x"].shape == (3, 2) and int(batch["x"][0, 0]) == rank
full = np.arange(4.0 * d).reshape(2 * d, 2)
assert np.array_equal(M.put_global(mesh, full).cpu().numpy(), full[2 * di:2 * di + 2])
assert np.array_equal(M.fetch_global(mesh, M.put_global(mesh, full)), full)
rows = 2 * d - 1  # zero-padded to 2 * d, then this rank's 2 rows
per = -(-rows // d)
shard = M.shard_rows(mesh, np.ones((rows, 2)))
assert shard.shape == (per, 2)
assert float(shard.sum()) == 2.0 * min(per, rows - di * per)
try:
    distributed.build_mesh([d * m + 1, 1], ("data", "model"), device=device)
except ValueError as exc:
    assert "needs" in str(exc)
else:
    raise AssertionError("an oversized mesh built")
if d * m > 1:
    try:
        distributed.build_mesh([1, 1], ("data", "model"), device=device)
    except ValueError as exc:
        assert "every rank trains" in str(exc)
    else:
        raise AssertionError("a mesh leaving ranks out built")
# all_to_all over model (tiled): rank j's chunk i goes to rank i, concatenated in
# axis order; its gradient is the all-to-all back
x = (torch.arange(2.0 * m, device=on).reshape(m, 2) + 100 * mi).requires_grad_()
got = M.all_to_all(mesh, "model", x, split_axis=0, concat_axis=1)
want = torch.tensor([[100.0 * j + 2 * mi, 100.0 * j + 2 * mi + 1] for j in range(m)],
                    device=on).reshape(1, 2 * m)
assert torch.equal(got, want), (got, want)
(got * got.detach()).sum().backward()
assert torch.equal(x.grad, x.detach()), x.grad
# ppermute: the ring shift j -> j + 1 over model; its gradient shifts back
x = torch.full((3,), float(mi), device=on, requires_grad=True)
got = M.ppermute(mesh, "model", x)
assert torch.equal(got, torch.full((3,), float((mi - 1) % m), device=on)), got
(got * got.detach()).sum().backward()
assert torch.equal(x.grad, x.detach()), x.grad
# the mask's all_gather along a dim, bool in and out
mask = torch.tensor([[True, bool(mi % 2)]], device=on)
got = M.all_gather(mesh, "model", mask, dim=1)
assert got.dtype == torch.bool, got
assert got.tolist() == [sum(([True, bool(j % 2)] for j in range(m)), [])], got
calls = M.collective_counts()  # only collectives that crossed ranks count
assert calls and all(k.startswith(backend + ":") for k in calls), calls
staged = calls.get("gloo:staged_ppermute", 0)  # gloo's sends take host tensors only
assert staged == (1 + 1 if backend == "gloo" and on.type == "cuda" and m > 1 else 0), calls
assert calls.get(backend + ":reduce_scatter", 0) == (1 if m > 1 else 0), calls
assert calls[backend + ":broadcast"] == 4, calls
distributed.shutdown_distributed()
print("OK", flush=True)
"""


@pytest.mark.parametrize("d,m", [(2, 1), (1, 2), (2, 2)])
def test_collectives_across_processes(d, m):
    """The mesh's subgroups and collectives in ``d * m`` gloo processes:
    gathers in mesh order, reduce-scatter chunks, sums, broadcasts,
    ``host_local_batch``, ``put_global`` / ``fetch_global`` and the
    refused shapes."""
    run_workers(_COLLECTIVES, n=d * m, args=(d, m))


_ALS_WORKER = """
import sys
import numpy as np
from predictionio_tpu_torch.parallel.distributed import init_distributed, build_mesh
from predictionio_tpu_torch.parallel.als import ALSConfig, als_fit, build_als_data

assert init_distributed(device="cpu")
mesh = build_mesh([2, 1], ("data", "model"), device="cpu")
# every process loads the same "event store"; als_fit slices its shard
rng = np.random.default_rng(11)
uu = rng.integers(0, 60, size=900)
ii = rng.integers(0, 25, size=900)
rr = rng.integers(1, 6, size=900).astype(np.float32)
cfg = ALSConfig(rank=4, iterations=4, reg=0.05, seed=2)
data = build_als_data(uu, ii, rr, 60, 25, cfg, num_shards=2)
model = als_fit(data, cfg, mesh=mesh)
np.savez(sys.argv[1] + f"-{mesh.rank}.npz", users=model.user_factors, items=model.item_factors)
print("OK", flush=True)
"""


def test_two_process_als_matches_single_process(tmp_path):
    """The data-sharded fit across TWO processes (one rank each, a 2 x 1
    mesh): each rank solves its row shard of each half-step and an
    all-gather over ``data`` rebuilds the table; both ranks return the
    same factors, equal to JAX's fit on a 2 x 1 mesh of virtual devices
    and to the port's one-process fit within 1e-4."""
    from predictionio_tpu.parallel.als import ALSConfig as JaxConfig
    from predictionio_tpu.parallel.als import als_fit as jax_fit
    from predictionio_tpu.parallel.als import build_als_data as jax_build
    from predictionio_tpu_torch.parallel.als import ALSConfig, als_fit, build_als_data

    out = str(tmp_path / "factors")
    run_workers(_ALS_WORKER, n=2, args=(out,))
    rng = np.random.default_rng(11)
    uu = rng.integers(0, 60, size=900)
    ii = rng.integers(0, 25, size=900)
    rr = rng.integers(1, 6, size=900).astype(np.float32)
    kw = dict(rank=4, iterations=4, reg=0.05, seed=2)
    ref = jax_fit(jax_build(uu, ii, rr, 60, 25, JaxConfig(**kw), num_shards=2),
                  JaxConfig(**kw), jax_mesh.local_mesh(2, 1))
    one = als_fit(build_als_data(uu, ii, rr, 60, 25, ALSConfig(**kw), num_shards=2),
                  ALSConfig(**kw), "cpu")
    got = [np.load(f"{out}-{r}.npz") for r in range(2)]
    for g in got:
        np.testing.assert_array_equal(g["users"], got[0]["users"])
        np.testing.assert_array_equal(g["items"], got[0]["items"])
    np.testing.assert_allclose(got[0]["users"], ref.user_factors, atol=1e-4)
    np.testing.assert_allclose(got[0]["items"], ref.item_factors, atol=1e-4)
    np.testing.assert_allclose(got[0]["users"], one.user_factors, atol=1e-5)
    np.testing.assert_allclose(got[0]["items"], one.item_factors, atol=1e-5)


_ALS_CARD_WORKER = """
import sys
import numpy as np
from predictionio_tpu_torch.ops import als_gram
from predictionio_tpu_torch.parallel import mesh as M
from predictionio_tpu_torch.parallel.als import ALSConfig, als_fit, build_als_data
from predictionio_tpu_torch.parallel.distributed import build_mesh, init_distributed

out, d, m = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
assert init_distributed(device="cuda")
mesh = build_mesh([d, m], ("data", "model"))
rng = np.random.default_rng(5)
uu, ii = rng.integers(0, 5000, 200_000), rng.integers(0, 1200, 200_000)
rr = rng.integers(1, 6, 200_000).astype(np.float32)
cfg = ALSConfig(rank=32, iterations=4, reg=0.05, seed=2, solver="pallas",
                factor_sharding="model" if m > 1 else "replicated")
data = build_als_data(uu, ii, rr, 5000, 1200, cfg, num_shards=d, model_shards=m)
als_gram.gram_rhs.launches = 0
model = als_fit(data, cfg, mesh=mesh)
assert als_gram.gram_rhs.launches == 2 * cfg.iterations, als_gram.gram_rhs.launches
calls = M.collective_counts()
assert calls and all(k.startswith("nccl:") for k in calls), calls
# two a half-step over ``model``: the partial Grams and the partial rhs
assert calls.get("nccl:reduce_scatter", 0) == (4 * cfg.iterations if m > 1 else 0), calls
np.savez(out + f"-{mesh.rank}.npz", users=model.user_factors, items=model.item_factors)
print("OK", flush=True)
"""


_MODELS_CARD_WORKER = """
import sys
import numpy as np
from predictionio_tpu_torch.models.ncf.model import NCFConfig, train_ncf
from predictionio_tpu_torch.models.sequence.model import SASRecConfig, train_sasrec
from predictionio_tpu_torch.ops import flash_attention as fa
from predictionio_tpu_torch.parallel import mesh as M
from predictionio_tpu_torch.parallel.distributed import build_mesh, init_distributed

out, d, s = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
assert init_distributed(device="cuda")
seqs, ncf_data, seq_kw, ncf_kw = card_models_inputs()
mesh = build_mesh([d, s], ("data", "seq"))
fa.flash_forward.launches = fa.flash_backward.launches = 0
seq_state, seq_losses = train_sasrec(SASRecConfig(**seq_kw), seqs, log_every=1, mesh=mesh)
steps = len(seq_losses)
# Ulysses' local attention is B4 and the fused backward, at H / s heads
assert fa.flash_forward.launches == fa.flash_backward.launches == steps, \\
    (fa.flash_forward.launches, fa.flash_backward.launches)
ncf_mesh = build_mesh([d, s], ("data", "model"))
ncf_state, ncf_losses = train_ncf(NCFConfig(**ncf_kw), *ncf_data, log_every=1, mesh=ncf_mesh)
calls = M.collective_counts()
assert calls and all(k.startswith("nccl:") for k in calls), calls
assert calls["nccl:all_to_all"] == 8 * steps and calls["nccl:reduce_scatter"] > 0, calls
np.savez(out + f"-{mesh.rank}.npz", seq_losses=np.asarray(seq_losses),
         ncf_losses=np.asarray(ncf_losses),
         **{"seq." + k: v.numpy() for k, v in seq_state.items()},
         **{"ncf." + k: v.numpy() for k, v in ncf_state.items()})
print("OK", flush=True)
"""


def card_models_inputs():
    """The card test's SASRec sequences and NCF examples, from fixed
    seeds, and their configs (one block of two heads: Ulysses over a
    2-way ``seq`` axis puts one head on a rank)."""
    rng = np.random.default_rng(9)
    seqs = np.zeros((128, 32), np.int64)
    for row in seqs:
        length = rng.integers(2, 33)
        row[:length] = rng.integers(1, 201, size=length)
    users, items = rng.integers(0, 500, 6000), rng.integers(0, 300, 6000)
    labels = rng.integers(1, 6, 6000).astype(np.float32)
    seq_kw = dict(num_items=200, max_len=32, embed_dim=32, num_heads=2, num_blocks=1,
                  ffn_dim=64, batch_size=64, epochs=1, seed=4, seq_parallel="ulysses")
    ncf_kw = dict(num_users=500, num_items=300, embed_dim=16, hidden=(32, 16),
                  batch_size=2048, epochs=1, seed=4)
    return seqs, (users, items, labels), seq_kw, ncf_kw


@pytest.mark.cuda
def test_nccl_collectives_and_fit_across_cards(tmp_path):
    """On two or more cards, a rank a card, so the backend is NCCL: the
    collectives of the gloo test above give the same answers (host
    tensors lifted onto the card for the call and back, the launch-wide
    agreements, ``all_to_all`` and ``ppermute`` included), and a fit over
    a 2 x 2 mesh (1 x 2 on two or three cards) through B1 on every card,
    model-sharded where the mesh has a model axis, equals the
    one-process fit of the same packing on one card within 1e-4 on every
    rank. On the same mesh shape, SASRec's Ulysses steps (``("data",
    "seq")``, B4 and the fused backward on every card) and NCF's steps
    (``("data", "model")``) equal one card's within 1e-4: losses and
    params."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from predictionio_tpu_torch import _kernels
    from predictionio_tpu_torch.parallel.als import ALSConfig, als_fit, build_als_data

    _kernels.build_all()  # once, before the ranks load the libraries
    d, m = (2, 2) if torch.cuda.device_count() >= 4 else (1, 2)
    run_workers(_COLLECTIVES, n=d * m, args=(d, m, "cuda"), timeout=300)
    out = str(tmp_path / "factors")
    run_workers(_ALS_CARD_WORKER, n=d * m, args=(out, d, m), timeout=300)
    rng = np.random.default_rng(5)
    uu, ii = rng.integers(0, 5000, 200_000), rng.integers(0, 1200, 200_000)
    rr = rng.integers(1, 6, 200_000).astype(np.float32)
    cfg = ALSConfig(rank=32, iterations=4, reg=0.05, seed=2, solver="pallas")
    one = als_fit(build_als_data(uu, ii, rr, 5000, 1200, cfg, num_shards=d, model_shards=m),
                  cfg, "cuda")
    for rank in range(d * m):
        got = np.load(f"{out}-{rank}.npz")
        np.testing.assert_allclose(got["users"], one.user_factors, atol=1e-4)
        np.testing.assert_allclose(got["items"], one.item_factors, atol=1e-4)
    from predictionio_tpu_torch.models.ncf.model import NCFConfig, train_ncf
    from predictionio_tpu_torch.models.sequence.model import SASRecConfig, train_sasrec

    models = str(tmp_path / "models")
    # the workers import no test module (JAX stays out of them): the inputs' source
    source = "import numpy as np\n" + inspect.getsource(card_models_inputs) + _MODELS_CARD_WORKER
    run_workers(source, n=d * m, args=(models, d, m), timeout=300)
    seqs, ncf_data, seq_kw, ncf_kw = card_models_inputs()
    seq_state, seq_losses = train_sasrec(SASRecConfig(**seq_kw), seqs, "cuda", log_every=1)
    ncf_state, ncf_losses = train_ncf(NCFConfig(**ncf_kw), *ncf_data, "cuda", log_every=1)
    for rank in range(d * m):
        got = np.load(f"{models}-{rank}.npz")
        np.testing.assert_allclose(got["seq_losses"], seq_losses, atol=1e-4)
        np.testing.assert_allclose(got["ncf_losses"], ncf_losses, atol=1e-4)
        for prefix, state in (("seq.", seq_state), ("ncf.", ncf_state)):
            for name, want in state.items():
                np.testing.assert_allclose(got[prefix + name], want.numpy(), atol=1e-4,
                                           err_msg=prefix + name)
