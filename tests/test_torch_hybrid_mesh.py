"""Hybrid meshes (``dcn_mesh_shape``) of the port against the JAX package's.

``parallel/distributed.py::build_mesh`` lays a hybrid mesh's ranks out
as ``jax.experimental.mesh_utils.create_hybrid_device_mesh(ici, dcn,
process_is_granule=True)`` lays devices out, with the host as the
granule. Four checks:

- **Rank order.** ``hybrid_rank_grid`` equals JAX's grid over stand-in
  devices whose ``process_index`` is their rank's host, for contiguous
  and interleaved hosts.
- **Error texts.** Each bad shape raises the reference's own text, the
  reference's ``build_mesh`` run on the 8 virtual CPU devices and the
  port's checks on a launch of 8 ranks on one host.
- **Four gloo processes** under two host layouts (``h0 h0 h1 h1`` and
  ``h0 h1 h0 h1``, ``socket.gethostname`` patched in each worker): every
  mesh's grid is JAX's, the gathers, reduce-scatters and all-to-alls
  put rows and chunks in mesh order, and a model-sharded ALS fit on the
  non-row-major 2 x 2 grid ``[[0, 2], [1, 3]]`` lands within 1e-4 of the
  one-process fit (a process group numbers its members by rank, so a
  gather over both axes there comes back as ``0, 1, 2, 3`` unless the
  mesh reorders it).
- **The passthrough.** ``pio train ... -- --dcn-mesh-shape 2,1 ...``
  sets the runtime conf the reference's ``_parse_passthrough`` sets.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
from jax._src import mesh_utils

from predictionio_tpu.parallel import distributed as jax_distributed
from predictionio_tpu_torch.parallel import distributed
from test_torch_distributed import run_workers


def jax_grid(ici, dcn, hosts):
    """JAX's hybrid grid of one stand-in device per rank, the granule the
    rank's host (hosts numbered in order of first appearance), as ranks."""
    order = list(dict.fromkeys(hosts))
    fakes = [SimpleNamespace(id=r, process_index=order.index(h), platform="cpu",
                             device_kind="cpu") for r, h in enumerate(hosts)]
    grid = mesh_utils.create_hybrid_device_mesh(ici, dcn, devices=fakes,
                                                process_is_granule=True)
    return np.vectorize(lambda d: d.id)(grid)


PAIRS = "h0 h0 h1 h1 h2 h2 h3 h3".split()
RANK_ORDER_CASES = {
    "1x2/4x1": ([1, 2], [4, 1], PAIRS),
    "2x1/2x2": ([2, 1], [2, 2], PAIRS),
    "2x1/1x4": ([2, 1], [1, 4], PAIRS),
    "1x2/2x2": ([1, 2], [2, 2], PAIRS),
    "2x1/2x2-interleaved": ([2, 1], [2, 2], "a b c d a b c d".split()),
    "1x2/4x1-interleaved": ([1, 2], [4, 1], "a b c d d c b a".split()),
    "2x1/1x2-reversed": ([2, 1], [1, 2], "a b b a".split()),
    "4x1/2x1-interleaved": ([2, 1], [2, 1], "a b a b".split()),
}


@pytest.mark.parametrize("name", sorted(RANK_ORDER_CASES))
def test_rank_order_equals_jax(name):
    ici, dcn, hosts = RANK_ORDER_CASES[name]
    got = distributed.hybrid_rank_grid(ici, dcn, hosts)
    want = jax_grid(ici, dcn, hosts)
    assert got.shape == want.shape == tuple(i * d for i, d in zip(ici, dcn))
    np.testing.assert_array_equal(got, want)
    assert got.flat[0] == 0  # process 0 at position 0


#: (mesh_shape, dcn_mesh_shape) the reference refuses on 8 devices of one
#: process (tests/test_distributed.py:33-44, :94-104, and a slice count)
BAD_SHAPES = {
    "dcn-rank": ([4, 2], [1]),
    "oversubscribed": ([4, 2], [4, 1]),
    "undersubscribed": ([2, 1], [1, 1]),
    "not-dividing": ([-1, 1], [3, 1]),
    "slice-count": ([4, 1], [2, 1]),
}


@pytest.mark.parametrize("name", sorted(BAD_SHAPES))
def test_error_texts_equal_the_reference(name):
    shape, dcn = BAD_SHAPES[name]
    axes = ("data", "model")
    with pytest.raises(ValueError) as want:
        jax_distributed.build_mesh(shape, axes, dcn_mesh_shape=dcn)
    with pytest.raises(ValueError) as got:
        distributed.hybrid_layout(shape, axes, dcn, ["h"] * 8)
    assert str(got.value) == str(want.value)


def test_one_process_hybrid_mesh_and_uneven_hosts():
    """Without a group one host holds the one rank: an all-ones
    ``dcn_mesh_shape`` builds the 1 x 1 mesh, as the reference's
    ``[1, 1]`` does on one slice; a host whose ranks do not fill the
    per-host shape raises JAX's text."""
    mesh = distributed.build_mesh([-1, 1], ("data", "model"), dcn_mesh_shape=[1, 1],
                                  device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.grid.tolist() == [[0]]
    with pytest.raises(ValueError, match="different ranks"):
        distributed.build_mesh([1, 1], ("data", "model"), dcn_mesh_shape=[1], device="cpu")
    hosts = "a a a b".split()
    with pytest.raises(ValueError) as got:
        distributed.hybrid_rank_grid([2, 1], [2, 1], hosts)
    with pytest.raises(ValueError) as want:
        jax_grid([2, 1], [2, 1], hosts)
    assert str(got.value) == str(want.value)


_HYBRID_WORKER = """
import json
import os
import socket
import sys

import numpy as np
import torch

out, hosts, cases = sys.argv[1], sys.argv[2].split(","), json.loads(sys.argv[3])
rank = int(os.environ["PIO_PROCESS_ID"])
socket.gethostname = lambda: hosts[rank]  # this rank's host, as the test lays them out

from predictionio_tpu_torch.parallel import distributed, mesh as M
from predictionio_tpu_torch.parallel.als import ALSConfig, als_fit, build_als_data

assert distributed.init_distributed(device="cpu")
assert distributed.distributed_info()["hosts"] == hosts
axes = ("data", "model")
for case in cases:
    mesh = distributed.build_mesh(case["ici"], axes, dcn_mesh_shape=case["dcn"], device="cpu")
    want = np.array(case["grid"])
    assert mesh.grid.tolist() == want.tolist(), (mesh.grid, want)
    assert mesh.coords == tuple(int(c) for c in np.argwhere(want == rank)[0])
    x = torch.full((2, 3), float(rank))
    # every rank's rows in mesh order
    got = M.all_gather_rows(mesh, axes, x)
    assert got[::2, 0].tolist() == [float(r) for r in want.ravel()], got
    y = torch.arange(2.0 * want.size).reshape(want.size, 2) * (rank + 1)
    got = M.reduce_scatter_rows(mesh, axes, y)
    full = torch.arange(2.0 * want.size).reshape(want.size, 2) * float((want + 1).sum())
    assert torch.equal(got, full[mesh.rank:mesh.rank + 1]), (got, mesh.rank)
    for a, axis in enumerate(axes):
        index = list(mesh.coords)
        index[a] = slice(None)
        line = [int(r) for r in want[tuple(index)]]  # the axis through this rank
        n, me = len(line), mesh.axis_index(axis)
        got = M.all_gather_rows(mesh, (axis,), x)
        assert got[::2, 0].tolist() == [float(r) for r in line], (axis, got, line)
        y = torch.arange(2.0 * n).reshape(n, 2) * (rank + 1)
        got = M.reduce_scatter_rows(mesh, (axis,), y)
        full = torch.arange(2.0 * n).reshape(n, 2) * float(sum(r + 1 for r in line))
        assert torch.equal(got, full[me:me + 1]), (axis, got)
        if n > 1:
            # chunk j of position p goes to position j: position me gets
            # 100 * j + me from each position j, in axis order
            z = torch.tensor([[100.0 * me + j] for j in range(n)])
            got = M.all_to_all(mesh, axis, z, split_axis=0, concat_axis=1)
            assert got.tolist() == [[100.0 * j + me for j in range(n)]], (axis, got)
            got = M.ppermute(mesh, axis, torch.tensor([float(rank)]))
            assert got.tolist() == [float(line[(me - 1) % n])], (axis, got)
    if case.get("als"):
        rng = np.random.default_rng(13)
        uu, ii = rng.integers(0, 60, 900), rng.integers(0, 25, 900)
        rr = rng.integers(1, 6, 900).astype(np.float32)
        cfg = ALSConfig(rank=4, iterations=4, reg=0.05, seed=2, factor_sharding="model")
        d, m = mesh.axis_size("data"), mesh.axis_size("model")
        data = build_als_data(uu, ii, rr, 60, 25, cfg, num_shards=d, model_shards=m)
        model = als_fit(data, cfg, mesh=mesh)
        np.savez(f"{out}-{rank}.npz", users=model.user_factors, items=model.item_factors)
distributed.shutdown_distributed()
print("OK", flush=True)
"""

#: host layouts of the four-process launch: (hosts, [(ici, dcn)], the
#: case of the ALS fit); both ALS grids are [[0, 2], [1, 3]]
LAYOUTS = {
    "contiguous": ("h0 h0 h1 h1", [([2, 1], [1, 2]), ([1, 2], [2, 1]), ([2, 1], [2, 1])], 0),
    "interleaved": ("h0 h1 h0 h1", [([1, 2], [2, 1]), ([2, 1], [1, 2]), ([2, 1], [2, 1])], 0),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_four_processes_on_a_hybrid_grid(layout, tmp_path):
    """Four gloo ranks on two patched hosts: each case's grid is JAX's,
    the collectives follow it, and the model-sharded ALS fit on the
    non-row-major 2 x 2 grid equals the one-process fit within 1e-4."""
    from predictionio_tpu_torch.parallel.als import ALSConfig, als_fit, build_als_data

    hosts, shapes, als_case = LAYOUTS[layout]
    hosts = hosts.split()
    cases = [{"ici": ici, "dcn": dcn, "grid": jax_grid(ici, dcn, hosts).tolist(),
              "als": k == als_case} for k, (ici, dcn) in enumerate(shapes)]
    assert cases[als_case]["grid"] == [[0, 2], [1, 3]]
    out = str(tmp_path / "factors")
    run_workers(_HYBRID_WORKER, n=4, args=(out, ",".join(hosts), json.dumps(cases)))
    rng = np.random.default_rng(13)
    uu, ii = rng.integers(0, 60, 900), rng.integers(0, 25, 900)
    rr = rng.integers(1, 6, 900).astype(np.float32)
    cfg = ALSConfig(rank=4, iterations=4, reg=0.05, seed=2)
    one = als_fit(build_als_data(uu, ii, rr, 60, 25, cfg, num_shards=2, model_shards=2),
                  cfg, "cpu")
    for rank in range(4):
        got = np.load(f"{out}-{rank}.npz")
        np.testing.assert_allclose(got["users"], one.user_factors, atol=1e-4)
        np.testing.assert_allclose(got["items"], one.item_factors, atol=1e-4)


PASSTHROUGH = ["--mesh-shape", "2,4", "--dcn-mesh-shape", "2,1", "--mesh-axes", "data,seq",
               "--coordinator", "10.0.0.1:8476", "--num-processes", "2"]


def test_train_passthrough_equals_the_reference():
    """``pio train ... -- --mesh-shape 2,4 --dcn-mesh-shape 2,1 ...``: the
    tokens after ``--`` become the runtime conf the reference's
    ``_parse_passthrough`` makes of them (``tests/test_distributed.py:75-90``),
    and the train flags still win over them."""
    from predictionio_tpu.tools.engine_commands import _parse_passthrough as jax_parse
    from predictionio_tpu_torch.tools import cli

    want = jax_parse(PASSTHROUGH)
    assert cli._parse_passthrough(PASSTHROUGH) == want
    assert want["pio.dcn_mesh_shape"] == [2, 1] and want["pio.mesh_axes"] == ["data", "seq"]
    args = cli.build_parser().parse_args(["train", "--engine-dir", ".", "--process-id", "1",
                                          "--", *PASSTHROUGH, "--flag"])
    assert cli._launch_conf(args) == {**want, "pio.flag": "true", "pio.process_id": 1}
    args = cli.build_parser().parse_args(["train", "--engine-dir", "."])
    assert cli._launch_conf(args) == {}
