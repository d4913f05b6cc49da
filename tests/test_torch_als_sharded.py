"""The port's sharded ALS fits across gloo processes against the JAX
package's fits on a mesh of virtual CPU devices.

Each case launches ``d * m`` workers of the port (``run_workers``: the
launch contract's env, a timeout that kills every worker); each joins a
``d x m`` mesh and fits the same data (60 users, 25 items, rank 4, 4
iterations) packed with ``build_als_data(num_shards=d, model_shards=m)``
-- arrays equal to the JAX package's packing, checked here too -- with
``factor_sharding`` "replicated" (data-sharded rows, a gather over
``data``) or "model" (ALX: each rank a model slice of the tables, B1's
plain version on the local slice and a reduce-scatter over ``model``,
or the "xla" path's gather reduce-scattered); the streamed fit reads
each rank's rows of every block of a block store built for the mesh.
Every rank returns the same factors, held to JAX's ``als_fit`` /
``als_fit_streamed`` on ``local_mesh(d, m)`` of the conftest's eight
virtual devices within 1e-4 for f32 factors (5e-3 for bf16, whose
stored factors round once per iteration): the port's one-process bar
(``tests/test_torch_als.py``). The reference's own two-process test
allows 2e-2; the sharded sums here (the model axis's partial Grams) add
rounding of the order of 1e-6 to the one-process gap. Implicit cases
take unit values, as the one-process implicit parity tests do.

A fit where rank 0 alone checkpoints (a callback on one rank) gathers
on every rank and does not hang, and its iterates equal the reference's
callback's.
"""

import numpy as np
import pytest

from predictionio_tpu.parallel import als as jax_als
from predictionio_tpu.parallel import stream as jax_stream
from predictionio_tpu.parallel.mesh import local_mesh
from predictionio_tpu.parallel.reader import array_coo_chunks as jax_chunks
from predictionio_tpu_torch.parallel import als
from predictionio_tpu_torch.parallel.reader import array_coo_chunks
from predictionio_tpu_torch.parallel.stream import build_streamed_als_data
from test_torch_distributed import run_workers

N_USERS, N_ITEMS, EDGES = 60, 25, 900
ATOL = {"float32": 1e-4, "bfloat16": 5e-3}


def coo(implicit: bool):
    rng = np.random.default_rng(11)
    uu = rng.integers(0, N_USERS, size=EDGES)
    ii = rng.integers(0, N_ITEMS, size=EDGES)
    rr = rng.integers(1, 6, size=EDGES).astype(np.float32)
    return uu, ii, (np.ones_like(rr) if implicit else rr)


def config_kw(m: int, solver: str, implicit: bool, dtype: str = "float32",
              buckets: int = 1) -> dict:
    return dict(rank=4, iterations=4, reg=0.05, seed=2, implicit=implicit, alpha=2.0,
                solver=solver, dtype=dtype, buckets=buckets,
                factor_sharding="model" if m > 1 else "replicated")


_FIT = """
import json, sys
import numpy as np
from predictionio_tpu_torch.parallel.distributed import build_mesh, init_distributed
from predictionio_tpu_torch.parallel import als
from predictionio_tpu_torch.parallel.stream import load_streamed_als_data

d, m, out, kw, implicit, store = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                  json.loads(sys.argv[4]), sys.argv[5] == "1", sys.argv[6])
assert init_distributed(device="cpu")
mesh = build_mesh([d, m], ("data", "model"), device="cpu")
rng = np.random.default_rng(11)
uu = rng.integers(0, 60, size=900)
ii = rng.integers(0, 25, size=900)
rr = rng.integers(1, 6, size=900).astype(np.float32)
vals = np.ones_like(rr) if implicit else rr
cfg = als.ALSConfig(**kw)
seen = []
# rank 0 alone checkpoints: the others must still join its gathers
callback = (lambda it, u, i: seen.append((it, u, i))) if mesh.rank == 0 else None
if store == "-":
    data = als.build_als_data(uu, ii, vals, 60, 25, cfg, num_shards=d, model_shards=m)
    model = als.als_fit(data, cfg, mesh=mesh, callback=callback, callback_interval=2)
else:
    model = als.als_fit_streamed(load_streamed_als_data(store), cfg, mesh=mesh,
                                 callback=callback, callback_interval=2)
extra = {}
if seen:
    extra = {"cb_it": np.array([seen[0][0]]), "cb_users": seen[0][1], "cb_items": seen[0][2]}
np.savez(f"{out}-{mesh.rank}.npz", users=model.user_factors, items=model.item_factors, **extra)
print("OK", flush=True)
"""


def jax_fit(d, m, kw, implicit, streamed_dir=None):
    """JAX's fit on ``local_mesh(d, m)`` and its callback's first iterate."""
    uu, ii, vals = coo(implicit)
    cfg = jax_als.ALSConfig(**kw)
    seen = []
    callback = lambda it, u, i: seen.append((it, u, i))
    if streamed_dir is None:
        data = jax_als.build_als_data(uu, ii, vals, N_USERS, N_ITEMS, cfg,
                                      num_shards=d, model_shards=m)
        model = jax_als.als_fit(data, cfg, local_mesh(d, m), callback=callback,
                                callback_interval=2)
    else:
        store = jax_stream.build_streamed_als_data(
            jax_chunks(uu, ii, vals), N_USERS, N_ITEMS, cfg, streamed_dir,
            num_shards=d, model_shards=m, block_rows=8 * d * m)
        model = jax_als.als_fit_streamed(store, cfg, local_mesh(d, m), callback=callback,
                                         callback_interval=2)
    return model, seen[0]


def run_case(tmp_path, d, m, kw, implicit, store="-"):
    import json

    out = str(tmp_path / "fit")
    run_workers(_FIT, n=d * m, args=(d, m, out, json.dumps(kw), int(implicit), store))
    got = [np.load(f"{out}-{r}.npz") for r in range(d * m)]
    for g in got[1:]:  # every rank returns the whole model
        np.testing.assert_array_equal(g["users"], got[0]["users"])
        np.testing.assert_array_equal(g["items"], got[0]["items"])
        assert "cb_it" not in g
    return got[0]


def assert_close(got, ref, seen, atol):
    np.testing.assert_allclose(got["users"], ref.user_factors, atol=atol)
    np.testing.assert_allclose(got["items"], ref.item_factors, atol=atol)
    assert int(got["cb_it"][0]) == seen[0] == 1
    np.testing.assert_allclose(got["cb_users"], seen[1], atol=atol)
    np.testing.assert_allclose(got["cb_items"], seen[2], atol=atol)


RESIDENT = [
    # (d, m, solver, implicit, dtype, buckets)
    (2, 1, "pallas", False, "float32", 1),
    (2, 1, "xla", True, "float32", 1),
    (2, 1, "pallas", False, "float32", 3),
    (1, 2, "pallas", False, "float32", 1),
    (1, 2, "pallas", True, "float32", 1),
    (1, 2, "xla", False, "float32", 1),
    (1, 2, "xla", True, "float32", 1),
    (1, 2, "pallas", False, "bfloat16", 1),
    (2, 2, "pallas", False, "float32", 1),
    (2, 2, "xla", True, "float32", 3),
]


@pytest.mark.parametrize("d,m,solver,implicit,dtype,buckets", RESIDENT)
def test_sharded_fit_matches_jax(tmp_path, d, m, solver, implicit, dtype, buckets):
    """``als_fit`` over a ``d x m`` mesh of gloo processes equals JAX's
    ``als_fit`` on ``local_mesh(d, m)``: model-sharded whenever ``m`` > 1,
    through B1's plain version ("pallas") or the unfused path ("xla")."""
    kw = config_kw(m, solver, implicit, dtype, buckets)
    got = run_case(tmp_path, d, m, kw, implicit)
    ref, seen = jax_fit(d, m, kw, implicit)
    assert_close(got, ref, seen, ATOL[dtype])


STREAMED = [
    (2, 1, "pallas", False),
    (1, 2, "pallas", False),
    (1, 2, "xla", True),
    (2, 2, "pallas", True),
]


@pytest.mark.parametrize("d,m,solver,implicit", STREAMED)
def test_sharded_streamed_fit_matches_jax(tmp_path, d, m, solver, implicit):
    """``als_fit_streamed`` over the mesh, each rank reading its data
    shard's rows of every block of one store (built by the port for the
    mesh, several blocks a side), equals JAX's ``als_fit_streamed`` over
    its store on ``local_mesh(d, m)``."""
    kw = config_kw(m, solver, implicit)
    uu, ii, vals = coo(implicit)
    store = build_streamed_als_data(array_coo_chunks(uu, ii, vals), N_USERS, N_ITEMS,
                                    als.ALSConfig(**kw), str(tmp_path / "store"),
                                    num_shards=d, model_shards=m, block_rows=8 * d * m)
    assert len(store.by_row.specs) + len(store.by_col.specs) > 2
    got = run_case(tmp_path, d, m, kw, implicit, store=store.directory)
    ref, seen = jax_fit(d, m, kw, implicit, streamed_dir=str(tmp_path / "jax_store"))
    assert_close(got, ref, seen, ATOL["float32"])


@pytest.mark.parametrize("d,m,buckets", [(2, 1, 1), (1, 2, 1), (2, 2, 1), (2, 2, 3), (4, 2, 2)])
def test_packing_equals_the_reference(d, m, buckets):
    """``build_als_data(num_shards=d, model_shards=m)``: every array equal
    to the JAX package's."""
    uu, ii, rr = coo(False)
    kw = config_kw(m, "pallas", False, buckets=buckets)
    got = als.build_als_data(uu, ii, rr, N_USERS, N_ITEMS, als.ALSConfig(**kw),
                             num_shards=d, model_shards=m)
    want = jax_als.build_als_data(uu, ii, rr, N_USERS, N_ITEMS, jax_als.ALSConfig(**kw),
                                  num_shards=d, model_shards=m)
    for side in ("by_row", "by_col"):
        g, w = getattr(got, side), getattr(want, side)
        np.testing.assert_array_equal(g.slot_of, w.slot_of)
        assert g.total_slots == w.total_slots and len(g.blocks) == len(w.blocks)
        for gb, wb in zip(g.blocks, w.blocks):
            assert gb.indices.shape[0] % (8 * d * m) == 0
            for name in ("indices", "values", "mask"):
                np.testing.assert_array_equal(getattr(gb, name), getattr(wb, name))


def test_sharded_fit_refuses_a_packing_the_mesh_cannot_split():
    """One process's mesh is 1 x 1, so the checks run through a forged
    3 x 2 sharding of 64-row blocks: the reference's divisibility
    messages."""
    uu, ii, rr = coo(False)
    data = als.build_als_data(uu, ii, rr, N_USERS, N_ITEMS, als.ALSConfig(rank=4))
    sharding = als._Sharding(None, "model")
    sharding.d, sharding.m = 3, 2
    with pytest.raises(ValueError, match="divisible by data\\*model = 3\\*2"):
        sharding.check(data.by_row, "user", [b.indices.shape[0] for b in data.by_row.blocks])
    sharding = als._Sharding(None, "replicated")
    sharding.d = 3
    with pytest.raises(ValueError, match="3-way data axis"):
        sharding.check(data.by_row, "user", [64])
