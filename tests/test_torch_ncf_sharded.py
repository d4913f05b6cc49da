"""The port's sharded NCF training across gloo processes against the JAX
package's on meshes of virtual CPU devices.

``param_shardings`` lays a ``NeuMF`` state dict out as the reference's rule
lays the flax tree (an embedding's dim, a dense kernel's ``out`` rows, the
``[*, 1]`` head replicated), and ``shard_state`` / ``unshard_state`` cut
and rebuild it. Each training case launches ``d * m`` workers of the port
(``run_workers``); every rank starts from the JAX package's own initial
weights and trains the reference's clique data (32 users x 16 items) for
two epochs of 64-example batches on a ``(data, model)`` mesh: the batch
over ``data`` (the short last batch cut to a multiple of it), the
params and Adam's moments over ``model``. The step losses agree with
JAX's ``train_ncf`` on ``local_mesh(d, m)`` within ``rtol=1e-5,
atol=1e-4`` and the final params within 1e-4 (the one-process bar of
``tests/test_torch_ncf_train.py``), every rank returning the same full
params. Two processes on a ``[1, 2]`` mesh, where only rank 0 holds the
checkpoint manager, resume a 3-epoch checkpointed run to 5 epochs and
equal the uninterrupted 5-epoch run.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from predictionio_tpu.models.ncf.model import NCFConfig as JaxNCFConfig
from predictionio_tpu.models.ncf.model import NeuMF as JaxNeuMF
from predictionio_tpu.models.ncf.model import make_implicit_batches as jax_implicit_batches
from predictionio_tpu.models.ncf.model import param_shardings as jax_param_shardings
from predictionio_tpu.models.ncf.model import train_ncf as jax_train_ncf
from predictionio_tpu.parallel.mesh import local_mesh
from predictionio_tpu_torch.models.ncf.model import (
    init_model,
    NCFConfig,
    param_shardings,
    params_from_flax,
    shard_state,
    unshard_state,
)
from predictionio_tpu_torch.parallel.mesh import Mesh
from test_torch_distributed import run_workers

KW = dict(num_users=32, num_items=16, embed_dim=8, hidden=(16, 8), epochs=2, batch_size=64,
          learning_rate=0.02, seed=1)


def clique_data():
    """The reference's ``tests/test_ncf.py`` clique ratings: even users
    rate the first half of the items 5 and the rest 1, odd users the
    other way round, each pair kept with probability 0.6."""
    rng = np.random.default_rng(0)
    users, items, labels = [], [], []
    for u in range(32):
        for i in range(16):
            if rng.random() < 0.6:
                users.append(u)
                items.append(i)
                labels.append(5.0 if (i < 8) == (u % 2 == 0) else 1.0)
    return np.array(users, np.int32), np.array(items, np.int32), np.array(labels, np.float32)


def flax_init(kw):
    config = JaxNCFConfig(**kw)
    params = JaxNeuMF(config).init(
        jax.random.PRNGKey(config.seed), jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32)
    )["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def one_rank_mesh(d: int, m: int, di: int = 0, mi: int = 0) -> Mesh:
    """A mesh's shape and coordinates without a process group (what
    ``param_shardings`` and ``shard_state`` read)."""
    return Mesh(("data", "model"), (d, m), (di, mi), torch.device("cpu"))


@pytest.mark.parametrize("d,m", [(2, 2), (1, 4), (4, 1), (1, 8)])
def test_param_shardings_follow_the_reference(d, m):
    flax = flax_init(dict(KW, hidden=(16, 12)))
    want = jax_param_shardings(local_mesh(d, m), flax)
    state = params_from_flax(flax)
    got = param_shardings(one_rank_mesh(d, m), state)
    for layer, leaves in want.items():
        for leaf, sharding in leaves.items():
            name = f"{layer}.{'bias' if leaf == 'bias' else 'weight'}"
            # an embedding keeps flax's layout; a Linear.weight is the kernel transposed
            dim = {"embedding": 1, "kernel": 0}.get(leaf)
            assert got[name] == (dim if sharding.spec == P(None, "model") else None), name
    for coords in ((0, i) for i in range(m)):
        local = shard_state(state, one_rank_mesh(d, m, *coords))
        for name, t in local.items():
            if got[name] is None:
                assert torch.equal(t, state[name])
            else:
                per = state[name].shape[got[name]] // m
                assert torch.equal(t, state[name].narrow(got[name], coords[1] * per, per))
    # one process: the gather is the identity, so a 1 x 1 layout rebuilds itself
    single = one_rank_mesh(1, 1)
    back = unshard_state(shard_state(state, single), single, param_shardings(single, state))
    assert all(torch.equal(back[n], state[n]) for n in state)


_TRAIN = """
import json, sys
import numpy as np
import torch
from predictionio_tpu_torch.models.ncf.model import NCFConfig, train_ncf
from predictionio_tpu_torch.parallel import distributed, mesh as M

d, m, kw, inputs, out = (int(sys.argv[1]), int(sys.argv[2]), json.loads(sys.argv[3]),
                         sys.argv[4], sys.argv[5])
assert distributed.init_distributed(device="cpu")
mesh = distributed.build_mesh([d, m], ("data", "model"), device="cpu")
arrays = np.load(inputs)
init = {k[5:]: torch.from_numpy(arrays[k]) for k in arrays.files if k.startswith("init.")}
state, losses = train_ncf(NCFConfig(**kw), arrays["users"], arrays["items"], arrays["labels"],
                          "cpu", log_every=1, init_state=init, mesh=mesh)
np.savez(f"{out}-{mesh.rank}.npz", losses=np.asarray(losses),
         calls=json.dumps(M.collective_counts()), **{k: v.numpy() for k, v in state.items()})
distributed.shutdown_distributed()
print("OK", flush=True)
"""


@pytest.mark.parametrize("d,m,implicit", [(2, 2, False), (2, 1, True), (1, 2, False)])
def test_sharded_train_ncf_matches_jax(tmp_path, d, m, implicit):
    kw = dict(KW, implicit=implicit)
    users, items, labels = clique_data()
    if implicit:
        users, items, labels = jax_implicit_batches(users, items, 16, 4,
                                                    np.random.default_rng(1))
    init = params_from_flax(flax_init(kw))
    path = str(tmp_path / "inputs.npz")
    np.savez(path, users=users, items=items, labels=labels,
             **{f"init.{k}": v.numpy() for k, v in init.items()})
    out = str(tmp_path / "ncf")
    run_workers(_TRAIN, n=d * m, args=(d, m, json.dumps(kw), path, out))
    got = [np.load(f"{out}-{r}.npz") for r in range(d * m)]
    jax_params, jax_losses = jax_train_ncf(JaxNCFConfig(**kw), users, items, labels,
                                           local_mesh(d, m), log_every=1)
    assert len(jax_losses) == 2 * -(-users.size // 64)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jax_params))
    for g in got:
        np.testing.assert_allclose(g["losses"], jax_losses, rtol=1e-5, atol=1e-4)
        for name in want:
            np.testing.assert_array_equal(g[name], got[0][name])
            np.testing.assert_allclose(g[name], want[name].numpy(), atol=1e-4, err_msg=name)
        calls = json.loads(str(g["calls"]))
        # a model axis gathers the four tables' rows and the two hidden weights a step
        gathers = calls.get("gloo:all_gather", 0)
        assert (gathers >= 6 * len(jax_losses)) == (m > 1), calls
        assert calls.get("gloo:reduce_scatter", 0) == (6 * len(jax_losses) if m > 1 else 0)


_RESUME = """
import sys
import numpy as np
from predictionio_tpu_torch.models.ncf.model import NCFConfig, train_ncf
from predictionio_tpu_torch.parallel import distributed
from predictionio_tpu_torch.workflow.checkpoint import CheckpointManager

ckpt_dir, out = sys.argv[1], sys.argv[2]
assert distributed.init_distributed(device="cpu")
mesh = distributed.build_mesh([1, 2], ("data", "model"), device="cpu")
rng = np.random.default_rng(3)
users, items = rng.integers(0, 30, 700), rng.integers(0, 20, 700)
labels = rng.integers(1, 6, 700).astype(np.float32)
kw = dict(num_users=30, num_items=20, embed_dim=8, hidden=(16, 8), batch_size=64,
          learning_rate=0.02, seed=2)
straight, _ = train_ncf(NCFConfig(epochs=5, **kw), users, items, labels, "cpu", mesh=mesh)
# rank 0 alone holds the manager; the other joins every gather
manager = lambda: CheckpointManager(ckpt_dir) if mesh.rank == 0 else None
train_ncf(NCFConfig(epochs=3, **kw), users, items, labels, "cpu", checkpoint=manager(),
          mesh=mesh)
ckpt = manager()
assert ckpt is None or ckpt.latest_step() == 2
resumed, _ = train_ncf(NCFConfig(epochs=5, **kw), users, items, labels, "cpu",
                       checkpoint=ckpt, mesh=mesh)
assert ckpt is None or ckpt.latest_step() == 4
for name in straight:
    np.testing.assert_array_equal(resumed[name].numpy(), straight[name].numpy())
np.savez(f"{out}-{mesh.rank}.npz", **{k: v.numpy() for k, v in resumed.items()})
distributed.shutdown_distributed()
print("OK", flush=True)
"""


def test_two_process_resume_equals_the_uninterrupted_run(tmp_path):
    out = str(tmp_path / "resumed")
    run_workers(_RESUME, n=2, args=(str(tmp_path / "ncf"), out))
    a, b = (np.load(f"{out}-{r}.npz") for r in range(2))
    for name in a.files:
        np.testing.assert_array_equal(a[name], b[name])
    assert set(a.files) == set(init_model(NCFConfig(num_users=30, num_items=20, embed_dim=8,
                                                    hidden=(16, 8))).state_dict())
