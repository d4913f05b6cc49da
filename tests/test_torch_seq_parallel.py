"""The port's sequence parallelism across gloo processes against the JAX
package's on meshes of virtual CPU devices.

Each case launches ``d * s`` workers of the port (``run_workers``: the
launch contract's env, a timeout that kills every worker); each joins a
``("data", "seq")`` mesh, cuts its ``(data, seq)`` block of the same
numpy-seeded inputs (rows over ``data``, time over ``seq``) and runs it:

- ring attention and Ulysses (``parallel/ring_attention.py``,
  ``parallel/ulysses.py``), causal and not, with a padding mask whose
  first key is always valid (no query row is fully masked, where the ring
  gives 0 and ``plain_attention`` the mean of V): the blocks put together
  equal JAX's ``ring_attention`` / ``ulysses_attention`` on the same mesh
  shape within 1e-5, and so do the q, k and v gradients of a fixed
  cotangent (JAX's ``grad`` through ``shard_map``; the port's autograd
  through the counted ``ppermute`` / ``all_to_all``);
- Ulysses with ``use_flash``: the local attention is
  ``ops/flash_attention.flash_attention`` (on the CPU the plain twins of
  kernel B4 and the fused backward) against JAX's Pallas kernel in
  interpret mode, within 5e-5 (the reference's own bar in
  ``tests/test_ulysses.py``);
- ``train_sasrec`` on ``[2, 1]``, ``[1, 2]`` ring and ``[1, 2]`` Ulysses
  from the JAX package's own initial weights: five steps' losses within
  1e-4 and the params within 1e-4 of JAX's ``train_sasrec`` on the same
  mesh shape, every rank's params equal.

Each worker also reports its collective counts: the ring moves K, V and
the mask once a step and K, V's gradients back; Ulysses runs four
all-to-alls forward, four back, one gather of the mask.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from predictionio_tpu.models.sequence.model import SASRec as JaxSASRec
from predictionio_tpu.models.sequence.model import SASRecConfig as JaxSASRecConfig
from predictionio_tpu.models.sequence.model import train_sasrec as jax_train_sasrec
from predictionio_tpu.parallel.ring_attention import ring_attention as jax_ring
from predictionio_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from predictionio_tpu_torch.models.sequence.model import params_from_flax
from test_torch_distributed import run_workers

B, T, H, D = 4, 16, 4, 8


def jax_mesh(d: int, s: int) -> Mesh:
    return Mesh(np.array(jax.devices()[: d * s]).reshape(d, s), ("data", "seq"))


def attention_inputs() -> dict:
    rng = np.random.default_rng(7)
    mk = lambda: rng.normal(size=(B, T, H, D)).astype(np.float32)
    lengths = rng.integers(1, T + 1, size=B)
    return {"q": mk(), "k": mk(), "v": mk(), "cot": mk(),
            "mask": np.arange(T)[None, :] < lengths[:, None]}


_ATTENTION = """
import json, sys
import numpy as np
import torch
from predictionio_tpu_torch.parallel import distributed, mesh as M
from predictionio_tpu_torch.parallel.ring_attention import ring_attention
from predictionio_tpu_torch.parallel.ulysses import ulysses_attention

d, s, strategy, use_flash, inputs, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                          sys.argv[4] == "1", sys.argv[5], sys.argv[6])
assert distributed.init_distributed(device="cpu")
mesh = distributed.build_mesh([d, s], ("data", "seq"), device="cpu")
arrays = np.load(inputs)
di, si = mesh.axis_index("data"), mesh.axis_index("seq")
rows, cols = arrays["q"].shape[0] // d, arrays["q"].shape[1] // s


def block(name):  # this rank's (data, seq) block of a global [B, T, ...] array
    x = arrays[name][di * rows:(di + 1) * rows, si * cols:(si + 1) * cols]
    return torch.from_numpy(np.ascontiguousarray(x))


result = {}
for causal in (True, False):
    q, k, v = (block(x).requires_grad_() for x in ("q", "k", "v"))
    if strategy == "ring":
        o = ring_attention(q, k, v, mesh, causal=causal, mask=block("mask"))
    else:
        o = ulysses_attention(q, k, v, mesh, causal=causal, mask=block("mask"),
                              use_flash=use_flash)
    (o * block("cot")).sum().backward()
    for name, x in (("out", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        result[f"{name}{int(causal)}"] = x.detach().numpy()
np.savez(f"{out}-{mesh.rank}.npz", calls=json.dumps(M.collective_counts()), **result)
distributed.shutdown_distributed()
print("OK", flush=True)
"""


def assemble(blocks: list, d: int, s: int) -> np.ndarray:
    """The global array of the ranks' ``(data, seq)`` blocks, rank ``r`` at
    the row-major coordinates ``(r // s, r % s)``."""
    return np.concatenate([np.concatenate(blocks[i * s:(i + 1) * s], axis=1)
                           for i in range(d)], axis=0)


def jax_attention(strategy, mesh, x, causal, use_flash=False):
    """JAX's output and its q, k, v gradients of ``sum(out * cot)``."""
    mask = jnp.asarray(x["mask"])

    def loss(q, k, v):
        if strategy == "ring":
            o = jax_ring(q, k, v, mesh, causal=causal, mask=mask)
        else:
            o = jax_ulysses(q, k, v, mesh, causal=causal, mask=mask, use_flash=use_flash)
        return (o * x["cot"]).sum(), o

    args = tuple(jnp.asarray(x[n]) for n in ("q", "k", "v"))
    grads, out = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(*args)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def run_attention(tmp_path, d, s, strategy, use_flash=False):
    x = attention_inputs()
    path = str(tmp_path / "inputs.npz")
    np.savez(path, **x)
    out = str(tmp_path / "attn")
    run_workers(_ATTENTION, n=d * s, args=(d, s, strategy, int(use_flash), path, out))
    got = [np.load(f"{out}-{r}.npz") for r in range(d * s)]
    return x, got


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
@pytest.mark.parametrize("d,s", [(1, 2), (2, 2), (1, 4)])
def test_sequence_parallel_attention_matches_jax(tmp_path, d, s, strategy):
    x, got = run_attention(tmp_path, d, s, strategy)
    mesh = jax_mesh(d, s)
    for causal in (True, False):
        want = jax_attention(strategy, mesh, x, causal)
        for name, w in zip(("out", "dq", "dk", "dv"), want):
            np.testing.assert_allclose(
                assemble([g[f"{name}{int(causal)}"] for g in got], d, s), w, atol=1e-5,
                err_msg=f"{name} causal={causal}")
    for g in got:
        calls = json.loads(str(g["calls"]))
        if strategy == "ring":
            # forward: K, V and the mask once per hop; backward: K's and V's gradients
            assert calls == {"gloo:ppermute": 2 * 5 * (s - 1)}, calls
        else:
            assert calls == {"gloo:all_to_all": 2 * 8, "gloo:all_gather": 2}, calls


def test_ulysses_flash_local_matches_jax_pallas(tmp_path):
    """``use_flash``: the flash path (on the CPU the plain twins of B4 and
    the fused backward, at one head per rank) against JAX's Pallas kernel
    in interpret mode inside its Ulysses body."""
    x, got = run_attention(tmp_path, 1, 2, "ulysses", use_flash=True)
    mesh = jax_mesh(1, 2)
    for causal in (True, False):
        want = jax_attention("ulysses", mesh, x, causal, use_flash=True)
        for name, w in zip(("out", "dq", "dk", "dv"), want):
            np.testing.assert_allclose(
                assemble([g[f"{name}{int(causal)}"] for g in got], 1, 2), w, atol=5e-5,
                err_msg=f"{name} causal={causal}")


SASREC = dict(num_items=20, max_len=8, embed_dim=8, num_heads=2, num_blocks=2, ffn_dim=16,
              learning_rate=0.01, batch_size=8, epochs=1, seed=3)


def sasrec_sequences(n=40, t=8, num_items=20, seed=5):
    """Right-padded id rows (0 = pad) of lengths 2..t."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, t), np.int32)
    for r in range(n):
        length = rng.integers(2, t + 1)
        out[r, :length] = rng.integers(1, num_items + 1, size=length)
    return out


_SASREC = """
import json, sys
import numpy as np
import torch
from predictionio_tpu_torch.models.sequence.model import SASRecConfig, train_sasrec
from predictionio_tpu_torch.parallel import distributed

d, s, kw, inputs, out = (int(sys.argv[1]), int(sys.argv[2]), json.loads(sys.argv[3]),
                         sys.argv[4], sys.argv[5])
assert distributed.init_distributed(device="cpu")
mesh = distributed.build_mesh([d, s], ("data", "seq"), device="cpu")
arrays = np.load(inputs)
init = {k[5:]: torch.from_numpy(arrays[k]) for k in arrays.files if k.startswith("init.")}
state, losses = train_sasrec(SASRecConfig(**kw), arrays["seqs"], "cpu", log_every=1,
                             init_state=init, mesh=mesh)
np.savez(f"{out}-{mesh.rank}.npz", losses=np.asarray(losses),
         **{k: v.numpy() for k, v in state.items()})
distributed.shutdown_distributed()
print("OK", flush=True)
"""


@pytest.mark.parametrize("d,s,seq_parallel", [(2, 1, "ring"), (1, 2, "ring"),
                                              (1, 2, "ulysses")])
def test_train_sasrec_on_a_mesh_matches_jax(tmp_path, d, s, seq_parallel):
    kw = dict(SASREC, seq_parallel=seq_parallel)
    seqs = sasrec_sequences()
    init = JaxSASRec(JaxSASRecConfig(**kw)).init(
        jax.random.PRNGKey(kw["seed"]), jnp.zeros((1, kw["max_len"]), jnp.int32))["params"]
    init = params_from_flax(jax.tree_util.tree_map(np.asarray, init))
    path = str(tmp_path / "inputs.npz")
    np.savez(path, seqs=seqs, **{f"init.{k}": v.numpy() for k, v in init.items()})
    out = str(tmp_path / "sasrec")
    run_workers(_SASREC, n=d * s, args=(d, s, json.dumps(kw), path, out))
    got = [np.load(f"{out}-{r}.npz") for r in range(d * s)]
    jax_params, jax_losses = jax_train_sasrec(JaxSASRecConfig(**kw), seqs, jax_mesh(d, s),
                                              log_every=1)
    assert len(jax_losses) == 5
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jax_params))
    for g in got:
        np.testing.assert_allclose(g["losses"], jax_losses, rtol=1e-5, atol=1e-4)
        for name in want:
            np.testing.assert_array_equal(g[name], got[0][name])
            np.testing.assert_allclose(g[name], want[name].numpy(), atol=1e-4, err_msg=name)
