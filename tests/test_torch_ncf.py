"""The port's Neural-CF model and scorers against the JAX package, on the CPU.

The same weights (the JAX package's flax init, carried across with
``params_from_flax``) and the same seeded inputs go through both. Bars
are the reference's own: the scorer head ``rtol=2e-4, atol=2e-5`` and
the model forward ``rtol=1e-4, atol=1e-5`` (``tests/test_ncf.py:41,52``).
The JAX head runs its real Pallas kernel in interpret mode, as the
reference's tests do; on a CPU tensor the port's ``ncf_score_all_items``
takes its plain version, so these hold the arithmetic the CUDA kernel
must reproduce. The kernel itself is held to the plain version on the
card (``test_kernel_matches_plain_on_card`` and ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.models.ncf.kernel import (
    make_batch_scorer as jax_batch_scorer,
)
from predictionio_tpu.models.ncf.kernel import (
    ncf_score_all_items as jax_score_all_items,
)
from predictionio_tpu.models.ncf.kernel import reference_score_all_items
from predictionio_tpu.models.ncf.model import NCFConfig as JaxNCFConfig
from predictionio_tpu.models.ncf.model import NeuMF as JaxNeuMF
from predictionio_tpu.models.ncf.model import (
    make_implicit_batches as jax_implicit_batches,
)
from predictionio_tpu_torch.models.ncf import kernel
from predictionio_tpu_torch.models.ncf.model import (
    NCFConfig,
    NeuMF,
    config_from_state,
    init_model,
    make_implicit_batches,
    params_from_flax,
)


def flax_params(num_users, num_items, embed, hidden, seed=0):
    """The JAX package's NeuMF init as a tree of numpy arrays, with the
    biases drawn from ``seed`` (the init zeroes them)."""
    config = JaxNCFConfig(num_users=num_users, num_items=num_items,
                          embed_dim=embed, hidden=tuple(hidden))
    params = JaxNeuMF(config).init(
        jax.random.PRNGKey(seed), jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32)
    )["params"]
    tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)
    rng = np.random.default_rng(seed)
    for leaves in tree.values():
        if "bias" in leaves:
            leaves["bias"] = (0.1 * rng.standard_normal(leaves["bias"].shape)).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def tiny():
    """The reference's tiny fixture (tests/test_ncf.py:25): 10 users,
    1,500 items (more than one 1,024-item tile, with a ragged tail),
    E=8, hidden (16, 8)."""
    tree = flax_params(10, 1500, 8, (16, 8))
    return tree, params_from_flax(tree)


def head_args(state, num_items, user):
    gmf_users, mlp_users, head = kernel.head_tensors(state, num_items, "cpu")
    gi, mi, kernels, biases, out_k, out_b = head
    return (gi, mi, gmf_users[user], mlp_users[user], kernels, biases, out_k, out_b)


@pytest.mark.parametrize("user", [0, 3, 9])
def test_plain_head_matches_the_pallas_kernel_with_a_ragged_tail(tiny, user):
    tree, state = tiny
    want = jax_score_all_items(tree, user, 1500, interpret=True)
    got = kernel.ncf_score_plain(*head_args(state, 1500, user)).numpy()
    assert got.shape == (1500,)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    # on CPU tensors the counting wrapper is the plain head, launch-free
    before = kernel.ncf_score_all_items.launches
    wrapped = kernel.ncf_score_all_items(*head_args(state, 1500, user)).numpy()
    np.testing.assert_array_equal(wrapped, got)
    assert kernel.ncf_score_all_items.launches == before


@pytest.mark.parametrize("hidden", [(16,), (16, 8, 4)])
def test_plain_head_matches_the_reference_head_at_other_depths(hidden):
    tree = flax_params(6, 700, 8, hidden, seed=2)
    state = params_from_flax(tree)
    for user in (0, 5):
        want = reference_score_all_items(tree, user, 700)
        got = kernel.ncf_score_plain(*head_args(state, 700, user)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
        scorer = kernel.make_all_items_scorer(state, 700, "cpu")
        np.testing.assert_allclose(scorer(user), want, rtol=2e-4, atol=2e-5)


def test_plain_head_matches_the_pallas_kernel_at_wide_widths():
    """E=64 with hidden (256, 128), whose weights no longer fit a CUDA
    block's shared memory beside its item tiles (the kernel then stages
    them a chunk per use): the plain head the kernel is held to against
    the reference's Pallas kernel in interpret mode."""
    tree = flax_params(4, 300, 64, (256, 128), seed=6)
    state = params_from_flax(tree)
    for user in (0, 3):
        want = jax_score_all_items(tree, user, 300, interpret=True)
        got = kernel.ncf_score_plain(*head_args(state, 300, user)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("embed,hidden", [(64, (1600, 800)), (1536, (64, 32))])
def test_plain_head_matches_the_pallas_kernel_past_the_wide_layout(embed, hidden):
    """A first hidden layer of 1,600 and an embedding of 1,536: widths
    whose weights no longer fit a CUDA block's shared memory (the kernel
    stages them a chunk per use, and at E = 1,536 holds the item rows in
    32-column chunks). The plain head the kernel is held to, against the
    reference's ``make_all_items_scorer`` with its Pallas kernel in
    interpret mode."""
    from predictionio_tpu.models.ncf.kernel import make_all_items_scorer as jax_scorer

    tree = flax_params(4, 300, embed, hidden, seed=7)
    state = params_from_flax(tree)
    score = jax_scorer(tree, 300, interpret=True)
    for user in (0, 3):
        want = np.asarray(score(user))
        got = kernel.ncf_score_plain(*head_args(state, 300, user)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("embed,hidden", [(5, (130, 9)), (33, (100, 45)), (100, (8, 70)),
                                          (3, (1, 1))])
def test_plain_head_matches_the_pallas_kernel_at_odd_widths(embed, hidden):
    """Widths the CUDA kernel pads: E not a multiple of 8 (nor of 4 at 5,
    33 and 3, where it copies the tables in 4-byte pieces), H0 past one
    64-column chunk, H1 past one 32-column chunk, a single hidden unit.
    The plain head against the reference's Pallas kernel in interpret
    mode over a ragged 300-item catalog."""
    tree = flax_params(4, 300, embed, hidden, seed=8)
    state = params_from_flax(tree)
    for user in (0, 3):
        want = jax_score_all_items(tree, user, 300, interpret=True)
        got = kernel.ncf_score_plain(*head_args(state, 300, user)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_all_items_scorer_matches_the_jax_kernel(tiny):
    tree, state = tiny
    scorer = kernel.make_all_items_scorer(state, 1500, "cpu")
    for user in (0, 4, 9):
        want = jax_score_all_items(tree, user, 1500, interpret=True)
        got = scorer(np.int64(user))
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_neumf_forward_matches_flax_apply(tiny):
    tree, state = tiny
    model = NeuMF(config_from_state(state))
    model.load_state_dict(state)
    users = np.array([3, 3, 0, 9, 5, 1] * 4, np.int32)
    items = np.arange(24, dtype=np.int32) * 61
    want = np.asarray(JaxNeuMF(JaxNCFConfig(10, 1500, 8, (16, 8))).apply(
        {"params": tree}, jnp.asarray(users), jnp.asarray(items)))
    with torch.no_grad():
        got = model(torch.from_numpy(users).long(), torch.from_numpy(items).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("pair_budget", [2_000_000, 4_000])
def test_batch_scorer_matches_the_jax_batch_scorer(tiny, pair_budget):
    """Both chunkings: one chunk, and chunks of 2 users (4,000 pairs over
    1,500 items) with a ragged last chunk padded to its bucket."""
    tree, state = tiny
    users = np.array([0, 3, 9, 3, 7], np.int32)
    want = jax_batch_scorer(tree, 1500, pair_budget=pair_budget)(users)
    got = kernel.make_batch_scorer(state, 1500, "cpu", pair_budget=pair_budget)(users)
    assert got.shape == (5, 1500)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_params_carry_across_under_their_flax_names(tiny):
    tree, state = tiny
    for name, leaves in tree.items():
        if "embedding" in leaves:
            np.testing.assert_array_equal(state[f"{name}.weight"].numpy(), leaves["embedding"])
        else:  # a flax kernel is [in, out], a Linear.weight [out, in]
            np.testing.assert_array_equal(state[f"{name}.weight"].numpy(), leaves["kernel"].T)
            np.testing.assert_array_equal(state[f"{name}.bias"].numpy(), leaves["bias"])
    assert len(state) == 4 + 2 * 3
    model = NeuMF(config_from_state(state))
    assert model.load_state_dict(state) is not None  # every name has its counterpart
    assert config_from_state(state).hidden == (16, 8)


def test_init_follows_flax_default_distributions():
    """Embeddings N(0, 1/E); dense kernels a normal truncated at two
    standard deviations with std 1/sqrt(fan_in) after truncation; zero
    biases. Statistics at E=32, hidden (64, 32), as flax draws them."""
    model = init_model(NCFConfig(num_users=4000, num_items=3000, embed_dim=32, seed=5))
    again = init_model(NCFConfig(num_users=4000, num_items=3000, embed_dim=32, seed=5))
    for name, p in model.state_dict().items():
        assert torch.equal(p, again.state_dict()[name])  # seeded
    state = model.state_dict()
    for table in ("gmf_user", "gmf_item", "mlp_user", "mlp_item"):
        assert abs(float(state[f"{table}.weight"].std()) - 1 / np.sqrt(32)) < 0.005
    for name, fan_in in (("mlp_0", 64), ("mlp_1", 64), ("out", 64)):
        w, std = state[f"{name}.weight"], 1 / np.sqrt(fan_in)
        assert abs(float(w.std()) - std) < 0.1 * std
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
        assert not state[f"{name}.bias"].any()


@pytest.mark.parametrize("seed,num_users,num_items,negatives", [
    (0, 30, 20, 4),       # dense: many sampled pairs collide with positives
    (7, 400, 900, 3),
    (3, 5, 1, 2),         # one item: every negative collides
])
def test_implicit_batches_are_byte_identical(seed, num_users, num_items, negatives):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, num_users, 600).astype(np.int32)
    items = rng.integers(0, num_items, 600).astype(np.int32)
    want = jax_implicit_batches(users, items, num_items, negatives, np.random.default_rng(seed))
    got = make_implicit_batches(users, items, num_items, negatives, np.random.default_rng(seed),
                                device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def card_head(num_items, embed, hidden, seed):
    """Random ``NeuMF`` head tensors on the card from ``seed``: the port's
    own init, so the test needs no JAX, and biases drawn with numpy so the
    kernel's bias paths are exercised."""
    state = init_model(NCFConfig(num_users=4, num_items=num_items, embed_dim=embed,
                                 hidden=tuple(hidden), seed=seed)).state_dict()
    rng = np.random.default_rng(seed)
    for name, value in state.items():
        if name.endswith(".bias"):
            value.copy_(torch.from_numpy(0.1 * rng.standard_normal(value.shape).astype(np.float32)))
    return kernel.head_tensors(state, num_items, "cuda")


#: (items, E, (H0, H1)): the template's widths at the edges of the kernel's
#: 16-row m-tiles and 128-item tiles and a ragged catalog; widths it pads
#: (E 5, 8, 33, 100; H0 and H1 not multiples of 8, past one 64-column H0
#: chunk and one 32-column H1 chunk), 64/(256, 128) at the tile edges of
#: its instance past H1 = 32 and an H0 whose c0 is recomputed per chunk;
#: and every width chip_smoke.py times, over a ragged catalog
CARD_CASES = (
    [(n, 32, (64, 32)) for n in (1, 15, 16, 17, 127, 128, 129, 255, 256, 257, 5003)]
    + [(3001, 5, (12, 7)), (3001, 8, (16, 8)), (2049, 33, (100, 45)), (2047, 100, (200, 70)),
       (3001, 40, (300, 130)), (1003, 5, (130, 9)), (1003, 100, (8, 70)), (517, 3, (1, 1))]
    + [(n, 64, (256, 128)) for n in (255, 256, 257)] + [(300, 8, (60_000, 8))]
    + [(27_000, 32, (64, 32)), (5003, 64, (256, 128)), (5003, 128, (512, 256)),
       (5003, 64, (1600, 800)), (1003, 64, (4096, 2048)), (5003, 1536, (64, 32))]
)


@pytest.mark.cuda
@pytest.mark.parametrize("items,embed,hidden", CARD_CASES)
def test_kernel_matches_plain_on_card(items, embed, hidden):
    """Kernel B3 against its plain version on the card, one launch a user,
    elementwise within the summation-order bound of
    ``chip_smoke.b3_tolerance``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gmf_users, mlp_users, head = card_head(items, embed, hidden, seed=4)
    gi, mi, kernels, biases, out_k, out_b = head
    abs_head = (gi.abs(), mi.abs(), [k.abs() for k in kernels], [b.abs() for b in biases],
                out_k.abs(), out_b.abs())
    tol = 2.0 * (3 * embed + hidden[0] + hidden[1] + 6) * 2.0 ** -24
    for u in (0, 3):
        args = (gi, mi, gmf_users[u], mlp_users[u], kernels, biases, out_k, out_b)
        before = kernel.ncf_score_all_items.launches
        got = kernel.ncf_score_all_items(*args)
        torch.cuda.synchronize()
        assert kernel.ncf_score_all_items.launches == before + 1
        want = kernel.ncf_score_plain(*args)
        scale = kernel.ncf_score_plain(abs_head[0], abs_head[1], gmf_users[u].abs(),
                                       mlp_users[u].abs(), *abs_head[2:])
        assert got.shape == (items,)
        assert bool(torch.isfinite(got).all())
        assert bool(((got - want).abs() <= tol * scale).all())
