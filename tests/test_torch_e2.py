"""The port's k-means and e2 helpers against the JAX package's, on the CPU.

``kmeans`` (``ops/kmeans.py``) runs its Lloyd steps with ``device="cpu"``
on the same data and seed as the reference's: the centers must agree to
``atol=1e-4`` (the reference's sharded-vs-single bar), ``iterations_run``
must be equal and the cost within ``rtol=1e-5``. The cases are the
reference's own (``tests/test_services_and_e2.py:106-177``: blobs, more
than one step, the cost of the returned centers, duplicate data,
validation), plus a row count the reference pads (its zero-weight rows,
which the port leaves out at data 1). ``MarkovChain``, ``cross_validation_folds``
and ``categorical_naive_bayes`` must equal the reference's.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.models import e2 as jax_e2
from predictionio_tpu_torch.models import e2
from predictionio_tpu_torch.ops import kmeans as port_kmeans
from predictionio_tpu_torch.parallel.mesh import local_mesh


def blobs(seed, centers, per, scale):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(c, scale, size=(per, len(c))) for c in centers]
                          ).astype(np.float32)


#: name -> (x, k, iterations, seed): the reference's k-means cases
CASES = {
    "blobs": (blobs(4, [[0.0, 0.0], [10.0, 10.0], [-10.0, 8.0]], 60, 0.4), 3, 30, 1),
    "ragged-rows": (np.random.default_rng(9).normal(size=(77, 5)).astype(np.float32), 4, 10, 2),
    "no-structure": (np.random.default_rng(12).normal(size=(300, 6)).astype(np.float32), 6, 25, 3),
    "two-steps": (np.random.default_rng(6).normal(size=(120, 4)).astype(np.float32), 3, 2, 0),
    "padded-1001": (blobs(21, np.random.default_rng(20).normal(0, 6, (8, 3)), 125, 1.0)[:1001],
                    8, 40, 5),
    "duplicates": (np.ones((8, 2), np.float32), 2, 3, 0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_kmeans_equals_the_reference(name):
    x, k, iterations, seed = CASES[name]
    want = jax_e2.kmeans(x, k=k, iterations=iterations, seed=seed)
    got = e2.kmeans(x, k=k, iterations=iterations, seed=seed, device="cpu")
    assert got.iterations_run == want.iterations_run
    np.testing.assert_allclose(got.centers, want.centers, atol=1e-4)
    np.testing.assert_allclose(got.cost, want.cost, rtol=1e-5, atol=1e-6)
    assert got.centers.dtype == np.float32
    np.testing.assert_array_equal(got.predict(x), want.predict(x))


def test_kmeans_behaves_as_the_reference_tests_state():
    """``tests/test_services_and_e2.py``'s claims, on the port."""
    x = CASES["blobs"][0]
    model = e2.kmeans(x, k=3, iterations=30, seed=1, device="cpu")
    true = np.array([[0.0, 0.0], [10.0, 10.0], [-10.0, 8.0]])
    dists = np.linalg.norm(model.centers[:, None] - true[None], axis=2)
    assert (dists.min(axis=0) < 0.5).all()
    assert sorted(np.bincount(model.predict(x), minlength=3).tolist()) == [60, 60, 60]
    assert model.cost < 120
    x = CASES["no-structure"][0]
    one = e2.kmeans(x, k=6, iterations=1, seed=3, device="cpu")
    many = e2.kmeans(x, k=6, iterations=25, seed=3, device="cpu")
    assert many.iterations_run > 1 and many.cost < one.cost
    x = CASES["two-steps"][0]
    m = e2.kmeans(x, k=3, iterations=2, seed=0, device="cpu")
    wcss = float(np.sum((x - m.centers[m.predict(x)]) ** 2))
    np.testing.assert_allclose(m.cost, wcss, rtol=1e-4)
    m = e2.kmeans(np.ones((8, 2), np.float32), k=2, iterations=3, device="cpu")
    assert m.cost == 0.0
    np.testing.assert_allclose(m.centers, 1.0)


def test_kmeans_refuses_what_the_reference_refuses():
    for kwargs in ({"x": np.zeros((3, 2), np.float32), "k": 5},
                   {"x": np.zeros((8, 2), np.float32), "k": 0},
                   {"x": np.zeros(8, np.float32), "k": 2}):
        with pytest.raises(ValueError) as want:
            jax_e2.kmeans(**kwargs)
        with pytest.raises(ValueError) as got:
            e2.kmeans(**kwargs, device="cpu")
        assert str(got.value) == str(want.value)
    # a mesh of one rank along data fits as one device does (the sharded
    # fits are test_torch_classify_mesh.py's)
    x, k, iterations, seed = CASES["padded-1001"]
    got = e2.kmeans(x, k=k, iterations=iterations, seed=seed, mesh=local_mesh(device="cpu"),
                    device="cpu")
    alone = e2.kmeans(x, k=k, iterations=iterations, seed=seed, device="cpu")
    np.testing.assert_array_equal(got.centers, alone.centers)
    assert (got.cost, got.iterations_run) == (alone.cost, alone.iterations_run)


def test_lloyd_step_keeps_an_empty_cluster_and_breaks_ties_first():
    """A center no point is nearest keeps its place; a point equidistant
    from two centers goes to the first (``jnp.argmin``)."""
    x = torch.tensor([[0.0, 0.0], [2.0, 0.0], [1.0, 0.0]])
    centers = torch.tensor([[0.0, 0.0], [2.0, 0.0], [50.0, 50.0]])
    new, assign, cost = port_kmeans.lloyd_step(x, centers)
    assert assign.tolist() == [0, 1, 0]
    assert new.tolist() == [[0.5, 0.0], [2.0, 0.0], [50.0, 50.0]]
    assert float(cost) == 1.0


def test_markov_chain_and_folds_equal_the_reference():
    seqs = [["a", "b", "c", "a"], ["b", "b", "c"], ["c", "a", "b", "d"], ["d"]]
    for smoothing in (1e-3, 0.5):
        got = e2.MarkovChain.fit(seqs, smoothing=smoothing)
        want = jax_e2.MarkovChain.fit(seqs, smoothing=smoothing)
        np.testing.assert_array_equal(got.transition, want.transition)
        assert got.states == want.states
        assert got.next_distribution("b") == want.next_distribution("b")
        assert got.most_likely_next("a") == want.most_likely_next("a")
        assert got.sequence_log_prob(["a", "b", "c"]) == want.sequence_log_prob(["a", "b", "c"])
    with pytest.raises(ValueError, match="no states"):
        e2.MarkovChain.fit([])
    for n, k, seed in ((10, 3, 1), (57, 5, 4), (4, 4, 0)):
        got = list(e2.cross_validation_folds(n, k, seed=seed))
        want = list(jax_e2.cross_validation_folds(n, k, seed=seed))
        assert len(got) == len(want) == k
        for (gt, gs), (wt, ws) in zip(got, want):
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(gs, ws)


def test_categorical_naive_bayes_equals_the_reference():
    rng = np.random.default_rng(8)
    records = [{"color": str(rng.choice(["red", "green", "blue"])),
                "size": str(rng.choice(["s", "m", "l"])),
                "shape": str(rng.choice(["round", "flat"]))} for _ in range(90)]
    labels = ["buy" if (r["color"] == "red") ^ (r["size"] == "l") else "skip" for r in records]
    records[3].pop("shape")  # a record without one field
    want = jax_e2.categorical_naive_bayes(records, labels, smoothing=0.5)
    got = e2.categorical_naive_bayes(records, labels, smoothing=0.5, device="cpu")
    assert got.classes == want.classes
    assert got.vectorizer.index == want.vectorizer.index
    np.testing.assert_allclose(got.inner.log_prior, want.inner.log_prior, rtol=1e-6)
    np.testing.assert_allclose(got.inner.log_likelihood, want.inner.log_likelihood, rtol=1e-6)
    for query in records[:20] + [{"color": "purple"}, {}]:
        assert got.predict(query) == want.predict(query)
        for label in got.classes:
            assert got.log_score(query, label) == pytest.approx(
                want.log_score(query, label), rel=1e-6)


@pytest.mark.cuda
def test_kmeans_on_the_card_equals_the_cpu():
    """The card twin: the same fit on ``cuda`` and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, k, iterations, seed = CASES["padded-1001"]
    cpu = e2.kmeans(x, k=k, iterations=iterations, seed=seed, device="cpu")
    card = e2.kmeans(x, k=k, iterations=iterations, seed=seed, device="cuda")
    assert card.iterations_run == cpu.iterations_run
    np.testing.assert_allclose(card.centers, cpu.centers, atol=1e-4)
    np.testing.assert_allclose(card.cost, cpu.cost, rtol=1e-5)
