"""The yardstick against hand-worked numbers: bounds, operation counts, the
generator, the trace's reading and the readers on a synthetic trace."""

import math
import os

import numpy as np
import pytest

from pio_bench import bounds, generator, harness
from pio_bench.checks import Check, exact_gap, leaf_norm_gaps, relative_gap
from pio_bench.trace import Trace


def test_causal_pairs():
    assert bounds.causal_pairs(np.array([64, 64]), 64) == 2 * 64 * 65 // 2
    assert bounds.causal_pairs(np.array([3]), 5) == 5 + 4 + 3
    assert bounds.causal_pairs(np.array([0, 70]), 64) == 64 * 65 // 2


def test_flash_bound_at_the_training_shape():
    # PERF.md's kernel table: 0.002548 ms forward, 0.005052 ms backward
    pairs = 256 * 64 * 65 // 2
    assert bounds.flash_bound("flash_forward", 256, 2, 64, 16, pairs) == pytest.approx(
        2.548e-6, rel=1e-3)
    assert bounds.flash_bound("flash_backward", 256, 2, 64, 16, pairs) == pytest.approx(
        5.052e-6, rel=1e-3)


@pytest.mark.parametrize("b,t,e,f,vocab,lengths", [
    (256, 64, 32, 64, 27_001, [64] * 256),     # examples/sequence/engine.json's shape
    (128, 200, 50, 50, 26_745, [200] * 13 + [69] * 115),   # the configuration's
])
def test_step_flops_of_the_sasrec_configuration(b, t, e, f, vocab, lengths):
    pairs = bounds.causal_pairs(np.array(lengths), t)
    tokens = b * t
    dense = tokens * 2 * (8 * e * e + 4 * e * f)
    attention = 2 * 4 * e * pairs
    head = 2 * tokens * e * vocab
    got = bounds.sasrec_step_flops(b, t, e, f, 2, vocab, pairs)
    assert got == pytest.approx(3 * (dense + attention + head))
    assert 0.95 < 3 * head / got < 1.0    # the tied head is nearly all of a step


def test_generator_repeats_a_seed_and_follows_its_laws(root):
    traffic = harness.load_json(os.path.join(root, "pio_bench", "traffic", "ml20m_users.json"))
    a = generator.ratings(traffic, 50, 40, 1500, 2 ** 33 + 5)
    b = generator.ratings(traffic, 50, 40, 1500, 2 ** 33 + 5)
    assert all(np.array_equal(getattr(a, k), getattr(b, k)) for k in ("users", "items",
                                                                     "ratings", "times"))
    rng = np.random.default_rng(2 ** 33 + 5)
    drawn = (np.minimum(rng.random(500) ** 4.4, 0.999999) * 50).astype(np.int64)
    users = np.concatenate([np.repeat(np.arange(50), 20), drawn])
    items = (np.minimum(rng.random(1500) ** 2.2, 0.999999) * 40).astype(np.int64)
    ratings = rng.integers(1, 6, size=1500).astype(np.float32)
    order = rng.permutation(1500)
    assert np.array_equal(a.users, users[order]) and np.array_equal(a.items, items[order])
    assert np.array_equal(a.ratings, ratings[order])
    assert np.array_equal(a.times, np.arange(1500.0))
    assert np.bincount(a.users, minlength=50).min() >= 20


def test_generator_floor_gives_every_id_its_events():
    traffic = {"users": {"law": "power", "exponent": 1.5, "floor": 3},
               "items": {"law": "power", "exponent": 1.0}, "ratings": {"low": 1, "high": 5},
               "times": "index"}
    ev = generator.ratings(traffic, 20, 10, 200, 9)
    assert np.bincount(ev.users, minlength=20).min() >= 3 and ev.users.size == 200
    with pytest.raises(ValueError):
        generator.ratings(dict(traffic, users={"law": "power", "exponent": 1.0, "floor": 11}),
                          20, 10, 200, 9)
    with pytest.raises(ValueError, match="unknown id law"):
        generator.ratings(dict(traffic, users={"law": "zipf"}), 20, 10, 200, 9)


def test_gaps():
    assert relative_gap(10.5, 10.0) == pytest.approx(0.05)
    leaves = {"a": np.array([3.0, 4.0]), "b": np.array([1e-12])}
    moved = {"a": np.array([4.0, 3.0]), "b": np.array([0.0])}
    # the same norms: a gap of norms reads 0 where a norm of the difference would not
    assert leaf_norm_gaps(moved, leaves) == {"a": pytest.approx(0.0, abs=1e-12),
                                             "b": pytest.approx(1e-12 / 2.5)}
    # a leaf left unmoved reads 1; a leaf all but zero is held to the median leaf's norm
    assert leaf_norm_gaps({"a": 0 * leaves["a"], "b": leaves["b"]}, leaves)["a"] == 1.0
    assert leaf_norm_gaps({"a": leaves["a"]}, leaves) == {"a": 0.0, "b": math.inf}
    assert exact_gap({"a": np.ones(2)}, {"a": np.ones(2)}) == 0.0
    assert not Check("x", math.nan, 1.0).ok and Check("x", 1.0, 1.0).ok


def _events():
    """Two recorded steps: launches at 10 and 60, kernels 20-40 and
    70-80 (B4 and a softmax), a copy launched before the stretch, a
    cudaMalloc over the 40-70 gap."""
    x = lambda name, cat, ts, dur, **args: {"ph": "X", "name": name, "cat": cat, "ts": ts,
                                           "dur": dur, "args": args}
    return [
        x("ProfilerStep#7", "user_annotation", 0, 50),
        x("ProfilerStep#8", "user_annotation", 50, 50),
        x("ProfilerStep#8", "gpu_user_annotation", 20, 60),
        x("cudaLaunchKernel", "cuda_runtime", 10, 2, correlation=1),
        x("cudaLaunchKernel", "cuda_runtime", 60, 2, correlation=2),
        x("cudaMemcpyAsync", "cuda_runtime", -20, 2, correlation=3),
        x("cudaMalloc", "cuda_runtime", 42, 26),
        x("aten::cross_entropy_loss", "cpu_op", 41, 40),
        x("void flash_fwd_kernel<64>", "kernel", 20, 20, correlation=1),
        x("softmax_kernel", "kernel", 70, 10, correlation=2),
        x("Memcpy HtoD", "gpu_memcpy", -5, 3, correlation=3),
    ]


def test_trace_reading():
    trace = Trace.from_events(_events())
    assert trace.recorded_steps() == 2
    assert trace.window() == (20.0, 80.0)
    assert trace.busy_s() == pytest.approx(30e-6) and trace.window_s() == pytest.approx(60e-6)
    assert trace.idle_share() == pytest.approx(0.5)
    assert trace.seconds(trace.kernels("flash_fwd")) == pytest.approx(20e-6)
    assert trace.breakdown() == {
        "device_ops": [["void flash_fwd_kernel<64>", pytest.approx(20e-6)],
                       ["softmax_kernel", pytest.approx(10e-6)]],
        "idle_gaps": [["cudaMalloc", pytest.approx(30e-6)]]}


def _fake_run(root, traced, launches):
    class FakeRun:
        spans = {}
        facts = {"attn_bound_s": 5e-6, "attn_launches": launches, "step_flops": 165e6}

        class tracer:
            active = 2

    FakeRun.traced = traced
    return FakeRun


def test_readers_on_the_synthetic_trace(root):
    names = ("sasrec.attn_roofline", "sasrec.idle_share", "sasrec_step_mfu")
    run = _fake_run(root, Trace.from_events(_events()), 1)
    got = {name: harness.reader(root, name)(run) for name in names}
    assert got == {"sasrec.attn_roofline": pytest.approx(100 * 5e-6 / 20e-6),
                   "sasrec.idle_share": pytest.approx(50.0),
                   "sasrec_step_mfu": pytest.approx(100 * 165e6 / (60e-6 * 165e12))}
    # a launch missing from the trace: no roofline is read
    run = _fake_run(root, Trace.from_events(_events()), 2)
    assert harness.reader(root, "sasrec.attn_roofline")(run) is None


@pytest.mark.parametrize("name", ["sasrec.attn_roofline", "sasrec.idle_share",
                                  "sasrec_step_mfu"])
def test_a_reader_with_nothing_to_read_returns_none(root, name):
    class FakeRun:
        traced = None
        spans, facts = {}, {}

    assert harness.reader(root, name)(FakeRun) is None


def test_the_tracer_records_only_its_stretch():
    import torch

    from pio_bench.trace import Tracer

    tracer = Tracer(skip=2, warmup=1, active=3)
    with tracer:
        for _ in range(9):
            torch.ones(64, 64) @ torch.ones(64, 64)
            tracer.step()
    trace = tracer.read()
    assert trace is not None and trace.recorded_steps() == 3 and tracer.first_step() == 4
    assert not os.path.exists(tracer.directory)
