"""The frozen plain reference against the port's CPU path at toy sizes:
the same packing, the same seeded init, the same first steps."""

import os

import numpy as np
import pytest
import torch

from pio_bench import generator, harness
from pio_bench.checks import relative_gap


@pytest.fixture(scope="module")
def refs():
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ref = harness.load_module(
        os.path.join(root, "pio_bench", "configs", "sasrec-ml20m.reference.py"), "ref_sasrec")
    traffic = harness.load_json(os.path.join(root, "pio_bench", "traffic", "ml20m_users.json"))
    return ref, traffic


#: toy shapes (embed, heads, ffn, max_len) and model seeds: the run's seed
#: seeds the model, so a large one is among them; one head of width 50 as
#: the configuration has
SHAPES = [(16, 2, 24, 32, 5), (50, 1, 50, 40, 2 ** 33 + 5)]


def _sasrec_inputs(traffic, embed, heads, ffn, max_len, seed):
    from predictionio_tpu_torch.models.sequence.engine import (
        SequencePreparator,
        SequencesData,
        group_sequences,
    )
    from predictionio_tpu_torch.models.sequence.model import SASRecConfig

    ev = generator.ratings(traffic, 700, 90, 30_000, 13)
    seqs, users = group_sequences(ev.users, ev.items, ev.times,
                                  [f"u{u}" for u in range(700)], 2)
    matrix = SequencePreparator({"maxLen": max_len}).prepare(
        None, SequencesData(seqs, users, [f"i{i}" for i in range(90)])).matrix
    config = SASRecConfig(num_items=90, max_len=max_len, embed_dim=embed, num_heads=heads,
                          num_blocks=2, ffn_dim=ffn, batch_size=64, epochs=1, seed=seed,
                          attention="plain")
    return ev, matrix, config


@pytest.mark.parametrize("shape", SHAPES)
def test_sasrec_reference_packs_and_inits_as_the_port(refs, shape):
    from predictionio_tpu_torch.models.sequence.model import init_model

    ref, traffic = refs
    ev, matrix, config = _sasrec_inputs(traffic, *shape)
    embed, _, ffn, max_len, seed = shape
    got = ref.sequences(ev.users, ev.items, ev.times, max_len, 2, "cpu")
    assert np.array_equal(got.numpy(), matrix.astype(np.int64))
    assert (got > 0).sum(axis=1).min() < max_len    # some rows are padded
    want = init_model(config).state_dict()
    init = ref.initial_params(91, max_len, embed, 2, ffn, seed)
    assert list(init) == list(want)
    assert all(torch.equal(init[k], want[k]) for k in want)


@pytest.mark.parametrize("shape", SHAPES)
def test_sasrec_reference_follows_the_ports_first_three_steps(refs, shape):
    from predictionio_tpu_torch.models.sequence.model import train_sasrec

    ref, traffic = refs
    ev, matrix, config = _sasrec_inputs(traffic, *shape)
    embed, heads, ffn, max_len, seed = shape
    three = matrix[: 3 * config.batch_size]
    _, losses = train_sasrec(config, three, "cpu", log_every=1)
    seqs = torch.as_tensor(three.astype(np.int64))
    batches = [seqs[torch.as_tensor(rows)]
               for rows in ref.first_batches(len(three), config.batch_size, 3, seed)]
    want, _, _ = ref.train(ref.initial_params(91, max_len, embed, 2, ffn, seed), batches,
                           heads, 2, config.learning_rate, "f64", "cpu")
    assert len(losses) == 3
    assert max(relative_gap(a, b) for a, b in zip(losses, want)) < 1e-6


def test_the_tf32_rounding(refs):
    ref, _ = refs
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0 - 2 ** -9])
    # 10 mantissa bits kept: 1 + 2^-11 is a tie and rounds away from zero
    assert ref.tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0 - 2 ** -9]
