"""Whole runs of each cell at toy size on the CPU (the harness's look for a
card skipped): a sound run is correct; with the timed path broken
underneath, or with the reference in TF32 put in the program's place,
``correct`` comes out false."""

import pytest

from pio_bench import harness

SEED = 2 ** 31 + 77
FAULTS = [("sasrec-ml20m.train", "state_unchanged"), ("sasrec-ml20m.train", "half_batch")]
CELLS = ["sasrec-ml20m.train"]


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(root, toy, workload):
    result = harness.execute(root, workload, SEED, 0.5, False, device="cpu",
                             overrides=toy[workload])
    failing = {k: v for k, v in result["checks"].items() if v["value"] is None
               or v["value"] > v["limit"]}
    assert result["correct"], failing
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    want = {m["name"] for m in harness.load_spec(root)["end_to_end"]
            if harness.applies(m, workload)}
    assert set(result["metrics"]) == want
    assert all(m["value"] > 0 for m in result["metrics"].values())


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_planted_fault_is_not_correct(root, toy, workload, fault):
    result = harness.execute(root, workload, SEED, 0.5, False, device="cpu",
                             overrides=toy[workload], fault=fault)
    assert not result["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_a_limit(root, toy, workload):
    result = harness.execute(root, workload, SEED, 0.5, False, device="cpu",
                             overrides=toy[workload], control=True)
    control = {k: v for k, v in result["checks"].items() if k.startswith("control.")}
    assert control and result["correct"]
    assert any(v["value"] is None or v["value"] > v["limit"] for v in control.values()), control
