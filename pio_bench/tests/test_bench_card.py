"""Tests that need the card (the ``cuda`` marker; each decides inside the
test whether there is one). On the card: a toy-size run of each cell
through the kernels is correct and its control fails a limit, and the
control's TF32 rounding reads as the card's own TF32 products do.

    python3 -m pytest -m cuda pio_bench/tests
"""

import os

import pytest

from pio_bench import harness

CELLS = ["sasrec-ml20m.train"]


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_toy_run_through_the_kernels(root, toy, workload):
    _card()
    harness.use_checkout_caches(root)
    result = harness.execute(root, workload, 2 ** 31 + 9, 1.0, False, device="cuda",
                             overrides=toy[workload], control=True)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["memory_peak_bytes"] > 0
    control = [v for k, v in result["checks"].items() if k.startswith("control.")]
    assert any(v["value"] is None or v["value"] > v["limit"] for v in control)


@pytest.mark.cuda
def test_the_controls_tf32_reads_as_the_cards(root):
    torch = _card()
    ref = harness.load_module(os.path.join(root, "pio_bench", "configs",
                                           "sasrec-ml20m.reference.py"), "ref_card")
    g = torch.Generator(device="cuda").manual_seed(5)
    a = torch.randn((512, 256, 16), device="cuda", generator=g)
    exact = a.double().transpose(1, 2) @ a.double()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        card = a.transpose(1, 2) @ a
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    emulated = ref.tf32(a).transpose(1, 2) @ ref.tf32(a)
    card_err = float((card.double() - exact).norm())
    emulated_err = float((emulated.double() - exact).norm())
    assert 0.5 < emulated_err / card_err < 2.0, (emulated_err, card_err)
