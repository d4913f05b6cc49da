"""Shared set-up of the benchmark's own tests (``python -m pytest
pio_bench/tests`` from the root of a checkout): the checkout on
``sys.path`` and each cell's toy size for CPU runs."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: each cell at a size a CPU test run holds; the same window entries,
#: references and limits as on the card
TOY = {
    "sasrec-ml20m.train": {
        "config": {"data": {"users": 600, "items": 300, "events": 30000}},
        "cell": {"params": {"warm_steps": 1, "timed_warm_steps": 2},
                 "trace": {"skip": 1, "warmup": 1, "active": 2}},
    },
}


@pytest.fixture
def root() -> str:
    return ROOT


@pytest.fixture
def toy() -> dict:
    return TOY
