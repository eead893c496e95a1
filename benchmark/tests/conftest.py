"""Tests of the benchmark harness: CPU at small sizes; those marked
``cuda`` run only where a card is found (decided inside the test)."""

import pytest
import torch


@pytest.fixture
def restore_port():
    """Undo the faults a test plants in the port (benchmark.tests.faults)."""
    from benchmark.tests import faults

    yield
    faults.undo()


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
