"""The benchmark's own tests: `python -m pytest portbench/tests`.

Tests that need a CUDA card carry the `card` marker and skip inside the
test when there is none; on a machine with a card they run the cell at its
own size.
"""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the widths of the CPU runs: every width the cells use, cut so that a whole
# run takes seconds
TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")


def tiny_cell(name: str):
    """The cell `name` with TINY widths and a pool, calibration, sample and
    traced window a CPU run holds; its limits are the cell's own."""
    from portbench import harness

    cell = copy.deepcopy(harness.find(name))
    cell.config.update(TINY)
    if cell.kind == "recordings":
        cell.mix.update(patients=2, length_s={"low": 4, "high": 7},
                        warmup_windows=[8], trace_seconds=0.3,
                        check={"stage1_windows": 16, "stage2_windows": 8})
        cell.mix["gate"]["calibration_s"] = 20
    else:
        cell.mix.update(pool_rows=16, batch=4, trace_seconds=0.3)
    return cell
