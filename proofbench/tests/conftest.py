"""The harness's own tests: CPU only, at toy sizes, apart from those
marked `chip`, which run on a CUDA card and skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skipped without one")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the harness on the chip")
    return torch.device("cuda")


def tiny(cell_name: str, log2: int = 5):
    """The cell `cell_name` of BENCHMARK.json at 2^log2 constraints (and,
    for the elastic prover, blocks of 8, a buffer of 16 and threshold 2,
    so that its streamed rounds run)."""
    from proofbench import spec

    cell = spec.find_cell(cell_name)
    cell.traffic["constraints_log2"] = log2
    if "block_size_log2" in cell.config:
        cell.config.update(block_size_log2=3, max_msm_buffer_log2=4,
                           space_time_threshold=2)
    return cell
