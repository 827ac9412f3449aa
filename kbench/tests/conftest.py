"""pytest settings of the benchmark's own tests (``pytest kbench/tests``)."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: a cell shrunk to a CPU test's size: reads of a 20 kbp genome
TINY = {"reads": {"genome_len": 20_000, "n_reads": 3_000}}
TINY_QUERY = {"reads": TINY["reads"],
              "traffic": {"batch_reads": 64, "pool_batches": 4}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs on an NVIDIA GPU (skips when torch.cuda "
        "finds none)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"


@pytest.fixture(scope="session")
def tiny():
    """Overrides of each cell, and of the count build cell that
    test_kbench_runs adds back to a copy of the benchmark."""
    return {"rsph45x-k31-count.build": TINY, "rsph45x-k31-pq.build": TINY,
            "rsph45x-k31-count.query": TINY_QUERY}
