"""The benchmark's own tests (run with ``python -m pytest portbench/tests``
from the repository root): the harness's files on the path, each cell's tiny
mix for CPU runs, and the card fixture of the ``gpu`` tests."""
import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def small():
    """Each cell's mix cut to a size a CPU test holds: the ``small`` key of
    ``workloads/<cell>.json`` (the cell's own traffic file stays as it
    is)."""
    root = REPO / "portbench" / "workloads"
    with open(REPO / "BENCHMARK.json") as fh:
        cells = [w["name"] for w in json.load(fh)["workloads"]]
    out = {}
    for cell in cells:
        with open(root / f"{cell}.json") as fh:
            out[cell] = json.load(fh)["small"]
    return out


@pytest.fixture
def cuda_card():
    """Skips the test unless a CUDA card is present (decided here, never
    while a module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
