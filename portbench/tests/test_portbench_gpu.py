"""Each cell on the card at a tiny size: the kernel path runs, the result
line has the contract's keys, and ``correct`` holds (``-m gpu``; skips
without a card)."""
import pytest

from portbench import harness

# torch's forward-mode AD (the port's Taylor linearisation in ct-batch64)
# loads its decompositions through ``torch.jit.script``, which torch marks
# deprecated: not the port's.
pytestmark = pytest.mark.filterwarnings(
    "ignore:`torch.jit.script` is deprecated:DeprecationWarning")

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, small, cuda_card):
    result = harness.run_cell(cell, 3, 1.0, True, device="cuda",
                              traffic_over=small[cell],
                              check_over={"sample": 4})
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    assert result["metrics"]
