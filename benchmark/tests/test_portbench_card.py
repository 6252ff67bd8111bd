"""On a card: a short run of each cell at its own size is correct.
Skips without a CUDA card (decided inside the test)."""

import pytest

from benchmark import harness


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in
                                  harness.manifest()["workloads"]])
def test_cell_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the cell on the card")
    r = harness.run_cell(name, 2 ** 31 + 29, 5.0, False)
    assert r["correct"] and r["device"]["platform"] == "gpu"
