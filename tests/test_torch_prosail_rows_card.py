"""On a card: the PROSAIL row kernel (``csrc/prosail_rows.cu``) against
its plain version at 65,536 and 1,205,760 px, and one chunk date through
``assimilate_date`` on both routes of the row loop, by chip_smoke.py's
rules (``prosail_rows_case``, ``prosail_rows_date``).  Skips without a
CUDA card (decided inside each test).  Run on the card:
``python -m pytest tests/test_torch_prosail_rows_card.py -m card``."""

import pytest

import chip_smoke as cs


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test launches the PROSAIL row "
                    "kernel")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("n", cs.PROSAIL_ROWS_SIZES)
@pytest.mark.parametrize("case", [0, 1, 2, 3, "per_pixel"])
def test_kernel_held_to_its_plain_version(n, case):
    import torch

    from kafka_tpu_torch.obsops.prosail import ProsailOperator

    dev = _card()
    x_rows = cs.prosail_rows_states(n, dev, 21)
    aux, aux64 = (cs.prosail_rows_aux(case, n, dev, 21, dt)
                  for dt in (torch.float32, torch.float64))
    rec = cs.prosail_rows_case(ProsailOperator(), x_rows, aux, aux64)
    assert rec["failures"] == []


@pytest.mark.card
def test_chunk_date_on_both_routes():
    rec = cs.prosail_rows_date(_card())
    assert rec["failures"] == []
