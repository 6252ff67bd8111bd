"""On a card: the GP emulator bank's row kernel (``csrc/gp_rows.cu``)
against its plain version at 65,536 and 4,822,528 px on the banks of
the benchmark's eight geometries (fitted by the cell's scenario), one
date through ``assimilate_date`` on both routes of the row loop, and
one chunk of the cell through ``KalmanFilter.run`` with one launch a
Gauss-Newton trip, by chip_smoke.py's rules (``gp_rows_case``,
``gp_rows_date``, ``phase_main_gp``).  Skips without a CUDA card
(decided inside each test).  Run on the card:
``python -m pytest tests/test_torch_gp_rows_card.py -m card``."""

import pytest

import chip_smoke as cs
from benchmark import harness
from benchmark.scenarios import s2_gp_bank

EMULATORS = harness.cell(cs.GP_CELL)["config"]["emulators"]


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test launches the GP row kernel")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def banks():
    return list(s2_gp_bank.fit_banks(EMULATORS, cs.GP_SEED,
                                     _card()).values())


@pytest.mark.card
@pytest.mark.parametrize("n", cs.GP_ROWS_SIZES)
@pytest.mark.parametrize("geometry",
                         range(len(s2_gp_bank.geometries(EMULATORS))))
def test_kernel_held_to_its_plain_version(banks, n, geometry):
    from kafka_tpu_torch.obsops.gp import GPBankOperator

    x_rows = cs.prosail_rows_states(n, _card(), 22)
    rec = cs.gp_rows_case(GPBankOperator(10, 10), banks[geometry], x_rows)
    assert rec["failures"] == []


@pytest.mark.card
def test_date_on_both_routes(banks):
    rec = cs.gp_rows_date(_card(), banks[0])
    assert rec["failures"] == []


@pytest.mark.card
def test_chunk_through_the_filter_one_launch_a_trip():
    rec, _ = cs.phase_main_gp(_card())
    assert rec["kernel_launches"]["gp_rows"] == rec["trips"] > 0
    assert rec["correct"] and rec["banks_npz_equal"]
