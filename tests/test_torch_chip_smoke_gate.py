"""chip_smoke.py's gates and their inputs, on the CPU with made-up
outputs.  The fused Gauss-Newton kernel must give the float32 plain
version's trips and verdicts, except on a group whose trips the plain
version's own 1-ulp nudge of x_f moves, where the nudged or the float64
count is accepted too.  The packed solve must match its plain version
bit for bit, NaN equal to NaN at the same places."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from kafka_tpu_torch.core.solve_rows import solve_rows_plain  # noqa: E402

BLOCK, GROUPS = 4, 3


def _raw(trips, verdicts):
    """Raw outputs with the given per-group trips and per-pixel verdicts
    (only st and hl matter to the gate)."""
    n = BLOCK * GROUPS
    st = torch.zeros(2, n)
    st[0] = torch.tensor(trips, dtype=torch.float32).repeat_interleave(BLOCK)
    hl = torch.zeros(9, n)
    hl[0] = torch.tensor(verdicts, dtype=torch.float32)
    return [None, None, None, None, st, hl]


V = [1.0] * (BLOCK * GROUPS)
PLAIN = _raw([3, 4, 2], V)
REF = _raw([3, 5, 2], V)
NUDGED = [_raw([3, 5, 2], V), _raw([3, 4, 2], V)]  # moves group 1 only


@pytest.mark.parametrize("kernel_trips,differing,waived", [
    ([3, 4, 2], 0, 0),   # the float32 plain version's trips
    ([3, 5, 2], 0, 1),   # group 1 follows the nudge / float64
    ([3, 6, 2], 1, 0),   # group 1 matches no reference
    ([4, 4, 2], 1, 0),   # group 0 is steady under the nudge: no waiver
])
def test_trip_gate_waives_only_rounding_decided_groups(kernel_trips,
                                                       differing, waived):
    got = cs.held_trips(_raw(kernel_trips, V), PLAIN, REF, NUDGED, BLOCK)
    assert got["rounding_decided_groups"] == 1
    assert (got["groups_differing"], got["groups_waived"]) == (differing,
                                                              waived)
    assert got["verdicts_differing"] == got["verdicts_waived"] == 0


def test_verdict_gate_waives_only_pixels_of_decided_groups():
    plain = _raw([3, 4, 2], V)
    ref_v = list(V)
    ref_v[BLOCK] = ref_v[0] = 2.0  # pixel 0 of groups 0 and 1
    ref = _raw([3, 5, 2], ref_v)
    kern = _raw([3, 4, 2], ref_v)
    got = cs.held_trips(kern, plain, ref, NUDGED, BLOCK)
    assert (got["verdicts_differing"], got["verdicts_waived"]) == (1, 1)


def test_group_case_rows_leave_every_other_group_unobserved():
    n = 8 * 257  # 8-px groups: gcd(2056, 2048)
    rows, observed = cs.group_case_rows(n, 2e-3, torch.device("cpu"))
    assert observed.tolist() == [g % 2 == 0 for g in range(257)]
    unobserved = (torch.arange(n) // 8) % 2 == 1
    assert rows["mask_f"][:, ~unobserved].any()
    assert (rows["mask_f"][:, unobserved] == 0).all()
    assert (rows["r_inv"][:, unobserved] == 0).all()
    assert rows["y"][:, unobserved].isnan().all()
    assert (rows["tol"], rows["relaxation"]) == (2e-3, cs.GROUP_RELAXATION)


NAN = float("nan")


@pytest.mark.parametrize("kern,plain,differing", [
    ([[1.0, 2.0, NAN], [3.0, NAN, 4.0]],
     [[1.0, 2.0, NAN], [3.0, NAN, 4.0]], 0),   # NaN at the same places
    ([[1.0, 2.0, NAN], [3.0, 5.0, 4.0]],
     [[1.0, 2.0, NAN], [3.0, NAN, 4.0]], 1),   # NaN in one only
    ([[NAN, 2.0, 3.0], [3.0, 4.0, 4.0]],
     [[1.0, NAN, 3.0], [3.0, 4.0, 4.0]], 2),   # NaN at other places
    ([[1.0, 2.0, 3.0], [0.0, 4.0, 4.0]],
     [[1.0, 2.0, 3.0000002], [-0.0, 4.0, 4.0]], 2),  # 1 ulp; signed zero
])
def test_solve_gate_counts_pixels_whose_bits_differ(kern, plain, differing):
    a, b = torch.tensor(kern), torch.tensor(plain)
    assert cs.pixels_differing(a, b) == differing
    assert cs.pixels_differing(b, a) == differing
    assert cs.pixels_differing(a, a.clone()) == 0


def test_planted_solve_faults_are_non_finite_in_the_plain_version():
    a, b = cs.spd_rows(7, 300, torch.device("cpu"), seed=3)
    planted_a, planted = cs.plant_solve_faults(a, 7, n_each=8)
    x = solve_rows_plain(planted_a, b)
    bad = ~torch.isfinite(x).all(dim=0)
    hit = torch.cat(list(planted.values()))
    assert hit.unique().numel() == 16
    assert bad[hit].all() and int(bad.sum()) == 16
    assert torch.equal(planted_a[:, ~bad], a[:, ~bad])
