"""Each fault a cell can have, planted underneath a whole run (the look
for a card left out, on the CPU at a small size), turns ``correct``
false; the same run without it is correct."""
import pytest

from spmm_bench import faults, workload
from spmm_bench.tests.small import BENCH, TRAFFIC, run

KIND = {"spmm": "stream", "train": "train", "infer": "infer"}
CASES = [(t, f) for t in TRAFFIC
         for f in workload.load(BENCH, "kinds", KIND[t], "kind").FAULTS]


@pytest.mark.parametrize("traffic,fault", CASES)
def test_fault_is_caught(tiny, traffic, fault):
    with faults.plant(fault):
        line, rows = run(tiny, f"tiny-gcn.{traffic}")
    assert line["correct"] is False
    assert any(v > lim for _, v, lim in rows)


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_sound_run_is_correct(tiny, traffic):
    line, rows = run(tiny, f"tiny-gcn.{traffic}")
    assert line["correct"] is True
    assert all(v <= lim for _, v, lim in rows)


def test_faults_are_removed_on_exit():
    from flex_tpu_torch.models import common
    from flex_tpu_torch.ops import ell_spmm

    before = ell_spmm._ell_raw_call, common.masked_xent
    for f in faults.FAULTS:
        with faults.plant(f):
            pass
    assert (ell_spmm._ell_raw_call, common.masked_xent) == before


def test_each_kinds_faults_are_known():
    for kind in KIND.values():
        fs = workload.load(BENCH, "kinds", kind, "kind").FAULTS
        assert fs and set(fs) <= set(faults.FAULTS)
