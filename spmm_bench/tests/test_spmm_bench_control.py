"""The control, the plain reference in TF32 put in the program's place,
comes out not correct in every cell kind; on the card too.

On the chip at the cells' own sizes the control runs through
``calibrate.py`` (``--run control=...``); here it runs at a size a test
run holds."""
import pytest
import torch

from spmm_bench import harness, workload
from spmm_bench.tests.small import TRAFFIC, run
from spmm_bench.trace import Spans


def _control(root, cell_name, device, seed=11):
    bench = harness.Bench(root)
    cell = bench.cell(cell_name, device, lambda msg: None,
                      cache_dir=f"{root}/cache")
    w = workload.make(cell, seed)
    w.window(0.2, Spans())
    w.release()
    A = cell.reference()
    w.control(A)
    checks, _ = w.judge(A)
    limits = bench.limits(cell_name)
    return {n: (v, limits[n]) for n, v in checks.items()}


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_control_fails(tiny, traffic):
    got = _control(tiny, f"tiny-gcn.{traffic}", "cpu")
    assert any(v > lim for v, lim in got.values()), got


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("traffic", TRAFFIC)
def test_control_fails_on_the_card(tiny, card, traffic):
    got = _control(tiny, f"tiny-gcn.{traffic}", card)
    assert any(v > lim for v, lim in got.values()), got


@pytest.mark.cuda
@pytest.mark.parametrize("traffic", TRAFFIC)
@pytest.mark.parametrize("trace", [False, True])
def test_run_on_the_card(tiny, card, traffic, trace):
    line, _ = run(tiny, f"tiny-gcn.{traffic}", trace=trace, device=card)
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0
