"""The reader of ``edge_softmax_roofline.gat``: GAT's edge scores and
softmax, forward (``flex.edge_softmax``) and backward
(``flex.edge_softmax.bwd``) spans, against their least bytes
(``arith_edge_softmax``); None where the program records no such span
with device seconds, as the plain softmax's span (host time only) does."""
import pytest

from spmm_bench import arith_edge_softmax as ae
from spmm_bench.tests.test_spmm_bench_gat import REC, _entry, _read

NAME = "edge_softmax_roofline.gat"


def test_the_least_bytes_at_reddit_gat():
    m = n = 232965
    nnz = 23446803
    assert ae.edge_softmax_bytes(m, n, nnz) == (m + n + 2 * nnz) * 4
    assert ae.edge_softmax_bwd_bytes(m, n, nnz) == \
        (2 * m + 2 * n + 3 * nnz) * 4
    # about 0.14 ms a head, forward and backward together
    both = ae.edge_softmax_least_s(m, n, nnz) \
        + ae.edge_softmax_least_s(m, n, nnz, backward=True)
    assert both == pytest.approx(0.14165e-3, rel=1e-4)


def test_reader_weighs_forward_and_backward_by_their_bytes(monkeypatch):
    snap = {"a": _entry("flex.edge_softmax", 14, 4e-3, m=100, nnz=1000),
            "b": _entry("flex.edge_softmax.bwd", 14, 6e-3, m=100,
                        nnz=1000),
            "c": _entry("flex.edge_dots", 14, 1e-3, nnz=1000, k=256)}
    least = 14 * ae.edge_softmax_least_s(100, 100, 1000) \
        + 14 * ae.edge_softmax_least_s(100, 100, 1000, backward=True)
    assert _read(NAME, snap, REC, monkeypatch) == \
        pytest.approx(least / 10e-3 * 100)


@pytest.mark.parametrize("snap", [None, {}, {
    "a": _entry("flex.edge_softmax", 14, 0.0, m=100, nnz=1000),
    "b": _entry("flex.edge_dots", 14, 1e-3, nnz=1000, k=256)}],
    ids=["no registry", "empty", "the plain softmax's span"])
def test_reader_finds_nothing_to_read(snap, monkeypatch):
    assert _read(NAME, snap, REC, monkeypatch) is None
