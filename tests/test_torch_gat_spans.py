"""The spans of the GAT path (``ops/dyn_ell.py``, ``models/gat.py``) on
the CPU after ``trace.enable(True)``: one forward and backward of the
dynamic-value SpMM records ``flex.spmm`` twice (m, n, nnz, k) and g_vals
``flex.edge_dots`` (nnz, k), both marking their device work (fake CUDA
events standing in for the card's); the attention's scores and softmax
(``DynEllPlan.edge_attention``) record ``flex.edge_softmax`` and its
backward ``flex.edge_softmax.bwd`` (m, nnz), both marking their device
work too; the plain ``edge_softmax`` records ``flex.edge_softmax`` (m,
nnz) with host time only; ``prepare_attention`` records the set-up
span ``flex.build.attention`` (m, nnz), which the benchmark's
``plan_build_ms`` does not count; off, the per-call spans record
nothing."""
import pytest
import torch

from flex_tpu_torch.io import community_graph
from flex_tpu_torch.models.gat import (
    GAT, edge_softmax, gat_loss, prepare_attention,
)
from flex_tpu_torch.ops import dyn_ell
from flex_tpu_torch.ops.dyn_ell import prepare_dyn_ell
from flex_tpu_torch.ops.ell_spmm import prepare_ell
from flex_tpu_torch.utils import trace
from spmm_bench import program_spans
from test_torch_trace import fake_events  # noqa: F401  (a fixture)

K = 6


@pytest.fixture(autouse=True)
def fresh():
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


@pytest.fixture(scope="module")
def graph():
    return community_graph(500, 6000, n_comm=4, seed=3)


def _named(name):
    return [e for e in trace.snapshot().values() if e["name"] == name]


def _forward_backward(g, attention=False):
    """One dynamic SpMM forward and backward; with ``attention``, its
    values from the plan's edge attention, whose backward runs too."""
    plan = prepare_dyn_ell(g, device="cpu")
    gen = torch.Generator().manual_seed(0)
    vals = torch.rand(g.nnz, generator=gen).requires_grad_(True)
    if attention:
        s = torch.randn((2, g.m), generator=gen).requires_grad_(True)
        vals = plan.edge_attention(s[0], s[1])
    B = torch.randn((g.n, K), generator=gen).requires_grad_(True)
    plan(vals, B).sum().backward()
    return plan


def test_dynamic_spmm_records_both_kernel_calls_and_g_vals(graph):
    trace.enable(True)
    _forward_backward(graph)
    spmm = _named("flex.spmm")
    # forward (m rows from n) and g_B (n rows from m): one square graph,
    # so one aggregate of two calls
    assert [(e["attrs"], e["count"]) for e in spmm] == [
        ({"m": graph.m, "n": graph.n, "nnz": graph.nnz, "k": K}, 2)]
    dots = _named("flex.edge_dots")
    assert [(e["attrs"], e["count"]) for e in dots] == [
        ({"nnz": graph.nnz, "k": K}, 1)]
    assert all(e["path"] == e["name"] for e in spmm + dots)


@pytest.mark.parametrize("k", [4, 5])
def test_edge_dots_records_the_width_it_was_given(graph, k):
    """At k % 4 == 0 the gathers take a zero column more; the span keeps
    the width of g and B as given."""
    trace.enable(True)
    plan = prepare_dyn_ell(graph, device="cpu")
    g = torch.ones((graph.m, k))
    plan.edge_dots(g, torch.ones((graph.n, k)))
    assert [e["attrs"] for e in _named("flex.edge_dots")] == [
        {"nnz": graph.nnz, "k": k}]


def test_spans_time_their_device_work(graph, fake_events, monkeypatch):
    """Each call's spans mark their device work: with the describe
    functions naming a CUDA device, every span has device seconds, the
    attention's forward and backward too."""
    for name in ("_spmm_attrs", "_dots_attrs", "_softmax_attrs"):
        orig = getattr(dyn_ell, name)
        monkeypatch.setattr(dyn_ell, name, lambda *a, orig=orig: (
            torch.device("cuda", 0), orig(*a)[1]))
    trace.enable(True)
    _forward_backward(graph, attention=True)
    snap = trace.snapshot()
    timed = {e["name"]: e for e in snap.values() if e["device_s"] > 0}
    assert set(timed) == {"flex.spmm", "flex.edge_dots",
                          "flex.edge_softmax", "flex.edge_softmax.bwd"}
    # the first call of an aggregate is timed
    for name in timed:
        assert timed[name]["device_calls"] == 1, name
    assert timed["flex.edge_softmax"]["attrs"] == \
        timed["flex.edge_softmax.bwd"]["attrs"] == {"m": graph.m,
                                                    "nnz": graph.nnz}


def test_edge_softmax_records_its_span(graph):
    ag = prepare_attention(graph, device="cpu")
    trace.enable(True)
    edge_softmax(ag, torch.zeros(graph.nnz))
    soft = _named("flex.edge_softmax")
    assert [(e["attrs"], e["count"], e["device_s"]) for e in soft] == [
        ({"m": graph.m, "nnz": graph.nnz}, 1, 0.0)]


def test_a_gat_step_records_every_head(graph):
    """Two layers of three heads: six softmaxes and their six backwards,
    six forwards and six g_B calls, six g_vals; the dense products are
    annotations, no span."""
    ag = prepare_attention(graph, device="cpu")
    model = GAT(8, 4, 3, n_heads=3,
                generator=torch.Generator().manual_seed(1))
    X = torch.randn((graph.m, 8), generator=torch.Generator().manual_seed(2))
    y = torch.zeros(graph.m, dtype=torch.long)
    trace.reset()  # the set-up spans of prepare_attention
    trace.enable(True)
    gat_loss(model, ag, X, y, torch.ones(graph.m)).backward()
    counts = {}
    for e in trace.snapshot().values():
        counts[e["name"]] = counts.get(e["name"], 0) + e["count"]
    assert counts == {"flex.edge_softmax": 6, "flex.edge_softmax.bwd": 6,
                      "flex.spmm": 12, "flex.edge_dots": 6}


def test_off_the_per_call_spans_record_nothing(graph):
    ag = prepare_attention(graph, device="cpu")
    _forward_backward(graph, attention=True)
    edge_softmax(ag, torch.zeros(graph.nnz))
    # only set-up spans, which record always
    assert {e["name"] for e in trace.snapshot().values()} == {
        "flex.build.attention", "flex.build.row_tables"}


def test_prepare_attention_is_a_setup_span_apart_from_plan_builds(graph):
    prepare_attention(graph, device="cpu")  # recorded though not enabled
    att = _named("flex.build.attention")
    assert [(e["path"], e["attrs"], e["count"]) for e in att] == [
        ("flex.build.attention", {"m": graph.m, "nnz": graph.nnz}, 1)]
    assert att[0]["host_s"] > 0
    # its stages nest under it
    assert any(e["path"].startswith("flex.build.attention/")
               for e in trace.snapshot().values())
    assert program_spans.plan_build_ms({}) is None
    prepare_ell(graph, device="cpu")
    ell = [e for e in _named("flex.build") if e["path"] == "flex.build"]
    assert len(ell) == 1
    assert program_spans.plan_build_ms({}) == pytest.approx(
        ell[0]["host_s"] * 1e3)
