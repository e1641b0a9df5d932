"""The port's span registry (``flex_tpu_torch.utils.trace``) on the CPU:
per-call spans record nothing without a profiler and record under one,
set-up spans record always, self time, the plan call's attrs, the launch's
and the dense product's annotations, one parent stack per thread,
``snapshot``/``reset``, the device events' bookkeeping (fake events
standing in for the card's), and the command line's ``spans.json``."""
import json
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flex_tpu_torch import cli, kernels
from flex_tpu_torch.io import community_graph, save_csv
from flex_tpu_torch.models.gcn import GCN
from flex_tpu_torch.ops.ell_spmm import prepare_ell, with_bwd_plan
from flex_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def fresh():
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


def _raise(*a, **k):
    raise AssertionError("called on the off path")


@pytest.fixture(scope="module")
def graph():
    return community_graph(400, 4000, n_comm=4, seed=2)


def _by_name(snap, name):
    return [e for e in snap.values() if e["name"] == name]


def test_per_call_span_off_records_nothing(monkeypatch):
    monkeypatch.setattr(trace, "_annotation", _raise)
    sp = trace.span("flex.spmm", _raise, 1, 2)
    assert sp is trace.span("inner") is trace.annotate("flex.launch")
    with sp as inner:  # one shared object
        inner.begin()
    with pytest.raises(ValueError):  # the off span lets an error through
        with trace.span("flex.spmm"):
            raise ValueError("x")
    assert trace.snapshot() == {}


def test_setup_spans_record_without_a_profiler(monkeypatch):
    monkeypatch.setattr(trace, "_annotation", _raise)
    with trace.setup_span("flex.build", m=3, nnz=4):
        with trace.setup_span("flex.build.meta"):
            pass
        with trace.span("flex.spmm"):  # off: not a parent of what follows
            with trace.setup_span("flex.build.row_tables"):
                pass
    snap = trace.snapshot()
    assert set(snap) == {"flex.build[m=3,nnz=4]",
                         "flex.build/flex.build.meta",
                         "flex.build/flex.build.row_tables"}
    top = snap["flex.build[m=3,nnz=4]"]
    assert top["count"] == 1 and top["attrs"] == {"m": 3, "nnz": 4}
    assert top["path"] == "flex.build" and top["device_s"] == 0.0


def test_spans_nest_on_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.span("flex.spmm") is not trace._OFF
        with trace.span("flex.spmm"):
            with trace.span("inner"):
                with trace.annotate("flex.launch"):  # named, not aggregated
                    time.sleep(0.002)
        with trace.setup_span("flex.build"):
            pass
    assert trace.span("flex.spmm") is trace._OFF
    names = ("flex.spmm", "inner", "flex.launch", "flex.build")
    ev = {e.name: e.time_range for e in prof.events() if e.name in names}
    assert set(ev) == set(names)
    for outer, inner in zip(names, names[1:3]):
        assert ev[outer].start <= ev[inner].start
        assert ev[inner].end <= ev[outer].end
    assert ev["flex.build"].start >= ev["flex.spmm"].end
    assert set(trace.snapshot()) == {"flex.spmm", "flex.spmm/inner",
                                     "flex.build"}


def test_self_time_is_host_time_less_the_childrens():
    trace.enable(True)
    with trace.span("flex.spmm"):
        time.sleep(0.004)
        for _ in range(2):
            with trace.span("inner"):
                time.sleep(0.003)
    snap = trace.snapshot()
    parent, child = snap["flex.spmm"], snap["flex.spmm/inner"]
    assert child["count"] == 2
    assert parent["self_s"] == pytest.approx(
        parent["host_s"] - child["host_s"], abs=1e-12)
    assert parent["self_s"] >= 0.004 and child["host_s"] >= 0.006
    assert child["self_s"] == child["host_s"]


def test_cpu_ell_plan_call_records_one_spmm(graph):
    plan = prepare_ell(graph, device="cpu")
    builds = _by_name(trace.snapshot(), "flex.build")
    assert [b["attrs"] for b in builds] == [{"m": graph.m,
                                             "nnz": graph.nnz}]
    B = torch.randn(graph.n, 8)
    plan(B)  # tracing is off
    assert not _by_name(trace.snapshot(), "flex.spmm")
    trace.enable(True)
    plan(B)
    (sp,) = _by_name(trace.snapshot(), "flex.spmm")
    assert sp["count"] == 1 and sp["path"] == "flex.spmm"
    assert sp["attrs"] == {"m": graph.m, "n": graph.n, "nnz": graph.nnz,
                           "k": 8, "dtype": "float32"}


def test_build_stages_and_the_transposed_build(graph):
    plan = with_bwd_plan(prepare_ell(graph, device="cpu"), graph.n)
    snap = trace.snapshot()
    outer = [e for e in snap.values() if e["path"] == "flex.build"]
    assert sum(e["count"] for e in outer) == 2  # forward and transposed
    stages = {e["path"] for e in snap.values()}
    for stage in ("meta", "buckets", "row_tables", "assembly"):
        assert f"flex.build/flex.build.{stage}" in stages
    # the transposed build holds the inner forward build of its pattern
    assert "flex.build/flex.build" in stages
    trace.reset()
    trace.enable(True)
    B = torch.randn(graph.n, 6, requires_grad=True)
    plan(B).sum().backward()
    (sp,) = _by_name(trace.snapshot(), "flex.spmm")
    assert sp["count"] == 2  # forward, and the transposed plan's g_B
    assert plan.bwd_plan.nnz == graph.nnz


def test_gcn_layer_annotates_its_dense_products(graph):
    plan = prepare_ell(graph, device="cpu")
    model = GCN(12, 16, 3, graph.nnz, torch.Generator().manual_seed(0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(plan, torch.randn(graph.n, 12))
    gemms = [e for e in prof.events() if e.name == "flex.gemm"]
    assert len(gemms) == 2
    assert all(any(c.name.startswith("aten::") for c in e.cpu_children)
               for e in gemms)
    assert not _by_name(trace.snapshot(), "flex.gemm")
    spmms = _by_name(trace.snapshot(), "flex.spmm")
    assert sorted(e["attrs"]["k"] for e in spmms) == [3, 12]  # A·X, A·(HW)


def test_each_thread_has_its_own_parent_stack():
    trace.enable(True)
    opened, done = threading.Event(), threading.Event()

    def other():
        assert opened.wait(timeout=30)
        with trace.span("flex.spmm"):
            with trace.span("inner"):
                pass
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with trace.span("outer"):
        opened.set()
        assert done.wait(timeout=30)
        with trace.span("inner"):
            pass
    t.join(timeout=30)
    assert not t.is_alive()
    assert set(trace.snapshot()) == {"outer", "outer/inner",
                                     "flex.spmm", "flex.spmm/inner"}


def test_threads_lose_no_update():
    trace.enable(True)
    n_threads, n_spans = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with trace.span("flex.spmm"):
                    with trace.span("inner"):
                        pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = trace.snapshot()
    assert set(snap) == {"flex.spmm", "flex.spmm/inner"}
    assert snap["flex.spmm"]["count"] == n_threads * n_spans
    assert snap["flex.spmm/inner"]["count"] == n_threads * n_spans


def test_snapshot_is_a_copy_and_reset_forgets():
    trace.enable(True)
    with trace.span("flex.spmm", lambda k: (None, {"k": k}), 8):
        pass
    snap = trace.snapshot()
    snap["flex.spmm[k=8]"]["count"] = 99
    assert trace.snapshot()["flex.spmm[k=8]"]["count"] == 1
    json.dumps(snap)
    trace.reset()
    assert trace.snapshot() == {}
    trace.enable(False)
    assert trace.span("flex.spmm") is trace._OFF


class FakeEvent:
    """A timing event whose work ends at once, or on :meth:`synchronize`
    for the events of a stream marked busy."""
    clock = [0.0]
    busy = [False]

    def __init__(self, enable_timing=False):
        self.t = None
        self.done = False

    def record(self, stream):
        FakeEvent.clock[0] += 1.0
        self.t = FakeEvent.clock[0]
        self.done = not FakeEvent.busy[0]
        self.stream = stream

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        assert self.done and end.done
        return (end.t - self.t) * 1e3  # ms: one second a clock tick


@pytest.fixture
def fake_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: "s")
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1, raising=False)
    monkeypatch.setattr(trace, "_streams", {})
    FakeEvent.clock[0], FakeEvent.busy[0] = 0.0, False
    return FakeEvent


def _cuda(*a):
    return torch.device("cuda", 0), {}


def test_device_span_marks_at_begin_and_resolves(fake_events):
    trace.enable(True)
    with trace.span("flex.spmm", _cuda) as sp:  # no mark at entry
        fake_events.clock[0] += 5.0
        with trace.span("inner"):  # a child span marks nothing
            pass
        sp.begin()  # the start mark: clock 6
    # the end mark: clock 7
    with trace.span("other", _cuda) as sp:
        fake_events.clock[0] += 5.0
        sp.begin()  # clock 13
        sp.begin()  # once only
        fake_events.busy[0] = True
    # clock 14; still pending: the snapshot waits for it
    assert len(trace._pending) == 1
    snap = trace.snapshot()
    assert snap["flex.spmm"]["device_s"] == pytest.approx(1.0)
    assert snap["other"]["device_s"] == pytest.approx(1.0)
    assert not trace._pending
    assert snap["flex.spmm"]["device_calls"] == 1


def test_finished_pairs_resolve_without_waiting(fake_events):
    trace.enable(True)
    for _ in range(50):
        with trace.span("flex.spmm", _cuda) as sp:
            sp.begin()
    assert len(trace._pending) == 1  # each resolved as the next came in
    assert len(trace._free[torch.device("cuda", 0)]) == 2  # reused
    assert trace.snapshot()["flex.spmm"]["device_s"] == pytest.approx(50.0)


def test_device_time_of_one_call_in_every_few_scaled_to_the_count(
        fake_events):
    trace.enable(True)
    every = trace.DEVICE_EVERY
    for i in range(2 * every + 3):
        with trace.span("flex.spmm", _cuda) as sp:
            sp.begin()
            fake_events.clock[0] += i  # call i: i + 1 seconds between marks
    with trace.span("other", _cuda):  # timed, but no device work
        pass
    snap = trace.snapshot()
    (sp,) = _by_name(snap, "flex.spmm")
    timed = [0, every, 2 * every]  # the first, then one in every
    assert sp["count"] == 2 * every + 3
    assert sp["device_calls"] == len(timed)
    assert sp["device_s"] == pytest.approx(
        sum(i + 1 for i in timed) / len(timed) * sp["count"])
    (other,) = _by_name(snap, "other")
    assert other["device_calls"] == 0 and other["device_s"] == 0.0


def test_each_device_records_on_its_own_stream(fake_events, monkeypatch):
    # the default stream's raw handle is 0 on every device
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda index=None: f"default stream of {index}")
    trace.enable(True)
    seen = []
    for call, index in enumerate((0, 1, 0)):
        def on(*a, index=index, call=call):  # one aggregate, one call each
            return torch.device("cuda", index), {"call": call}

        with trace.span("flex.spmm", on) as sp:
            sp.begin()
            seen.append(sp.ev0.stream)
    assert seen == ["default stream of 0", "default stream of 1",
                    "default stream of 0"]
    assert set(trace._streams) == {(0, 0), (1, 0)}


def test_launch_is_annotated(monkeypatch):
    class Lib:
        def __getattr__(self, symbol):
            return lambda *args: 0

    class Stream:
        cuda_stream = 1

    monkeypatch.setattr(kernels, "_fns", {})
    monkeypatch.setattr(kernels, "load", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda i=None: Stream)
    dev = torch.device("cuda", 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("flex.spmm"):
            kernels.launch("gespmm", "flex_gespmm_rows", dev)
    ev = {e.name: e.time_range for e in prof.events()
          if e.name in ("flex.spmm", "flex.launch")}
    assert ev["flex.spmm"].start <= ev["flex.launch"].start
    assert ev["flex.launch"].end <= ev["flex.spmm"].end
    assert set(trace.snapshot()) == {"flex.spmm"}
    monkeypatch.setattr(trace, "_annotation", _raise)
    kernels.launch("gespmm", "flex_gespmm_rows", dev)  # off: no annotation


def test_cli_trace_writes_the_spans(graph, tmp_path, capsys):
    path = str(tmp_path / "g.csv")
    save_csv(graph, path)
    td = tmp_path / "tr"
    assert cli.main([path, "8", "--method=ell", "--iters=1",
                     f"--trace={td}", "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "flex.build/flex.build.buckets" in out and "self ms" in out
    with open(td / trace.SPANS_FILE) as f:
        spans = json.load(f)
    assert _by_name(spans, "flex.spmm")[0]["attrs"]["k"] == 8
    assert _by_name(spans, "flex.build")
    assert trace.trace_table(str(td))  # the profiler's trace, not spans.json
