"""The readers of the program's spans (``program_spans.py`` and the three
metric files that read it) on hand-made snapshots: their arithmetic, None
where the snapshot lacks the span or the program has no registry, and one
traced CPU run of the tiny inference cell through the harness."""
import pytest

from spmm_bench import arith, harness, program_spans
from spmm_bench.tests.small import REPO, run

READERS = ("step_spmm_roofline.train", "spmm_host_us.infer",
           "plan_build_ms")


def _entry(path, count, host_s, device_s=0.0, **attrs):
    return {"path": path, "name": path.rsplit("/", 1)[-1], "attrs": attrs,
            "count": count, "host_s": host_s, "self_s": host_s,
            "device_s": device_s}


def _snap(*entries):
    return {f"{e['path']}{sorted(e['attrs'].items())}": e for e in entries}


SNAP = _snap(
    _entry("flex.spmm", 10, 4e-4, 2e-3, m=100, n=80, nnz=1000, k=16,
           dtype="float32"),
    _entry("flex.spmm", 10, 2e-4, 1e-3, m=80, n=100, nnz=1000, k=4,
           dtype="float32"),
    _entry("flex.spmm/flex.launch", 20, 1e-4, symbol="flex_gespmm_rows"),
    _entry("flex.gemm", 10, 1e-4, 3e-3, m=100, d=50, c=16),
    _entry("flex.build", 1, 0.050, m=100, nnz=1000),
    _entry("flex.build", 1, 0.020, m=80, nnz=1000),
    _entry("flex.build/flex.build", 1, 0.015, m=80, nnz=1000),
    _entry("flex.build/flex.build.buckets", 2, 0.030),
)
REC = {"trace": {"busy_s": 0.012, "window_s": 0.02}}


def _read(name, snap, rec=REC, monkeypatch=None):
    monkeypatch.setattr(program_spans, "snapshot", lambda: snap)
    return harness.Bench(REPO).reader(name)(rec)


def test_roofline_reader_weighs_each_call_by_its_widths(monkeypatch):
    least = 10 * (arith.spmm_least_s(100, 80, 1000, 16)
                  + arith.spmm_least_s(80, 100, 1000, 4))
    assert _read("step_spmm_roofline.train", SNAP,
                 monkeypatch=monkeypatch) == pytest.approx(least / 3e-3 * 100)


def test_spmm_host_us_is_a_calls_mean(monkeypatch):
    assert _read("spmm_host_us.infer", SNAP, monkeypatch=monkeypatch) == \
        pytest.approx(30.0)


def test_plan_build_ms_sums_the_outermost_builds(monkeypatch):
    assert _read("plan_build_ms", SNAP, monkeypatch=monkeypatch) == \
        pytest.approx(70.0)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("snap", [None, {}, _snap(
    _entry("flex.launch", 3, 1e-5, symbol="x"),
    _entry("flex.build/flex.build.buckets", 1, 1e-3))],
    ids=["no registry", "empty", "other spans"])
def test_readers_find_nothing_to_read(name, snap, monkeypatch):
    assert _read(name, snap, monkeypatch=monkeypatch) is None


def test_no_device_seconds_no_roofline(monkeypatch):
    snap = _snap(_entry("flex.spmm", 3, 1e-4, m=1, n=1, nnz=1, k=1,
                        dtype="float32"))
    assert _read("step_spmm_roofline.train", snap,
                 monkeypatch=monkeypatch) is None


def test_a_program_without_the_registry_reads_none(monkeypatch):
    from flex_tpu_torch.utils import trace

    monkeypatch.delattr(trace, "snapshot")
    assert program_spans.snapshot() is None
    assert program_spans.entries("flex.spmm") == []


def test_a_traced_cpu_run_reads_the_host_spans(tiny):
    line, _ = run(tiny, "tiny-gcn.infer", trace=True)
    got = line["metrics"]
    assert {"spmm_host_us.infer", "plan_build_ms"} <= set(got)
    assert got["spmm_host_us.infer"]["unit"] == "us"
    assert got["spmm_host_us.infer"]["value"] > 0
    assert got["plan_build_ms"]["value"] > 0
