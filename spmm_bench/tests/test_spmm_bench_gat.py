"""The ``gat3`` model kind in a copied root with one more configuration,
``tiny-gat``: the ``reddit-gat`` model at widths (8, 8, 5) on the
3,000-node graph of :func:`spmm_bench.tests.small.tiny_root`, and its
``train`` cell, held to ``reddit-gat.train``'s limits.  On the CPU: the
model kind and its reference load by name, the weights have the
program's shapes, the configuration is checked, the new readers' sums,
and None where nothing is recorded; a run of the cell on the CPU (the
kernels' plain versions) and, on a card, a run that judges ``correct``
with the new per-layer metrics in its traced line."""
import json
import os
import shutil

import pytest
import torch

from spmm_bench import arith_gat, faults, harness, program_spans, workload
from spmm_bench.tests.small import BENCH, REPO, run, tiny_root

CELL = "tiny-gat.train"
READERS = ("gat_train_mfu", "dyn_spmm_roofline.gat",
           "edge_dots_roofline.gat")


@pytest.fixture(scope="module")
def gat_root(tmp_path_factory):
    """A root with the ``tiny-gcn`` cells and ``tiny-gat.train``."""
    root = tiny_root(str(tmp_path_factory.mktemp("gat")))
    bdir = os.path.join(root, "spmm_bench")
    with open(os.path.join(bdir, "configs", "tiny-gcn.json")) as f:
        graph = json.load(f)["graph"]
    with open(os.path.join(BENCH, "configs", "reddit-gat.json")) as f:
        cfg = json.load(f)
    cfg["name"], cfg["graph"] = "tiny-gat", graph
    cfg["model"].update(d_in=20, widths=[8, 8, 5], n_classes=5)
    with open(os.path.join(bdir, "configs", "tiny-gat.json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(BENCH, "limits", "reddit-gat.train.json"),
                os.path.join(bdir, "limits", f"{CELL}.json"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny-gat", "source": "test",
                            "file": "spmm_bench/configs/tiny-gat.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": CELL, "config": "tiny-gat",
                              "traffic": "train", "chips": 1,
                              "why": "test"})
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if "reddit-gat.train" in metric.get("workloads", ()):
            metric["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


def _md():
    with open(os.path.join(BENCH, "configs", "reddit-gat.json")) as f:
        return json.load(f)["model"]


def test_model_kind_and_reference_load_by_name():
    model = workload.load(BENCH, "models", "gat3", "model kind")
    ref = workload.load(BENCH, "reference", "gat3", "model kind")
    assert all(callable(getattr(model, f)) for f in
               ("weights", "build", "loss"))
    assert callable(ref.forward)


def test_weights_have_the_programs_names_order_and_shapes():
    from flex_tpu_torch.models.gat import GAT

    model = workload.load(BENCH, "models", "gat3", "model kind")
    md = {**_md(), "d_in": 12, "widths": [8, 8, 5], "n_classes": 5}
    ws = model.weights(md, torch.Generator().manual_seed(1), "cpu")
    prog = GAT(12, layers=model.layers(md), skip=md["skip"],
               generator=torch.Generator().manual_seed(0))
    assert [tuple(w.shape) for w in ws] == \
        [tuple(p.shape) for p in prog.parameters()]
    assert [n for n, _ in prog.named_parameters()] == \
        [f"{p}{l}{e}" for l in (1, 2, 3)
         for p, e in (("W", ""), ("a", "s"), ("a", "d"))]


@pytest.mark.parametrize("change", [{"combine": ["concat"] * 3},
                                    {"skip": 1}, {"negative_slope": 0.1},
                                    {"n_classes": 7},
                                    {"heads": [4, 4], "widths": [8, 5]}])
def test_another_architecture_is_refused(change):
    model = workload.load(BENCH, "models", "gat3", "model kind")
    with pytest.raises(ValueError, match="gat3"):
        model.layers({**_md(), **change})


def test_the_step_count_at_reddit_gat():
    md = _md()
    flops = arith_gat.gat_train_step_flops(
        232965, 23446803, md["d_in"], md["heads"], md["widths"],
        md["combine"])
    # dense forward 0.893 T, its W and H gradients 0.893 + 0.606 T, the
    # aggregations, g_B and g_alpha 3 x 0.1076 T, the scores 0.0107 T
    assert flops == pytest.approx(2.7214e12, rel=1e-4)


def _entry(path, count, device_s, **attrs):
    return {"path": path, "name": path.rsplit("/", 1)[-1], "attrs": attrs,
            "count": count, "host_s": 1e-3, "self_s": 1e-3,
            "device_s": device_s}


def _read(name, snap, rec, monkeypatch):
    monkeypatch.setattr(program_spans, "snapshot", lambda: snap)
    return harness.Bench(REPO).reader(name)(rec)


REC = {"kind": "train", "cfg": {"model": _md()}, "m": 100, "n": 100,
       "nnz": 1000, "count": 4}


def test_edge_dots_reader_weighs_each_span_by_its_widths(monkeypatch):
    snap = {"a": _entry("flex.edge_dots", 8, 2e-3, nnz=1000, k=256),
            "b": _entry("flex.edge_dots", 6, 1e-3, nnz=1000, k=41),
            "c": _entry("flex.spmm", 3, 1e-3, m=100, n=100, nnz=1000, k=8)}
    least = 8 * arith_gat.edge_dots_least_s(100, 100, 1000, 256) \
        + 6 * arith_gat.edge_dots_least_s(100, 100, 1000, 41)
    assert _read("edge_dots_roofline.gat", snap, REC, monkeypatch) == \
        pytest.approx(least / 3e-3 * 100)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("snap", [None, {}, {
    "a": _entry("flex.edge_dots", 3, 0.0, nnz=10, k=4),
    "b": _entry("flex.spmm", 3, 0.0, m=1, n=1, nnz=10, k=4),
    "c": _entry("flex.build.attention", 1, 0.0, m=1, nnz=10)}],
    ids=["no registry", "empty", "no device seconds"])
def test_readers_find_nothing_to_read(name, snap, monkeypatch):
    assert _read(name, snap, REC, monkeypatch) is None


def test_mfu_reads_only_a_traced_gat_train_run(monkeypatch):
    gcn = {**REC, "cfg": {"model": {"kind": "gcn2"}},
           "trace": {"window_s": 1.0}}
    assert _read("gat_train_mfu", {}, gcn, monkeypatch) is None
    traced = {**REC, "trace": {"window_s": 2.0}}
    md = _md()
    want = arith_gat.gat_train_step_flops(
        100, 1000, md["d_in"], md["heads"], md["widths"], md["combine"]) \
        * 4 / (2.0 * 67e12) * 100
    assert _read("gat_train_mfu", {}, traced, monkeypatch) == \
        pytest.approx(want)


def test_cell_runs_on_the_cpu(gat_root):
    line, rows = run(gat_root, CELL)
    assert line["correct"] is True, rows
    assert set(line["metrics"]) == {"train_step_ms", "setup_s"}
    line, rows = run(gat_root, CELL, trace=True)
    assert line["correct"] is True, rows
    # no device seconds on the CPU: the rooflines have nothing to read
    assert set(line["metrics"]) == {"gat_train_mfu", "device_idle.train"}


@pytest.mark.parametrize("fault", ["half_batch", "stale_state"])
def test_model_faults_are_caught(gat_root, fault):
    with faults.plant(fault):
        line, rows = run(gat_root, CELL)
    assert line["correct"] is False
    assert any(v > lim for _, v, lim in rows)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return "cuda"


@pytest.mark.cuda
def test_cell_on_the_card(gat_root, card):
    line, rows = run(gat_root, CELL, device=card)
    assert line["correct"] is True, rows
    line, rows = run(gat_root, CELL, trace=True, device=card, seconds=1.0)
    assert line["correct"] is True, rows
    got = line["metrics"]
    for name in READERS:
        assert 0 < got[name]["value"] <= 100, (name, got[name])
