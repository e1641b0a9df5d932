"""The port's bench layer against the JAX package, on the CPU at small
sizes: ``FlexConfig``, ``bench_spmm`` and its ``BenchResult`` row,
``sweep`` and ``write_csv``, the serial chain and trace columns,
``utils.trace`` on ``torch.profiler``, ``classify_op`` on the hand
kernels' device-function names, ``res_check2``, ``bench_gcn_layer``,
``StageTimer``, ``utils.device_info``, and the autotuner: ``suggest``'s
eligibility gates and model inputs equal the JAX version's (the band
window statistics, the budgeted window selection, the tile statistics),
its method equals the JAX one where eligibility decides, and elsewhere it
is the cheapest candidate of its own model (the rates differ by design:
the port's are the card's)."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import flex_tpu.io.synth as jsynth
from flex_tpu.bench.autotune import suggest as j_suggest
from flex_tpu.bench.gcn_bench import pick_association as j_pick_association
from flex_tpu.bench.harness import bench_spmm as j_bench_spmm
from flex_tpu.config import FlexConfig as JFlexConfig
from flex_tpu.ops.pallas_band import panel_window_stats as j_panel_window_stats
from flex_tpu.ops.window_spmm import window_select as j_window_select
from flex_tpu.reorder import reorder as j_reorder
from flex_tpu.tiling.stats import tile_stats as j_tile_stats
from flex_tpu.utils.check import res_check2 as j_res_check2

import flex_tpu_torch.bench.autotune as autotune_mod
import flex_tpu_torch.io.synth as tsynth
from flex_tpu_torch import kernels
from flex_tpu_torch.bench.autotune import autotune, suggest
from flex_tpu_torch.bench.gcn_bench import bench_gcn_layer
from flex_tpu_torch.bench.harness import (
    BenchResult, _fmt, bench_spmm, sweep, write_csv,
)
from flex_tpu_torch.config import FlexConfig
from flex_tpu_torch.ops.pallas_band import panel_window_stats
from flex_tpu_torch.ops.window_spmm import window_select
from flex_tpu_torch.reorder import reorder
from flex_tpu_torch.tiling.stats import tile_stats
from flex_tpu_torch.utils import device_info
from flex_tpu_torch.utils.check import res_check2
from flex_tpu_torch.utils.trace import (
    StageTimer, classify_op, format_trace_table, trace, trace_summary,
    trace_table,
)

# -- FlexConfig ---------------------------------------------------------------

FLAG_SETS = [
    ["a.csv", "64"],
    ["a.csv", "64", "--order=rcm", "--method=ell", "--widths=4,8,16",
     "--check=false", "--tm=256"],
    ["g.csv", "--method=windowed", "--min_count=64", "--J=512", "--W=256",
     "--transposed", "--b_dtype=bfloat16"],
    ["g.csv", "41", "--method=panel", "--hub-threshold=100",
     "--hub_width=1024", "--iters=3", "--csv=o.csv", "--trace=t"],
    ["--order-file=p.npy", "--check=0", "--method=band", "x.csv"],
]


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("device", None)
    return d


@pytest.mark.parametrize("argv", FLAG_SETS)
def test_config_from_args_matches_jax(argv):
    cfg, pos = FlexConfig.from_args(argv)
    jcfg, jpos = JFlexConfig.from_args(argv)
    assert pos == jpos
    assert _fields(cfg) == _fields(jcfg)
    assert cfg.device == "cuda"
    for method in ("ell", "panel", "windowed", "band", "xla", "bcoo",
                   "gespmm"):
        assert cfg.prep_kwargs(method) == jcfg.prep_kwargs(method)


def test_config_device_flag_and_refusals():
    cfg, _ = FlexConfig.from_args(["--device=cpu"])
    assert cfg.device == "cpu" and "device" in cfg.explicit
    for bad in (["--nope=1"], ["--explicit=x"], ["--tm"]):
        with pytest.raises(SystemExit):
            FlexConfig.from_args(bad)
        with pytest.raises(SystemExit):
            JFlexConfig.from_args(bad)
    assert set(f.name for f in dataclasses.fields(FlexConfig)) == set(
        f.name for f in dataclasses.fields(JFlexConfig)) | {"device"}


# -- bench_spmm ---------------------------------------------------------------

def _graphs(fn, **kw):
    return getattr(tsynth, fn)(**kw), getattr(jsynth, fn)(**kw)


@pytest.fixture(scope="module")
def community():
    return _graphs("community_graph", m=2048, nnz_target=60_000, n_comm=4,
                   seed=1, shuffle=False)


@pytest.fixture(scope="module")
def banded():
    return _graphs("banded_graph", m=8192, bandwidth=96, avg_degree=12.0,
                   seed=4)


# keys the JAX row has that a CPU run of the port does not write:
# hbm_frac is the share of a device's memory rate, which a CPU run has not
# got (the JAX package writes its TPU figure on any backend)
DEVICE_ONLY_KEYS = {"hbm_frac"}
# differences by design (ROADMAP.md §3): the port's "xla" plan pads no
# edges, so its byte model counts fewer bytes than the JAX plan's; its
# "bcoo" plan is a CSR tensor, whose stats and byte model say so
MODEL_KEYS = ("model_gb", "ai_model", "b_reuse")
BY_DESIGN = {(m, key) for m in ("xla", "bcoo") for key in MODEL_KEYS} | {
    ("bcoo", "fmt_format")}


@pytest.fixture(scope="module")
def hub_deg():
    t, j = _graphs("hub_graph", m=3000, nnz_target=60_000, n_hub_cols=64,
                   seed=1)
    return reorder(t, "deg", check=False), j_reorder(j, "deg", check=False)


@pytest.mark.parametrize("method,kw", [
    ("xla", {}), ("bcoo", {}), ("ell", {}), ("gespmm", {}),
    ("windowed", dict(min_count=16)), ("panel", {}),
])
def test_bench_spmm_row_matches_jax(method, kw, community, hub_deg):
    # panel needs a hub-prefix ordering
    t, j = hub_deg if method == "panel" else community
    r = bench_spmm(t, 16, method=method, iters=2, chain=False, device="cpu",
                   **kw)
    jr = j_bench_spmm(j, 16, method=method, iters=2, chain=False, **kw)
    assert isinstance(r, BenchResult)
    assert r.check.err_frac == 0.0 and r.check.ok
    row, jrow = r.row(), jr.row()
    assert set(jrow) - DEVICE_ONLY_KEYS <= set(row)
    assert "hbm_frac" not in row and row["device"] == "cpu"
    for key in jrow:
        if (method, key) in BY_DESIGN:
            assert key in row
        elif key.startswith("fmt_") or key in MODEL_KEYS + (
                "graph", "order", "method", "k", "m", "nnz"):
            assert row[key] == jrow[key], key
    if method == "xla":
        assert row["model_gb"] <= jrow["model_gb"]
    assert r.t_elap > 0 and r.gflops > 0 and r.t_pre > 0
    assert ("t_upload_s" in row) == ("t_upload_s" in jrow)
    assert "err=0.00e+00" in _fmt(r)


def test_bench_spmm_chain_trace_and_refusal(community, banded, tmp_path):
    t, _ = community
    r = bench_spmm(t, 8, method="ell", iters=2, device="cpu",
                   trace_dir=str(tmp_path / "tr"))
    # chain: on by default below 5 M nonzeros
    # (a loaded host can round the CPU's GF/s to 0.0)
    assert r.extra["t_chain_us"] > 0 and r.extra["gflops_chain"] >= 0
    assert r.extra["trace_cpu_ms"] > 0 and "trace_device_ms" not in r.extra
    assert r.extra["trace_dir"] == str(tmp_path / "tr")
    assert os.listdir(tmp_path / "tr")
    assert "chain=" in _fmt(r) and "trace=" in _fmt(r)
    r = bench_spmm(t, 8, method="xla", iters=2, device="cpu", trace=True)
    assert "t_chain_us" not in r.extra and "trace_dir" not in r.extra
    assert r.extra["trace_cpu_ms"] > 0
    with pytest.raises(ValueError):   # not banded: band refuses
        bench_spmm(t, 8, method="band", iters=2, device="cpu")
    bt, bj = banded
    B = np.ones((bt.n, 8), np.float32)
    r = bench_spmm(bt, 8, method="band", B=B, iters=2, device="cpu",
                   chain=False, check=False)
    assert r.check is None and r.row()["err_frac"] is None


def test_bench_spmm_never_falls_back_to_the_cpu(community, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_spmm(community[0], 8, method="ell", iters=1)


def test_sweep_and_write_csv(tmp_path):
    import csv

    # uniform sparsity: band refuses it, windowed at tm=128 too
    t, _ = _graphs("uniform_graph", m=2000, nnz_target=20_000, seed=2)
    path = str(tmp_path / "sweep.csv")
    res = sweep(t, ks=(8,), orders=("ovo", "deg"),
                methods=("xla", "ell", "band", "windowed"), tms=(128, 256),
                csv_path=path, iters=2, device="cpu")
    # per order: xla, ell, band x 2 tile heights, windowed x 2
    assert len(res) == 2 * 6
    refused = [r for r in res if r.check is None]
    assert all(r.extra["error"].startswith("ValueError") for r in refused)
    assert {(r.method, r.extra["tm"]) for r in refused} >= {
        ("band", 128), ("band", 256), ("windowed", 128)}
    ok = [r for r in res if r.check is not None]
    assert all(r.check.err_frac == 0.0 for r in ok)
    assert {(r.order, r.method) for r in ok} >= {
        (o, m) for o in ("OVO", "DEG") for m in ("xla", "ell")}
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == len(res)
    assert rows[0]["graph"] == t.name and "error" in rows[0]
    write_csv(res[:1], str(tmp_path / "one.csv"))
    assert open(tmp_path / "one.csv").read().startswith("graph,order,")


# -- trace --------------------------------------------------------------------

def test_trace_and_trace_table_on_the_cpu(tmp_path):
    a = torch.rand(64, 64)
    idx = torch.arange(0, 64, 2)
    with trace(str(tmp_path), device="cpu"):
        b = torch.mm(a, a)
        c = torch.index_select(b, 0, idx)
        torch.zeros(64, 64).index_add_(0, idx, c)
    rows = trace_table(str(tmp_path))
    ops = {r["op"] for r in rows}
    assert {"aten::mm", "aten::index_select", "aten::index_add_"} <= ops
    assert rows == sorted(rows, key=lambda r: -r["total_ms"])
    s = trace_summary(str(tmp_path))
    assert {"dot", "gather", "scatter"} <= set(s["class_ms"])
    assert s["device_total_ms"] == pytest.approx(
        sum(r["total_ms"] for r in rows), abs=1e-2)
    text = format_trace_table(rows, top=3)
    assert len(text.splitlines()) == 4 and text.startswith("op")
    assert trace_table(str(tmp_path / "empty")) == []


def test_trace_table_reads_the_card_events_first(tmp_path):
    """A trace with kernel events is read from those alone."""
    import json

    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 50.0},
          {"ph": "X", "cat": "kernel", "dur": 10.0,
           "name": "void (anonymous namespace)::rows_kernel<4>(int const*)"},
          {"ph": "X", "cat": "kernel", "dur": 30.0,
           "name": "void (anonymous namespace)::rows_kernel<4>(int const*)"},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 5.0},
          {"ph": "i", "cat": "kernel", "name": "instant"}]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": ev}))
    rows = trace_table(str(tmp_path))
    assert [(r["count"], r["total_ms"]) for r in rows] == [(2, 0.04),
                                                           (1, 0.005)]
    assert "rows_kernel<4>" in rows[0]["op"]
    assert rows[1]["op"] == "Memcpy HtoD"
    assert trace_summary(str(tmp_path))["class_ms"] == {"dot": 0.04,
                                                        "copy": 0.005}


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::window_spmm_kernel<128, 3, true>(float "
     "const*, float const*, int const*, int const*, float*, int, int)", "dot"),
    ("(anonymous namespace)::window_spmm_t_kernel<64, 16>(float const*)",
     "dot"),
    ("void (anonymous namespace)::window_bwd_gA_kernel<false>(float const*)",
     "dot"),
    ("window_bwd_gB_kernel<48>", "dot"),
    ("void (anonymous namespace)::band_kernel<true, 128>(float const*)",
     "dot"),
    ("void (anonymous namespace)::rows_kernel<8>(int const*, float const*)",
     "dot"),
    ("void (anonymous namespace)::rows_reduce_kernel(float const*)", "dot"),
    ("void reduce_partials_kernel<float, 256>(float const*, float*)", "dot"),
    ("void reduce_partials_strided_kernel<float>(float const*)", "dot"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32", "dot"),
    ("ampere_sgemm_128x64_nn", "dot"),
    ("aten::bmm", "dot"), ("aten::mm", "dot"),
    ("void at::native::(anonymous namespace)::indexSelectLargeIndex<float>",
     "gather"),
    ("aten::index_select", "gather"),
    ("void at::native::index_elementwise_kernel<128, 4>", "gather"),
    ("aten::index_add_", "scatter"),
    ("void at::native::indexFuncLargeIndex<float, long>", "scatter"),
    ("aten::index_copy_", "scatter"),
    ("aten::scatter_add_", "scatter"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("aten::copy_", "copy"), ("aten::cat", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, FillFunctor<float>>",
     "other"),
])
def test_classify_op(name, cls):
    assert classify_op(name) == cls


# -- checks, GCN bench, stage timer, device info ------------------------------

@pytest.mark.parametrize("tol", [1e-3, 0.01, 0.5])
def test_res_check2_matches_jax(tol):
    rng = np.random.default_rng(3)
    gold = rng.standard_normal((200, 16)).astype(np.float32)
    res = gold + rng.standard_normal(gold.shape).astype(np.float32) * 0.01
    got, want = res_check2(gold, res, tol), j_res_check2(gold, res, tol)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert res_check2(gold[:0], res[:0]).err_frac == 0.0


@pytest.mark.parametrize("d,c", [(32, 7), (16, 41)])
def test_bench_gcn_layer_on_the_cpu(d, c, community):
    t, _ = community
    r = bench_gcn_layer(t, d, c, method="ell", iters=2, device="cpu")
    assert r.cross_err_frac == 0.0 and r.scipy_err_frac == 0.0
    assert r.auto_choice == j_pick_association(t.m, t.nnz, d, c)
    assert r.t_axw > 0 and r.t_ax_w > 0 and r.c == c
    assert set(r.gflops(t.nnz, t.m)) == {"axw", "ax_w"}
    # c defaults to the dataset's label width
    assert bench_gcn_layer(t, 8, method="xla", iters=1, check=False,
                           device="cpu").c == t.label_width


def test_stage_timer():
    st = StageTimer()
    with st.stage("a"):
        StageTimer.sync(torch.ones(3))
    with pytest.raises(RuntimeError):
        with st.stage("b"):
            raise RuntimeError("x")
    assert set(st.stages) == {"a", "b"}
    assert "total" in st.report()


def test_device_info_on_the_cpu(monkeypatch):
    info = device_info.device_info("cpu")
    assert info[0]["platform"] == "cpu"
    assert "device 0: cpu/" in device_info.device_banner("cpu")
    assert device_info.peaks_for("NVIDIA H100 80GB HBM3") == {
        "fp32": 67e12, "bytes": 3.35e12}
    assert device_info.peaks_for("NVIDIA H100 PCIe")["fp32"] == 51e12
    with pytest.raises(RuntimeError):
        device_info.peaks_for("NVIDIA A100-SXM4-80GB")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        device_info.device_info()
    monkeypatch.setattr(device_info.subprocess, "run",
                        lambda *a, **k: (_ for _ in ()).throw(OSError()))
    assert device_info.smi_query(0) is None


def test_launch_counts_name_every_wrapper():
    counts = kernels.launch_counts()
    assert len(counts) == 8 and "gespmm_rows" in counts
    assert "gespmm_rows_bf16" in counts  # kernel 7's bf16 instance
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}


# -- the autotuner ------------------------------------------------------------

def _suggest_graphs():
    tiny = _graphs("rmat_graph", m=48, nnz_target=300, seed=1)
    banded = _graphs("banded_graph", m=8192, bandwidth=96, avg_degree=12.0,
                     seed=4)
    ht, hj = _graphs("hub_graph", m=6000, nnz_target=200_000,
                     n_hub_cols=64, seed=1)
    hub = (reorder(ht, "deg", check=False), j_reorder(hj, "deg",
                                                      check=False))
    comm = _graphs("community_graph", m=6000, nnz_target=300_000, n_comm=6,
                   seed=1, shuffle=False)
    unif = _graphs("uniform_graph", m=8000, nnz_target=160_000, seed=1)
    return {"tiny": tiny, "banded": banded, "hub": hub, "community": comm,
            "uniform": unif}


@pytest.fixture(scope="module")
def suggest_graphs():
    return _suggest_graphs()


@pytest.mark.parametrize("name", ["tiny", "banded", "hub", "community",
                                  "uniform"])
@pytest.mark.parametrize("k", [128, 41])
def test_suggest_gates_and_inputs_match_jax(name, k, suggest_graphs):
    t, j = suggest_graphs[name]
    s, js = suggest(t, k), j_suggest(j, k)
    if name in ("tiny", "banded"):   # eligibility decides
        assert (s.method, s.prep_kwargs) == (js.method, js.prep_kwargs)
        assert s.method == {"tiny": "xla", "banded": "band"}[name]
        return
    # the same candidates pass the gates ...
    assert set(s.model) == set(js.model)
    assert s.method == min(s.model, key=s.model.get)
    # ... on the same statistics
    ws, wp, dens, nbytes = panel_window_stats(t, 256)
    jws, jwp, jdens, jnbytes = j_panel_window_stats(j, 256)
    np.testing.assert_array_equal(ws, jws)
    assert (wp, dens, nbytes) == (jwp, jdens, jnbytes)
    sel = window_select(t, tm=256, W=128, min_count=48,
                        max_dense_bytes=8 << 30)
    jsel = j_window_select(j, tm=256, W=128, min_count=48,
                           max_dense_bytes=8 << 30)
    for key in ("coverage", "total_steps", "n_res", "G", "min_count_eff",
                "dense_bytes"):
        assert sel[key] == jsel[key], key
    assert tile_stats(t, 128).__dict__ == j_tile_stats(j, 128).__dict__
    if s.method == "windowed":
        assert s.prep_kwargs["sel"]["total_steps"] == sel["total_steps"]
        assert s.prep_kwargs.get("transposed", False) == (k < 128)


def test_suggest_passes_explicit_window_knobs(suggest_graphs):
    t, j = suggest_graphs["community"]
    s = suggest(t, 128, win_tm=512, win_W=256, win_min_count=16,
                max_dense_bytes=1 << 30)
    js = j_suggest(j, 128, win_tm=512, win_W=256, win_min_count=16,
                   max_dense_bytes=1 << 30)
    assert set(s.model) == set(js.model)
    if s.method == "windowed":
        assert {k: s.prep_kwargs[k] for k in ("tm", "W", "min_count")} == {
            "tm": 512, "W": 256, "min_count": 16}


def test_k_factor_is_the_line_through_the_measured_widths():
    kf = autotune_mod._k_factor
    for ratio in (autotune_mod.ELL_K41_RATIO, autotune_mod.WIN_K41_RATIO):
        assert kf(128, ratio) == pytest.approx(1.0)
        assert kf(41, ratio) == pytest.approx(ratio)
        assert kf(16, ratio) < kf(41, ratio) < kf(256, ratio)
        assert kf(1, ratio) >= 0.1


def test_autotune_measures_on_the_cpu(community, capsys):
    t, _ = community
    res = autotune(t, 8, methods=("ell", "band", "xla"), iters=1,
                   device="cpu")
    assert [r.method for r in res] == sorted(
        (r.method for r in res), key=lambda m: {r.method: r.t_elap
                                                for r in res}[m])
    assert {r.method for r in res} == {"ell", "xla"}
    assert "autotune: band failed" in capsys.readouterr().err
