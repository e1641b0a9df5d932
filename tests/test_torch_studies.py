"""The windowed and training studies of ``experiments/`` on the port, at a
small size on the CPU.

``gen_graphs`` writes its cache into a temporary directory, reloads to the
port's ``reorder`` output and does not rebuild what is there;
``analyze_windows`` and ``subtile_occupancy`` print the same numbers as
the scripts' own code on the same graph (the first run from its path with
its command-line argument, the second loaded with ``np.load`` patched);
``bench_windowed``, ``profile_windowed`` and both sweeps run configs of
their kinds, a transposed one included, and the sweep's refusals are the
JAX package's; ``bench_gcn_train``'s plans give the same first loss within
1e-4 and its gradient parity holds.
"""
import importlib.util
import os
import pathlib
import runpy
import sys
import types

import numpy as np
import pytest

from flex_tpu.ops.window_spmm import prepare_windowed as j_prepare_windowed

from flex_tpu_torch import kernels
from flex_tpu_torch.experiments import (
    analyze_windows, bench_gcn_train, bench_windowed, gen_graphs,
    profile_windowed, subtile_occupancy, sweep_windowed_r3,
    sweep_windowed_r4,
)
from flex_tpu_torch.io import community_graph
from flex_tpu_torch.ops.window_spmm import prepare_windowed
from flex_tpu_torch.reorder import reorder
from test_torch_ell import jax_graph

EXPERIMENTS = pathlib.Path(__file__).resolve().parents[1] / "experiments"


def tiny(seed=0):
    return community_graph(3000, 150_000, n_comm=6, seed=seed)


@pytest.fixture(scope="module")
def graph():
    return reorder(tiny(), "rbdeg", check=False)


def _arrays(g):
    return {"row_ptr": g.row_ptr, "col": g.col, "vals": g.vals}


def test_gen_graphs_writes_and_keeps_the_cache(tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.setattr(gen_graphs, "synth", types.SimpleNamespace(
        tiny=tiny))
    out = gen_graphs.main(("tiny",), ("rbdeg", "deg", "ovo"),
                          cache_dir=str(tmp_path), device="cpu")
    assert set(out) == {("tiny", o) for o in ("rbdeg", "deg", "ovo")}
    assert all(v != "cached" for v in out.values())
    for order in ("rbdeg", "deg"):
        got = gen_graphs.load("tiny", order, str(tmp_path))
        ref = reorder(tiny(), order, check=False)
        for a in ("row_ptr", "col", "vals"):
            np.testing.assert_array_equal(getattr(got, a), getattr(ref, a))
        assert got.order == ref.order
    np.testing.assert_array_equal(
        gen_graphs.load("tiny", "ovo", str(tmp_path)).col, tiny().col)
    path = gen_graphs.cache_path("tiny", "rbdeg", str(tmp_path))
    stamp = os.stat(path).st_mtime_ns
    again = gen_graphs.main(("tiny",), ("rbdeg",), cache_dir=str(tmp_path),
                            device="cpu")
    assert again == {("tiny", "rbdeg"): "cached"}
    assert os.stat(path).st_mtime_ns == stamp
    assert "cached" in capsys.readouterr().out
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    # cached() makes a missing cache itself, and reads one that is there
    fresh = gen_graphs.cached("tiny", "rcm", str(tmp_path / "other"))
    np.testing.assert_array_equal(fresh.col,
                                  reorder(tiny(), "rcm", check=False).col)
    assert gen_graphs.cached("tiny", "rbdeg", str(tmp_path)).order == "RBD"


def test_gen_graphs_names_the_headline_cache():
    from flex_tpu_torch.bench.headline import GRAPH_NPZ, GRAPH_PERM

    assert gen_graphs.cache_path("reddit_posts", "rbdeg") == GRAPH_NPZ
    assert gen_graphs.perm_path("reddit_posts", "rbdeg") == GRAPH_PERM


def test_analyze_windows_prints_the_scripts_numbers(graph, tmp_path,
                                                    monkeypatch, capsys):
    path = str(tmp_path / "g.npz")
    np.savez(path, **_arrays(graph))
    monkeypatch.setattr(sys, "argv", ["analyze_windows.py", path])
    runpy.run_path(str(EXPERIMENTS / "analyze_windows.py"))
    ref = capsys.readouterr().out.splitlines()
    r = analyze_windows.main(device="cpu", graph=graph)
    out = capsys.readouterr().out.splitlines()
    assert ref[0] == f"{path}: m={graph.m} nnz={graph.nnz}"
    assert out[1] == f"{graph.name}: m={graph.m} nnz={graph.nnz}"
    assert "the TPU's" in out[2]
    assert out[3:] == ref[1:] == r["lines"]
    assert any(line.startswith("tm=256 W=128 mc=64") for line in ref)


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", EXPERIMENTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_subtile_occupancy_prints_the_scripts_numbers(graph, monkeypatch,
                                                      capsys):
    script = load_script("subtile_occupancy")
    monkeypatch.setattr(np, "load", lambda path: _arrays(graph))
    script.main()
    ref = capsys.readouterr().out.splitlines()
    monkeypatch.undo()
    r = subtile_occupancy.main(device="cpu", graph=graph)
    out = capsys.readouterr().out.splitlines()
    assert len(ref) == 12
    assert out[1:] == ref == r["lines"]


def test_bench_windowed_runs_the_specs(graph, capsys):
    r = bench_windowed.main(specs=("windowed,W=128,J=1024,mc=16,iters=2",
                                   "windowed,tm=128,W=128,mc=32,iters=2",
                                   "ell,iters=2"),
                            device="cpu", graph=graph, k=16)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and all("wall=" in line for line in out[1:])
    assert all(res.check.err_frac == 0.0 for res in r.values())
    method, kw, hk = bench_windowed.parse("windowed,mc=64,bdt=bfloat16")
    assert (method, kw["W"], kw["J"], kw["min_count"], kw["b_dtype"]) == (
        "windowed", 256, 16, 64, "bfloat16")
    assert hk == {"iters": 10, "check": True}


def test_profile_windowed_splits_the_call(graph, capsys):
    r = profile_windowed.main(device="cpu", graph=graph, mc=16, k=16,
                              iters=2)
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("prepare: ")
    assert out[2].startswith("mc=16 cov=") and out[3].startswith("full=")
    assert r["steps"] > 0 and r["res_nnz"] > 0
    plan = prepare_windowed(graph, tm=256, W=128, min_count=16, device="cpu")
    assert r["res_pad"] == plan.ell.padded_nnz


def test_sweep_r3_runs_its_configs(graph, capsys):
    configs = [(256, 128, 16, 4, "row", 6 << 30),
               (128, 128, 12, 4, "lex", 6 << 30)]
    r = sweep_windowed_r3.main(device="cpu", graph=graph, configs=configs,
                               k=16, iters=2)
    out = capsys.readouterr().out.splitlines()
    assert r["failed"] == []
    tags = [k for k in r if k.startswith("tm=")]
    assert tags == ["tm=256 W=128 mc=16 G=4 so=row",
                    "tm=128 W=128 mc=12 G=4 so=lex"]
    assert sum("tElap=" in line for line in out) == 2


def test_sweep_r4_runs_row_major_and_transposed(graph, capsys):
    configs = [(16, False, 256, 128, 16, 4, 6 << 30),
               (16, True, 256, 128, 16, 4, 6 << 30),
               (16, True, 256, 64, 24, 8, 10 << 30)]
    r = sweep_windowed_r4.main(device="cpu", graph=graph, configs=configs,
                               iters=2)
    out = capsys.readouterr().out.splitlines()
    ok = [sweep_windowed_r4.tag_of(c) for c in configs[:2]]
    assert all(r[tag]["coverage"] > 0 for tag in ok)
    # the transposed W = 64 row is refused, with the script's FAILED line
    assert [(tag, typ) for tag, typ, _ in r["failed"]] == [
        (sweep_windowed_r4.tag_of(configs[2]), "ValueError")]
    assert any("FAILED ValueError" in line for line in out)


@pytest.mark.parametrize("cfg", [c for c in sweep_windowed_r4.CONFIGS
                                 if c[1] and c[3] % 128])
def test_sweep_r4_refusals_are_the_jax_packages(graph, cfg):
    k, tr, tm, W, mc, gs, cap = cfg
    kw = dict(tm=tm, W=W, min_count=mc, g_step=gs, max_dense_bytes=cap,
              transposed=tr)
    with pytest.raises(ValueError) as port:
        prepare_windowed(graph, device="cpu", **kw)
    with pytest.raises(ValueError) as ref:
        j_prepare_windowed(jax_graph(graph), **kw)
    assert str(port.value) == str(ref.value)


def test_bench_gcn_train_plans_agree(graph, capsys):
    before = kernels.launch_counts()
    r = bench_gcn_train.main(device="cpu", graph=graph,
                             win_kw=dict(tm=256, W=128, min_count=16),
                             steps=1, warmup=1)
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("grad parity windowed vs +tbwd: max_rel=")
    assert r["grad_parity_max_rel"] < 1e-4
    names = ("windowed", "windowed+tbwd", "ell", "ell+tbwd")
    first = [r[n]["losses"][0] for n in names]
    assert max(first) - min(first) < 1e-4
    assert all(np.isfinite(r[n]["losses"]).all() for n in names)
    assert [line.split(":")[0] for line in out[2:]] == list(names)
    assert kernels.launch_counts() == before
