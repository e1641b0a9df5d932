"""The headline benchmark of the port (``flex_tpu_torch/bench/headline.py``,
``bench_torch.py``) on the CPU, on a small rbdeg-ordered community graph
in place of the full-size one (50,000 nonzeros or more, so that
``suggest`` runs its time model): one JSON line on stdout with the keys of
``bench.py``'s line, exit status 1 and value 0 when the result check
fails, the same key set as the JAX ``bench._final_line`` on the same
result dict (without its TPU probes), the graph cache, and no result
without a card."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import bench as jax_bench

import flex_tpu_torch.io
import flex_tpu_torch.ops.ref
from flex_tpu_torch.bench import headline
from flex_tpu_torch.io import community_graph
from flex_tpu_torch.reorder import reorder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "vs_baseline", "t_pre_s", "t_elap_ms",
        "pre_elap_ratio", "method", "err_frac", "model_elap_ratio",
        "secondary_ell_gflops", "secondary_ell_pre_ratio", "device"}


@pytest.fixture(scope="module")
def small_graph():
    g = reorder(community_graph(4000, 80_000, n_comm=8, seed=0), "rbdeg",
                check=False)
    assert g.nnz >= 50_000
    return g


def _run(monkeypatch, capsys, g):
    monkeypatch.setattr(headline, "load_graph", lambda csv=False: g)
    rc = headline.main(device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    return rc, json.loads(out[0])


def test_headline_prints_one_checked_line(monkeypatch, capsys, small_graph):
    from flex_tpu_torch.bench.autotune import suggest

    rc, line = _run(monkeypatch, capsys, small_graph)
    assert rc == 0
    assert KEYS <= set(line)
    assert line["metric"] == "spmm_effective_gflops_reddit_posts_k128"
    assert line["unit"] == "GFLOP/s" and line["device"] == "cpu"
    assert line["err_frac"] == 0.0
    assert line["vs_baseline"] == round(line["value"] / 1237.25, 4)
    sug = suggest(small_graph, 128, win_min_count=64,
                  max_dense_bytes=6 << 30)
    assert sug.model is not None and line["method"] == sug.method
    assert line["model_elap_ratio"] > 0 and line["secondary_ell_gflops"] >= 0
    # value = 2 nnz k / tElap, rounded to two decimals (tElap to four)
    gflops = 2 * small_graph.nnz * 128 / (line["t_elap_ms"] * 1e-3) / 1e9
    assert abs(line["value"] - gflops) <= 0.005 + 1e-3 * gflops
    assert "result-check-failed" not in line.get("annotations", [])


def test_headline_reports_zero_on_a_wrong_result(monkeypatch, capsys,
                                                 small_graph):
    real = flex_tpu_torch.ops.ref.spmm_scipy
    monkeypatch.setattr(flex_tpu_torch.ops.ref, "spmm_scipy",
                        lambda g, B: real(g, B) * 2.0)
    rc, line = _run(monkeypatch, capsys, small_graph)
    assert rc == 1
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0
    assert line["err_frac"] > 1e-4
    assert "result-check-failed" in line["annotations"]
    assert KEYS <= set(line)


def test_final_line_keys_match_jax():
    res = {"value": 4316.6, "t_pre_s": 0.37, "t_elap_ms": 1.39,
           "pre_elap_ratio": 266.2, "method": "ell", "err_frac": 0.0,
           "model_elap_ratio": 1.01, "secondary_ell_gflops": 4300.0,
           "secondary_ell_pre_ratio": 260.0,
           "annotations": ["model-divergence:3.5x-slower-than-time-model"],
           "probes": [{"tag": "post", "ok": True}], "env_ok": True,
           "device": "NVIDIA H100 80GB HBM3, 700.00 W", "cold_s": 3.0}
    port = json.loads(headline.final_line(res))
    ref = json.loads(jax_bench._final_line(res))
    assert set(port) - {"device"} == set(ref) - {"probes", "env_ok"}
    assert list(port)[:-1] == [k for k in ref if k not in ("probes",
                                                          "env_ok")]
    for key in set(port) & set(ref):
        assert port[key] == ref[key], key
    assert port["device"] == res["device"]
    # empty annotations are left out, as in the JAX line
    res["annotations"] = []
    assert "annotations" not in json.loads(headline.final_line(res))
    assert "annotations" not in json.loads(jax_bench._final_line(res))


def test_load_graph_owns_the_cache(monkeypatch, tmp_path):
    small = community_graph(3000, 30_000, n_comm=6, seed=2,
                            name="reddit_posts")
    calls = []

    def fake_reddit_posts(seed=0):
        calls.append(seed)
        return small

    monkeypatch.setattr(flex_tpu_torch.io, "reddit_posts", fake_reddit_posts)
    monkeypatch.setattr(headline, "EXPECT_M", small.m)
    monkeypatch.setattr(headline, "EXPECT_NNZ", small.nnz)
    for name in ("GRAPH_NPZ", "GRAPH_CSV", "GRAPH_PERM"):
        monkeypatch.setattr(headline, name,
                            str(tmp_path / os.path.basename(
                                getattr(headline, name))))
    g = headline.load_graph()
    assert calls == [0] and g.order == "RBD"
    assert os.path.exists(headline.GRAPH_NPZ)
    assert os.path.exists(headline.GRAPH_PERM)
    assert not os.path.exists(headline.GRAPH_CSV)
    again = headline.load_graph()                  # from the cache
    assert calls == [0]
    assert np.array_equal(again.row_ptr, g.row_ptr)
    assert np.array_equal(again.col, g.col)
    assert np.array_equal(again.vals, g.vals)
    perm = np.load(headline.GRAPH_PERM)
    assert np.array_equal(np.sort(perm), np.arange(small.m))
    headline.load_graph(csv=True)                  # the CSV, once
    assert calls == [0, 0] and os.path.exists(headline.GRAPH_CSV)
    headline.load_graph(csv=True)
    assert calls == [0, 0]
    monkeypatch.setattr(headline, "EXPECT_NNZ", small.nnz + 1)
    with pytest.raises(AssertionError, match="expected"):
        headline.load_graph()


def test_bench_torch_needs_a_card():
    """Without a CUDA card the script exits non-zero and prints no line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "no CUDA device" in p.stderr
