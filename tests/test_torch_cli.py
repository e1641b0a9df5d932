"""``python -m flex_tpu_torch`` against ``python -m flex_tpu`` on the CPU:
both ``main`` functions on the same small CSV, with the same orderings,
methods and ``--csv``; both exit 0, print the same graph and statistics
lines, and write rows whose err_frac is 0.  Then the port's own paths:
the ordering file, ``auto`` and its fallback to ``ell`` (only for a
format that refuses the graph), the exit status of a failed check, the
sweep, and the entry point as a module.

The JAX side parses with its NumPy fallback and never builds its C++
parser (see ``tests/test_torch_io.py``); its compile cache is left
alone."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import flex_tpu.cli as j_cli
import flex_tpu.io.native as j_native
import flex_tpu.utils as j_utils

import flex_tpu_torch.bench.autotune as autotune_mod
import flex_tpu_torch.bench.harness as harness
import flex_tpu_torch.ops.window_spmm as window_spmm
from flex_tpu_torch import cli
from flex_tpu_torch.bench.autotune import Suggestion
from flex_tpu_torch.io import community_graph, rmat_graph, save_csv
from flex_tpu_torch.reorder.inout import load_order
from flex_tpu_torch.utils.check import CheckResult

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAT_PREFIXES = ("CSRGraph(", "  one-way edges=", "  degree histogram",
                 "applying ordering", "saved ordering", "loading ordering")


@pytest.fixture
def jax_main(monkeypatch):
    monkeypatch.setattr(j_native, "_load", lambda: None)
    monkeypatch.setattr(j_utils, "enable_compile_cache", lambda *a: None)
    return j_cli.main


@pytest.fixture(scope="module")
def small_csv(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "small.csv")
    save_csv(rmat_graph(1500, 20_000, seed=4, name="small"), path)
    return path


def _stat_lines(out: str) -> list[str]:
    return [ln for ln in out.splitlines() if ln.startswith(STAT_PREFIXES)]


def _rows(path):
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("order", ["deg", "rcm"])
@pytest.mark.parametrize("method", ["xla", "ell"])
def test_cli_matches_jax_main(order, method, small_csv, tmp_path, capsys,
                              jax_main):
    common = [small_csv, "16", f"--order={order}", f"--method={method}",
              "--iters=2"]
    assert jax_main(common + [f"--csv={tmp_path / 'j.csv'}",
                              f"--order-file={tmp_path / 'j.npy'}"]) == 0
    jout = capsys.readouterr().out
    assert cli.main(common + [f"--csv={tmp_path / 't.csv'}",
                              f"--order-file={tmp_path / 't.npy'}",
                              "--device=cpu"]) == 0
    tout = capsys.readouterr().out
    jl = [ln.replace(str(tmp_path / "j.npy"), "F") for ln in _stat_lines(jout)]
    tl = [ln.replace(str(tmp_path / "t.npy"), "F") for ln in _stat_lines(tout)]
    assert tl == jl and len(tl) == 5
    np.testing.assert_array_equal(load_order(str(tmp_path / "t.npy")),
                                  np.load(tmp_path / "j.npy"))
    (jrow,), (trow,) = _rows(tmp_path / "j.csv"), _rows(tmp_path / "t.csv")
    assert float(jrow["err_frac"]) == 0.0 and float(trow["err_frac"]) == 0.0
    for key in ("graph", "order", "method", "k", "m", "nnz"):
        assert trow[key] == jrow[key], key
    assert trow["device"] == "cpu"
    assert "kernel launches: " in tout.splitlines()[-1]


def test_cli_reloads_the_ordering_file(small_csv, tmp_path, capsys):
    args = [small_csv, "8", "--order=rcm", "--method=ell", "--iters=1",
            f"--order-file={tmp_path / 'p'}", "--device=cpu"]
    assert cli.main(args) == 0
    assert "saved ordering to" in capsys.readouterr().out
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert "loading ordering from" in out and "applying ordering" not in out


def test_cli_auto_csv_and_trace(tmp_path, capsys):
    path = str(tmp_path / "comm.csv")
    save_csv(community_graph(3000, 90_000, n_comm=4, seed=3), path)
    assert cli.main([path, "8", "--order=deg", "--method=auto", "--iters=1",
                     f"--csv={tmp_path / 'o.csv'}",
                     f"--trace={tmp_path / 'tr'}", "--device=cpu"]) == 0
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("auto-selected")]
    assert len(line) == 1
    (row,) = _rows(tmp_path / "o.csv")
    assert line[0].startswith(f"auto-selected method: {row['method']} (")
    assert float(row["err_frac"]) == 0.0 and float(row["trace_cpu_ms"]) > 0
    assert "distinct ops; total" in out and "host op time" in out


def _forced(method, **kw):
    return lambda *a, **k: Suggestion(method, "forced", kw, model={})


def test_cli_falls_back_to_ell_when_the_format_refuses(small_csv, tmp_path,
                                                       capsys, monkeypatch):
    monkeypatch.setattr(autotune_mod, "suggest", _forced("band", tm=256))
    assert cli.main([small_csv, "8", "--order=ovo", "--method=auto",
                     "--iters=1", f"--csv={tmp_path / 'o.csv'}",
                     "--device=cpu"]) == 0
    assert "band refused (" in capsys.readouterr().out
    assert _rows(tmp_path / "o.csv")[0]["method"] == "ell"
    # a method the user named is not replaced
    with pytest.raises(ValueError):
        cli.main([small_csv, "8", "--order=ovo", "--method=band",
                  "--device=cpu"])


def test_cli_does_not_hide_a_failed_build(small_csv, monkeypatch):
    """A kernel that fails to build or launch raises RuntimeError; the run
    ends with it, it never becomes ELL."""
    def broken(*a, **k):
        raise RuntimeError("nvcc failed for window_spmm")

    monkeypatch.setattr(autotune_mod, "suggest", _forced("windowed"))
    monkeypatch.setattr(window_spmm, "prepare_windowed", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cli.main([small_csv, "8", "--order=ovo", "--method=auto",
                  "--device=cpu"])


def test_cli_exit_status_of_a_failed_check(small_csv, capsys, monkeypatch):
    monkeypatch.setattr(harness, "res_check",
                        lambda *a, **k: CheckResult(1, 10, 1.0, 0.1))
    assert cli.main([small_csv, "8", "--order=ovo", "--method=xla",
                     "--iters=1", "--device=cpu"]) == 1
    assert "RESULT CHECK FAILED" in capsys.readouterr().out


def test_cli_sweep(tmp_path, capsys):
    path = str(tmp_path / "tiny.csv")
    save_csv(rmat_graph(400, 3000, seed=2, name="tiny"), path)
    assert cli.main([path, "8", "--method=sweep", "--iters=1",
                     f"--csv={tmp_path / 's.csv'}", "--device=cpu"]) == 0
    rows = _rows(tmp_path / "s.csv")
    # 6 orderings x (xla, bcoo, ell, panel x 2, band x 2, windowed x 2)
    assert len(rows) == 54
    for r in rows:
        assert (r["err_frac"] and float(r["err_frac"]) == 0.0) or \
            r["error"].startswith(("ValueError", "NotImplementedError"))
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "kernel launches: ")


def test_cli_usage_and_device(small_csv, capsys, monkeypatch):
    assert cli.main([]) == 2
    assert "python -m flex_tpu_torch" in capsys.readouterr().out
    # no card and no --device=cpu: the run refuses, it does not fall back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([small_csv, "8", "--method=xla"])


def test_python_dash_m_entry_point(small_csv, tmp_path):
    p = subprocess.run(
        [sys.executable, "-m", "flex_tpu_torch", small_csv, "8",
         "--order=deg", "--method=ell", "--iters=1", "--device=cpu",
         f"--csv={tmp_path / 'o.csv'}"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "small  DEG    ell" in p.stdout
    assert float(_rows(tmp_path / "o.csv")[0]["err_frac"]) == 0.0
