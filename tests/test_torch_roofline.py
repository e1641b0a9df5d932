"""The port's roofline plot (``flex_tpu_torch/bench/roofline.py``): a PNG
from a small bench CSV written by ``write_csv``, under the card's roofs
from ``utils/device_info.PEAKS``; refusals exit 2."""
import os

import pytest

from flex_tpu_torch.bench.harness import BenchResult, write_csv
from flex_tpu_torch.bench.roofline import main
from flex_tpu_torch.io import rmat_graph
from flex_tpu_torch.utils.device_info import PEAKS


@pytest.fixture(scope="module")
def bench_csv(tmp_path_factory):
    g = rmat_graph(1024, 8192, seed=0)

    def row(method, k, t_elap, **extra):
        gflops = 2 * g.nnz * k / t_elap / 1e9 if extra == {} else 0.0
        return BenchResult(
            graph=g.name, order=g.order, method=method, k=k, m=g.m,
            nnz=g.nnz, t_pre=1e-3, t_elap=t_elap, gflops=gflops,
            pre_ratio=1e-3 / t_elap, check=None, extra=extra)

    # rows with a rate (timed on a card: 40 and 25 µs), and a row whose
    # format refused the graph: no rate, left out of the plot
    rows = [row("xla", 16, 4e-5), row("ell", 128, 2.5e-5),
            row("band", 16, float("inf"),
                error="ValueError: not band-friendly")]
    path = str(tmp_path_factory.mktemp("bench") / "bench.csv")
    write_csv(rows, path)
    return path


@pytest.mark.parametrize("card", ["H100", "H100 PCIe"])
def test_roofline_writes_a_png(bench_csv, tmp_path, card, capsys):
    out = str(tmp_path / "roof.png")
    assert main([bench_csv, out, f"--card={card}"]) == 0
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert os.path.getsize(out) > 10_000
    assert f"wrote {out}" in capsys.readouterr().out


def test_roofline_default_card_and_name(bench_csv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert main([bench_csv]) == 0
    assert os.path.exists(tmp_path / "roofline.png")
    assert "H100" in PEAKS


@pytest.mark.parametrize("argv", [
    ["--card=v5e"],              # a TPU is no card of the table
    ["--card=A100"],
    [],                          # no CSV
])
def test_roofline_refuses(bench_csv, tmp_path, argv, capsys):
    args = [bench_csv, str(tmp_path / "x.png")] + argv if argv else argv
    assert main(args) == 2
    assert not os.path.exists(tmp_path / "x.png")
    printed = capsys.readouterr().out
    assert ("unknown card" in printed if argv
            else "python -m flex_tpu_torch.bench.roofline" in printed)


def test_roofline_plots_each_rated_row_at_its_intensity(
        bench_csv, tmp_path, monkeypatch):
    """The port places each rated row where ``plot/roofline.py`` places it
    on the same CSV, point for point and with the same label; the refused
    row is left out by both."""
    import importlib.util

    import matplotlib.pyplot as plt

    spec = importlib.util.spec_from_file_location(
        "jax_roofline", os.path.join(os.path.dirname(__file__), os.pardir,
                                     "plot", "roofline.py"))
    jax_roofline = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_roofline)

    points = []
    monkeypatch.setattr(
        plt, "scatter",
        lambda x, y, **kw: points.append((list(x), list(y), kw["label"])))
    assert jax_roofline.main([bench_csv, str(tmp_path / "j.png"),
                              "--chip=v5e"]) == 0
    plt.close("all")
    jax_points, points[:] = list(points), []
    assert main([bench_csv, str(tmp_path / "r.png")]) == 0
    assert len(jax_points) == 2
    assert points == jax_points
