"""The port's loaders, named stand-ins and statistics against the JAX
package: the CSV line parser, ``save_csv`` / ``load_csv`` (with the
missing-values and ``amazon`` quirks), ``load_mtx`` / ``mtx_to_csv``, the
named stand-in generators, ``GraphStats``, ``degree_histogram``,
``tile_stats``, ``data_volume_est`` and ``ell_padded_nnz``.

No test here builds the JAX package's C++ parser: its build writes the
library straight to its final path, so test processes that load it while
another builds it can see a partial file.  The JAX side parses with its
NumPy fallback (``flex_tpu.io.native._load`` patched to return None),
which gives the same numbers as its C++ parser (``tests/test_fastcsv.py``
holds the two equal).  The port's parser builds atomically and runs its
C++ version where g++ exists."""
import os

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp

import flex_tpu.io.csv_loader as j_csv
import flex_tpu.io.mtx as j_mtx
import flex_tpu.io.native as j_native
import flex_tpu.io.synth as jsynth
from flex_tpu.ops.ell_spmm import ell_padded_nnz as j_ell_padded_nnz
from flex_tpu.sparse.csr import CSRGraph as JCSRGraph
from flex_tpu.tiling.stats import data_volume_est as j_data_volume_est
from flex_tpu.tiling.stats import tile_stats as j_tile_stats

import flex_tpu.io as jio
import flex_tpu_torch.io as tio
import flex_tpu_torch.io.synth as tsynth
from flex_tpu_torch.io import csv_loader, mtx, native
from flex_tpu_torch.ops.ell_spmm import DEFAULT_WIDTHS, ell_padded_nnz
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.tiling.stats import data_volume_est, tile_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_numpy_parse(monkeypatch):
    """The JAX loader on its NumPy parse: its C++ build is never run."""
    monkeypatch.setattr(j_native, "_load", lambda: None)


def _same_graph(a, b, vals=True):
    np.testing.assert_array_equal(a.row_ptr, b.row_ptr)
    np.testing.assert_array_equal(a.col, b.col)
    if vals:
        np.testing.assert_array_equal(a.vals, b.vals)
    assert a.name == b.name and a.order == b.order
    assert a.row_ptr.dtype == b.row_ptr.dtype and a.col.dtype == b.col.dtype
    assert a.vals.dtype == b.vals.dtype


def _jax(g):
    return JCSRGraph.from_arrays(g.row_ptr, g.col, g.vals, name=g.name,
                                 order=g.order)


# -- the line parser ----------------------------------------------------------

_RNG = np.random.default_rng(7)
PARSE_CASES = {
    "i64 random": (",".join(map(str, _RNG.integers(-(2**62), 2**62, 20_000))
                            ).encode(), np.int64),
    "i64 edges": (b"0,1,-2,+3, 7 , 8,9223372036854775807,"
                  b"-9223372036854775808", np.int64),
    "f32 random": (",".join(repr(float(v)) for v in (
        2.0 * _RNG.random(20_000) - 1.0).astype(np.float32)).encode(),
        np.float32),
    "f32 forms": (b"1.5,-0.25,3e2,2E-3,.5,-.75,+1e0,6250000000.0,1e-40",
                  np.float32),
    "f32 {:g}": (",".join(f"{v:g}" for v in (
        2.0 * _RNG.random(5000) - 1.0).astype(np.float32).tolist()).encode(),
        np.float32),
    "one token": (b"42", np.int64),
}


@pytest.mark.parametrize("name", sorted(PARSE_CASES))
def test_parse_number_line_matches_jax_numpy_parse(name):
    line, dtype = PARSE_CASES[name]
    want = j_native._numpy_parse(line, np.dtype(dtype))
    got = native.parse_number_line(line, dtype)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        native._numpy_parse(line, np.dtype(dtype)), want)


@pytest.mark.parametrize("line", [b"1,foo,3", b"1,2,3junk,4", b"1.5x,2"])
@pytest.mark.parametrize("dtype", [np.int64, np.float32])
def test_malformed_lines_raise_in_both(line, dtype):
    with pytest.raises(ValueError):
        j_native._numpy_parse(line, np.dtype(dtype))
    with pytest.raises(ValueError):
        native.parse_number_line(line, dtype)
    with pytest.raises(ValueError):
        native._numpy_parse(line, np.dtype(dtype))


# line -> what the C++ parser gives (None: it raises)
EMPTY_TOKEN_CASES = {b"1,,2": [1, 0, 2], b",1": [0, 1], b"1,2,": None}


@pytest.mark.parametrize("line", sorted(EMPTY_TOKEN_CASES))
@pytest.mark.parametrize("dtype", [np.int64, np.float32])
def test_empty_tokens_as_in_jax(line, dtype):
    """The NumPy parses refuse an empty token in both packages.  The C++
    parser reads an empty token before a comma as 0, as the JAX package's
    own does (tests/test_fastcsv.py::test_empty_token_parses_as_zero), and
    refuses a trailing one."""
    with pytest.raises(ValueError):
        j_native._numpy_parse(line, np.dtype(dtype))
    with pytest.raises(ValueError):
        native._numpy_parse(line, np.dtype(dtype))
    if not native.available():
        return
    want = EMPTY_TOKEN_CASES[line]
    if want is None:
        with pytest.raises(ValueError):
            native.parse_number_line(line, dtype)
    else:
        np.testing.assert_array_equal(native.parse_number_line(line, dtype),
                                      np.asarray(want, dtype))


def test_empty_line_parses_to_nothing():
    for dtype in (np.int64, np.float32):
        assert native.parse_number_line(b"", dtype).shape == (0,)


def test_numpy_parse_without_toolchain(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    line, dtype = PARSE_CASES["f32 random"]
    np.testing.assert_array_equal(
        native.parse_number_line(line, dtype),
        j_native._numpy_parse(line, np.dtype(dtype)))


def test_parser_source_is_the_jax_one():
    """The C++ source is the JAX package's; only the header comment
    before the first #include differs."""
    def body(path):
        src = open(path, "rb").read()
        return src[src.index(b"#include"):]

    assert body(os.path.join(REPO, "flex_tpu_torch/io/_native/fastcsv.cc")) \
        == body(os.path.join(REPO, "flex_tpu/io/_native/fastcsv.cc"))


def test_parser_library_lands_in_the_build_dir():
    import glob

    from flex_tpu_torch.kernels import BUILD_DIR

    if native.available():
        assert glob.glob(os.path.join(BUILD_DIR, "libflexcsv-*.so"))
        assert not glob.glob(os.path.join(BUILD_DIR, "tmp*.so"))


# -- CSV round trip -----------------------------------------------------------

CSV_GRAPHS = {
    "rmat": ("rmat_graph", dict(m=600, nnz_target=5000, seed=3)),
    "community": ("community_graph", dict(m=800, nnz_target=12_000,
                                          n_comm=3, seed=1)),
    "hub": ("hub_graph", dict(m=700, nnz_target=9000, n_hub_cols=16,
                              seed=2)),
}


def _pair(name):
    fn, kw = CSV_GRAPHS[name]
    return getattr(tsynth, fn)(**kw), getattr(jsynth, fn)(**kw)


@pytest.mark.parametrize("name", sorted(CSV_GRAPHS))
def test_save_csv_writes_the_jax_bytes(name, tmp_path):
    t, j = _pair(name)
    csv_loader.save_csv(t, str(tmp_path / "t.csv"))
    j_csv.save_csv(j, str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


@pytest.mark.parametrize("name", sorted(CSV_GRAPHS))
def test_load_csv_matches_jax(name, tmp_path, jax_numpy_parse):
    t, _ = _pair(name)
    path = str(tmp_path / f"{name}.csv")
    csv_loader.save_csv(t, path)
    got, want = csv_loader.load_csv(path), j_csv.load_csv(path)
    _same_graph(got, want)
    # {:g} keeps six significant digits: row_ptr and col are exact
    np.testing.assert_array_equal(got.row_ptr, t.row_ptr)
    np.testing.assert_array_equal(got.col, t.col)
    np.testing.assert_allclose(got.vals, t.vals, rtol=1e-5, atol=0)


@pytest.mark.parametrize("fname", ["novals.csv", "amazon.csv"])
@pytest.mark.parametrize("seed", [0, 5])
def test_load_csv_value_quirks_match_jax(fname, seed, tmp_path,
                                         jax_numpy_parse):
    """No value line, or a file named amazon: U[-1, 1) values from the
    seed, in both packages."""
    t, _ = _pair("rmat")
    path = tmp_path / fname
    lines = [",".join(map(str, t.row_ptr.tolist())),
             ",".join(map(str, t.col.tolist()))]
    if fname == "amazon.csv":
        lines.append(",".join(f"{v:g}" for v in t.vals.tolist()))
    path.write_text("\n".join(lines) + "\n")
    got = csv_loader.load_csv(str(path), seed=seed)
    _same_graph(got, j_csv.load_csv(str(path), seed=seed))
    assert got.name == fname.split(".")[0]
    assert got.vals.min() >= -1.0 and got.vals.max() < 1.0


def test_load_csv_length_mismatch_raises(tmp_path, jax_numpy_parse):
    path = tmp_path / "bad.csv"
    path.write_text("0,2,3\n0,1,1\n0.5,0.25\n")
    for load in (csv_loader.load_csv, j_csv.load_csv):
        with pytest.raises(ValueError):
            load(str(path))


# -- MatrixMarket -------------------------------------------------------------

def _mtx_cases(tmp_path):
    rng = np.random.default_rng(11)
    a = sp.random(300, 300, density=0.03, random_state=4, format="coo",
                  dtype=np.float64)
    a.data[::7] = 0.0   # explicit zeros are dropped
    sym = sp.triu(sp.random(200, 200, density=0.05, random_state=5),
                  format="coo")
    dense = rng.standard_normal((40, 40)) * (rng.random((40, 40)) < 0.2)
    out = {}
    scipy.io.mmwrite(str(tmp_path / "general.mtx"), a)
    scipy.io.mmwrite(str(tmp_path / "sym.mtx"), sym + sym.T - sp.diags(
        sym.diagonal()), symmetry="symmetric")
    scipy.io.mmwrite(str(tmp_path / "pattern.mtx"), (a != 0).astype(int),
                     field="pattern")
    scipy.io.mmwrite(str(tmp_path / "array.mtx"), dense)
    for name in ("general", "sym", "pattern", "array"):
        out[name] = str(tmp_path / f"{name}.mtx")
    return out


def test_load_mtx_matches_jax(tmp_path):
    for name, path in _mtx_cases(tmp_path).items():
        got, want = mtx.load_mtx(path), j_mtx.load_mtx(path)
        _same_graph(got, want)
        assert got.name == name
        assert mtx.load_mtx(path, name="x").name == "x"


def test_mtx_to_csv_matches_jax(tmp_path):
    path = _mtx_cases(tmp_path)["general"]
    got = mtx.mtx_to_csv(path, str(tmp_path / "t.csv"))
    want = j_mtx.mtx_to_csv(path, str(tmp_path / "j.csv"))
    _same_graph(got, want)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


# -- named stand-ins ----------------------------------------------------------

@pytest.mark.parametrize("name", ["ppi_like", "ppi_comm", "flickr_like",
                                  "flickr_posts"])
def test_small_stand_ins_match_jax(name):
    _same_graph(getattr(tio, name)(seed=1), getattr(jsynth, name)(seed=1))


LARGE_STAND_INS = ("reddit_like", "reddit_comm", "reddit_posts",
                   "amazon_posts", "amazon_like", "yelp_like", "yelp_comm",
                   "flickr_like", "flickr_posts", "ppi_like", "ppi_comm")


@pytest.mark.parametrize("name", LARGE_STAND_INS)
def test_stand_in_arguments_match_jax(name, monkeypatch):
    """Every named stand-in calls the same generator with the same
    arguments in both packages (captured, not run: the large ones take
    minutes and gigabytes)."""
    calls = {}
    for mod, key in ((tsynth, "port"), (jsynth, "jax")):
        for gen in ("rmat_graph", "community_graph",
                    "bipartite_projection_graph"):
            monkeypatch.setattr(
                mod, gen, lambda *a, _k=key, _g=gen, **kw:
                calls.setdefault(_k, (_g, a, kw)))
    getattr(tsynth, name)(seed=3)
    getattr(jsynth, name)(seed=3)
    assert calls["port"] == calls["jax"]
    assert calls["port"][2]["seed"] == 3


def test_io_exports_cover_jax():
    assert set(jio.__all__) <= set(tio.__all__)
    for name in LARGE_STAND_INS:
        assert callable(getattr(tio, name))


# -- statistics ---------------------------------------------------------------

STAT_GRAPHS = {
    "community": ("community_graph", dict(m=1500, nnz_target=40_000,
                                          n_comm=4, seed=2)),
    "rmat": ("rmat_graph", dict(m=2048, nnz_target=32_768, seed=3)),
    "hub": ("hub_graph", dict(m=3000, nnz_target=40_000, n_hub_cols=64,
                              seed=1)),
    "directed": ("rmat_graph", dict(m=500, nnz_target=4000, seed=9)),
}


def _stat_pair(name):
    fn, kw = STAT_GRAPHS[name]
    return getattr(tsynth, fn)(**kw), getattr(jsynth, fn)(**kw)


@pytest.mark.parametrize("name", sorted(STAT_GRAPHS))
def test_graph_stats_match_jax(name):
    t, j = _stat_pair(name)
    assert t.stats.__dict__ == j.stats.__dict__
    assert t.stats.is_directed == j.stats.is_directed
    np.testing.assert_array_equal(t.degree_histogram(), j.degree_histogram())
    np.testing.assert_array_equal(t.degree_histogram((1, 10, 100)),
                                  j.degree_histogram((1, 10, 100)))
    assert t.avg_degree == j.avg_degree
    assert t.label_width == j.label_width
    assert repr(t) == repr(j)


def test_stats_on_unsorted_and_asymmetric_graph():
    """Columns out of order within rows and asymmetric values take the
    sorting branch of the reverse-edge scan."""
    rp = np.array([0, 3, 5, 6, 6])
    col = np.array([2, 0, 1, 0, 3, 1])
    vals = np.array([1.0, 2.0, 3.0, 3.0, 4.0, 5.0], np.float32)
    t = CSRGraph.from_arrays(rp, col, vals, name="reddit")
    j = JCSRGraph.from_arrays(rp, col, vals, name="reddit")
    assert t.stats.__dict__ == j.stats.__dict__
    assert t.stats.is_directed and t.label_width == 41
    e = CSRGraph.from_arrays(np.zeros(4, np.int64), [], [])
    assert e.stats.__dict__ == _jax(e).stats.__dict__


@pytest.mark.parametrize("name", sorted(STAT_GRAPHS))
@pytest.mark.parametrize("bm,bn", [(128, 128), (8, 128), (256, 64)])
def test_tile_stats_match_jax(name, bm, bn):
    t, j = _stat_pair(name)
    got, want = tile_stats(t, bm, bn), j_tile_stats(j, bm, bn)
    assert got.__dict__ == want.__dict__
    assert got.flop_inflation == want.flop_inflation
    assert got.hbm_bytes_bsr(41) == want.hbm_bytes_bsr(41)


@pytest.mark.parametrize("strategy", ["xla", "bsr", "ideal"])
def test_data_volume_est_matches_jax(strategy):
    t, j = _stat_pair("community")
    assert data_volume_est(t, 41, strategy) == j_data_volume_est(j, 41,
                                                                  strategy)
    with pytest.raises(ValueError):
        data_volume_est(t, 41, "nope")


@pytest.mark.parametrize("name", sorted(STAT_GRAPHS))
@pytest.mark.parametrize("widths", [DEFAULT_WIDTHS, (4, 8, 16), (1,)])
def test_ell_padded_nnz_matches_jax(name, widths):
    t, j = _stat_pair(name)
    assert ell_padded_nnz(t.degrees, widths) == j_ell_padded_nnz(j.degrees,
                                                                 widths)
    assert ell_padded_nnz(np.zeros(5, np.int64)) == 0
