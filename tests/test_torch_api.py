"""The port's public names and signatures against the JAX package's.

Each keyword that a JAX call site passes is accepted by the port function
(``interpret``, ``pad_multiple``, ``precision`` and ``dev``, which have no
meaning on the card, are checked and ignored), and the result equals the
JAX function's on the same seeded graph at rtol = atol = 1e-5;
``res_check``'s printed mismatch report equals the JAX function's line for
line.  The names the port lacked (``spmm_ell``, ``spmm_windowed``,
``spmm_dense_numpy``, ``modularity``, ``round_up``, the ``sparse``
exports) against the JAX ones.  Every public function that the two
packages share takes the JAX positional parameters first, in the JAX
order, so a positional JAX call means the same in the port; the models'
losses and the checkpoint functions differ by design (``nn.Module``
parameters, ``torch.save`` of state dicts)."""
import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flex_tpu
import flex_tpu.sparse as j_sparse
from flex_tpu.ops import spmm as j_spmm
from flex_tpu.ops.ell_spmm import ell_buckets_core as j_ell_buckets_core
from flex_tpu.ops.ell_spmm import prepare_ell as j_prepare_ell
from flex_tpu.ops.ell_spmm import spmm_ell as j_spmm_ell
from flex_tpu.ops.gcn import gcn_layer as j_gcn_layer
from flex_tpu.ops.gespmm import prepare_gespmm as j_prepare_gespmm
from flex_tpu.ops.pallas_band import prepare_band as j_prepare_band
from flex_tpu.ops.panel_spmm import prepare_panel as j_prepare_panel
from flex_tpu.ops.ref import spmm_dense_numpy as j_spmm_dense_numpy
from flex_tpu.ops.window_spmm import pattern_is_unique as j_pattern_is_unique
from flex_tpu.ops.window_spmm import prepare_windowed as j_prepare_windowed
from flex_tpu.ops.window_spmm import spmm_windowed as j_spmm_windowed
from flex_tpu.ops.window_spmm import window_select as j_window_select
from flex_tpu.ops.xla_spmm import prepare_xla as j_prepare_xla
from flex_tpu.reorder.rabbit import modularity as j_modularity
from flex_tpu.sparse.device import DeviceCSR as JDeviceCSR
from flex_tpu.sparse.device import round_up as j_round_up
from flex_tpu.utils.check import res_check as j_res_check

import flex_tpu_torch
import flex_tpu_torch.sparse as sparse
from flex_tpu_torch import spmm
from flex_tpu_torch.io import (
    banded_graph, community_graph, hub_graph, make_features, rmat_graph,
)
from flex_tpu_torch.ops.ell_spmm import (
    ell_buckets_core, ell_meta, prepare_ell, spmm_ell,
)
from flex_tpu_torch.ops.gcn import gcn_layer
from flex_tpu_torch.ops.gespmm import prepare_gespmm
from flex_tpu_torch.ops.pallas_band import prepare_band
from flex_tpu_torch.ops.panel_spmm import prepare_panel
from flex_tpu_torch.ops.ref import spmm_dense_numpy, spmm_scipy
from flex_tpu_torch.ops.window_spmm import (
    pattern_is_unique, prepare_windowed, spmm_windowed, window_select,
)
from flex_tpu_torch.ops.xla_spmm import prepare_xla
from flex_tpu_torch.reorder import reorder
from flex_tpu_torch.reorder.rabbit import modularity, order_rabbit
from flex_tpu_torch.sparse.device import DeviceCSR, round_up
from flex_tpu_torch.utils.check import res_check
from test_torch_ell import jax_graph

TOL = dict(rtol=1e-5, atol=1e-5)


def _features(g, k=16, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (g.n, k)).astype(np.float32)


def _community():
    return reorder(community_graph(1024, 40_000, n_comm=6, seed=3),
                   "rbdeg", check=False)


def _plans(port, jax_):
    """(port result, JAX result) of two prepared plans on one B."""
    def run(g, jg):
        B = _features(g)
        return (port(g)(torch.from_numpy(B)).numpy(),
                np.asarray(jax_(jg)(jnp.asarray(B))))
    return run


def _band():
    g = banded_graph(1024, 96, 12.0, seed=4)
    return _plans(
        lambda g_: prepare_band(g_, tm=128, interpret=True, device="cpu"),
        lambda jg: j_prepare_band(jg, tm=128, interpret=True))(
            g, jax_graph(g))


def _gespmm():
    # the JAX signature also swallows keywords it has no use for (tm)
    g = rmat_graph(800, 9_000, seed=1)
    return _plans(
        lambda g_: prepare_gespmm(g_, w=32, interpret=True, tm=128,
                                  device="cpu"),
        lambda jg: j_prepare_gespmm(jg, w=32, interpret=True, tm=128))(
            g, jax_graph(g))


def _xla():
    g = rmat_graph(700, 6_000, seed=2)
    return _plans(lambda g_: prepare_xla(g_, pad_multiple=1024,
                                         device="cpu"),
                  lambda jg: j_prepare_xla(jg, pad_multiple=1024))(
                      g, jax_graph(g))


def _gcn():
    g = rmat_graph(600, 5_000, seed=5)
    rng = np.random.default_rng(1)
    X = rng.standard_normal((g.n, 16)).astype(np.float32)
    W = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    prec = jax.lax.Precision.HIGHEST
    out = gcn_layer(prepare_ell(g, device="cpu"), torch.from_numpy(X),
                    torch.from_numpy(W), torch.from_numpy(b),
                    association="auto", nnz=g.nnz, precision=prec)
    ref = j_gcn_layer(j_prepare_ell(jax_graph(g)), jnp.asarray(X),
                      jnp.asarray(W), jnp.asarray(b), association="auto",
                      nnz=g.nnz, precision=prec)
    return out.numpy(), np.asarray(ref)


SEL_KEYS = ("win_step", "out_panel", "first", "pstep0", "slot", "res_deg")
SEL_SCALARS = ("coverage", "total_steps", "n_res", "dense_bytes",
               "min_count_eff", "a_elems")


def _select(resident):
    g = _community()
    jg = jax_graph(g)
    kw = dict(tm=128, W=128, min_count=8)
    sel = window_select(
        g, dev=DeviceCSR.from_graph(g, "cpu") if resident else None, **kw)
    jsel = j_window_select(
        jg, dev=JDeviceCSR.from_graph(jg) if resident else None, **kw)
    assert sel["total_steps"] > 0
    assert [sel[k] for k in SEL_SCALARS] == [jsel[k] for k in SEL_SCALARS]
    return (np.concatenate([np.asarray(sel[k], np.int64).ravel()
                            for k in SEL_KEYS]),
            np.concatenate([np.asarray(jsel[k], np.int64).ravel()
                            for k in SEL_KEYS]))


def _planted(g, seed=0):
    """A gold product and a result with mismatches planted in four rows."""
    gold = spmm_scipy(g, _features(g, 8, seed))
    res = gold.copy()
    for r, c in ((3, 1), (17, 0), (17, 5), (250, 7)):
        res[r, c] += 1.0 + abs(gold[r, c])
    return gold, res


def _report(capsys):
    g = rmat_graph(400, 4_000, seed=6)
    gold, res = _planted(g)
    port = res_check(gold, res, g.degrees, verbose=True, max_report=3)
    port_lines = capsys.readouterr().out.splitlines()
    ref = j_res_check(gold, res, g.degrees, verbose=True, max_report=3)
    ref_lines = capsys.readouterr().out.splitlines()
    assert len(port_lines) == 3 and port_lines == ref_lines
    assert (port.n_bad, port.n_total) == (ref.n_bad, ref.n_total) == (
        4, gold.size)
    return np.array([port.max_err, port.err_frac]), np.array(
        [ref.max_err, ref.err_frac])


def _unique():
    """pattern_is_unique with the caller's host row pointers, on a graph
    without and one with a duplicate (row, col) pair."""
    g = rmat_graph(500, 4_000, seed=3)
    col = g.col.copy()
    r = int(np.flatnonzero(np.diff(g.row_ptr) >= 2)[0])
    col[g.row_ptr[r] + 1] = col[g.row_ptr[r]]   # a duplicate in row r
    dup = type(g)(row_ptr=g.row_ptr, col=col, vals=g.vals, name="dup")
    out, ref = [], []
    for h in (g, dup):
        out.append(pattern_is_unique(h, row_ptr_h=h.row_ptr.copy()))
        ref.append(j_pattern_is_unique(jax_graph(h),
                                       row_ptr_h=h.row_ptr.copy()))
    assert out == [True, False]
    return np.array(out, float), np.array(ref, float)


def _buckets():
    """ell_buckets_core with the JAX parameter names as keywords."""
    g = rmat_graph(600, 7_000, seed=4)
    meta, _ = ell_meta(np.diff(g.row_ptr))
    buckets, chunk_row, _ = ell_buckets_core(
        torch.from_numpy(g.row_ptr.astype(np.int32)),
        col_dev=torch.from_numpy(g.col.astype(np.int32)),
        vals_dev=torch.from_numpy(g.vals.astype(np.float32)), meta=meta)
    jb, jrow = j_ell_buckets_core(
        jnp.asarray(g.row_ptr.astype(np.int32)),
        col_dev=jnp.asarray(g.col.astype(np.int32)),
        vals_dev=jnp.asarray(g.vals.astype(np.float32)), meta=meta)
    assert len(buckets) == len(jb) > 0
    flat = lambda bs, row: np.concatenate(  # noqa: E731
        [np.asarray(a, np.float64).ravel() for b in bs for a in b]
        + [np.asarray(row, np.float64)])
    return flat([(c.numpy(), v.numpy()) for c, v in buckets],
                chunk_row.numpy()), flat(jb, jrow)


def _panel():
    g = reorder(hub_graph(3000, 60_000, n_hub_cols=64, hub_frac=0.5,
                          seed=2), "deg", check=False)
    prec = jax.lax.Precision.HIGHEST
    return _plans(
        lambda g_: prepare_panel(g_, hub_threshold=30, precision=prec,
                                 device="cpu"),
        lambda jg: j_prepare_panel(jg, hub_threshold=30,
                                   precision=prec))(g, jax_graph(g))


CASES = {
    "prepare_band(interpret=)": lambda capsys: _band(),
    "prepare_gespmm(interpret=, **_unused)": lambda capsys: _gespmm(),
    "prepare_xla(pad_multiple=1024)": lambda capsys: _xla(),
    "gcn_layer(precision=)": lambda capsys: _gcn(),
    "window_select(dev=None)": lambda capsys: _select(False),
    "window_select(dev=<resident CSR>)": lambda capsys: _select(True),
    "res_check(verbose=True, max_report=3)": _report,
    "pattern_is_unique(row_ptr_h=)": lambda capsys: _unique(),
    "ell_buckets_core(col_dev=, vals_dev=)": lambda capsys: _buckets(),
    "prepare_panel(precision=HIGHEST)": lambda capsys: _panel(),
}


def test_version_matches_jax():
    assert flex_tpu_torch.__version__ == flex_tpu.__version__


@pytest.mark.parametrize("case", list(CASES))
def test_jax_keyword_is_accepted_and_matches_jax(case, capsys):
    out, ref = CASES[case](capsys)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **TOL)


def test_res_check_is_quiet_without_verbose(capsys):
    g = rmat_graph(400, 4_000, seed=6)
    gold, res = _planted(g)
    assert res_check(gold, res, g.degrees).n_bad == 4
    assert res_check(gold, res, g.degrees, max_report=1).n_bad == 4
    assert res_check(gold, gold, g.degrees, verbose=True).ok
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("call, err", [
    (lambda g: prepare_band(g, interpret="yes", device="cpu"), ValueError),
    (lambda g: prepare_gespmm(g, interpret=1.5, device="cpu"), ValueError),
    (lambda g: prepare_xla(g, pad_multiple=0, device="cpu"), ValueError),
    (lambda g: prepare_xla(g, pad_multiple=True, device="cpu"), ValueError),
    (lambda g: window_select(g, dev="cuda"), TypeError),
    (lambda g: gcn_layer(prepare_ell(g, device="cpu"), torch.ones(g.n, 4),
                         torch.ones(4, 2), association="axw", precision=3),
     TypeError),
    (lambda g: prepare_panel(g, precision=3, device="cpu"), TypeError),
    (lambda g: pattern_is_unique(g, row_ptr_h=g.row_ptr[:-1]), ValueError),
])
def test_ignored_keywords_are_still_checked(call, err):
    with pytest.raises(err):
        call(banded_graph(512, 64, 8.0, seed=1))


@pytest.mark.parametrize("method", ["ell", "windowed"])
def test_spmm_ell_and_windowed_match_jax(method):
    g = _community()
    B = make_features(g, 16)
    kw = {} if method == "ell" else dict(tm=128, W=128, min_count=8)
    port_fn = spmm_ell if method == "ell" else spmm_windowed
    jax_fn = j_spmm_ell if method == "ell" else j_spmm_windowed
    ref = np.asarray(jax_fn(jax_graph(g), B, **kw))
    out = port_fn(g, B, device="cpu", **kw)       # NumPy B
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    # a tensor B, and the dispatcher, which goes through the same function
    np.testing.assert_allclose(port_fn(g, torch.from_numpy(B),
                                       device="cpu", **kw).numpy(), ref,
                               **TOL)
    np.testing.assert_allclose(
        spmm(g, B, method=method, device="cpu", **kw).numpy(),
        np.asarray(j_spmm(jax_graph(g), B, method=method, **kw)), **TOL)
    # a resident CSR names the device
    dev = DeviceCSR.from_graph(g, "cpu")
    assert torch.equal(port_fn(g, B, dev=dev, **kw), out)


def test_spmm_dense_numpy_matches_jax():
    g = rmat_graph(300, 2_500, seed=7)
    B = _features(g, 5)
    out = spmm_dense_numpy(g, B)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, j_spmm_dense_numpy(jax_graph(g), B),
                               **TOL)
    np.testing.assert_allclose(out, spmm_scipy(g, B), **TOL)


@pytest.mark.parametrize("make", [
    lambda: community_graph(900, 20_000, n_comm=5, seed=1),   # symmetric
    lambda: rmat_graph(600, 6_000, seed=8),                   # directed
])
def test_modularity_matches_jax(make):
    g = make()
    _, labels = order_rabbit(g, use_native=False, want_labels=True)
    rand = np.random.default_rng(0).integers(0, 7, g.m)
    for comm in (np.asarray(labels, np.int64), rand):
        q = modularity(g, comm)
        assert q == pytest.approx(j_modularity(jax_graph(g), comm),
                                  rel=1e-12, abs=1e-12)
    # rabbit's clusters beat a random assignment
    assert modularity(g, np.asarray(labels, np.int64)) > modularity(g, rand)


def test_round_up_matches_jax():
    for x, mult in ((0, 8), (1, 8), (8, 8), (9, 8), (127, 128), (1025, 1024),
                    (5, 1), (2**31 + 3, 256)):
        assert round_up(x, mult) == j_round_up(x, mult)


def test_sparse_exports_match_jax():
    assert set(j_sparse.__all__) <= set(sparse.__all__)
    for name in j_sparse.__all__:
        assert hasattr(sparse, name), name
    g = rmat_graph(300, 2_000, seed=9)
    assert isinstance(g.stats, sparse.GraphStats)
    perm = np.random.default_rng(0).permutation(g.m)   # perm[new] = old
    new = sparse.apply_vertex_order(g, perm, "RND", check=False)
    sparse.check_permutation_invariants(g, new,
                                        sparse.invert_permutation(perm))
    with pytest.raises(AssertionError):
        sparse.check_permutation_invariants(g, new, perm)


# -- positional parameters: the JAX order first -------------------------------

POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
              inspect.Parameter.POSITIONAL_OR_KEYWORD)
# differences by design: the losses read an nn.Module's own parameters
# (no ``params``), a checkpoint holds a module's and an optimizer's state
SIGNATURE_EXCEPTIONS = {
    ("flex_tpu_torch.models.gcn", "gcn_loss"),
    ("flex_tpu_torch.models.sage", "sage_loss"),
    ("flex_tpu_torch.models.gat", "gat_loss"),
    ("flex_tpu_torch.models.checkpoint", "save_checkpoint"),
    ("flex_tpu_torch.models.checkpoint", "restore_checkpoint"),
}


def _shared_functions() -> list:
    """(port module, name) of every public function that a port module and
    the JAX module of the same name both define."""
    out = []
    for info in pkgutil.walk_packages(flex_tpu_torch.__path__,
                                      "flex_tpu_torch."):
        if info.name.endswith("__main__"):
            continue
        jname = "flex_tpu." + info.name.split(".", 1)[1]
        try:
            jmod = importlib.import_module(jname)
        except ImportError:
            continue
        mod = importlib.import_module(info.name)
        for attr in sorted(dir(mod)):
            fn, jfn = getattr(mod, attr), getattr(jmod, attr, None)
            if (not attr.startswith("_") and inspect.isfunction(fn)
                    and inspect.isfunction(jfn)
                    and fn.__module__ == info.name
                    and jfn.__module__ == jname):
                out.append((info.name, attr))
    return out


def _positional(fn) -> list:
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind in POSITIONAL]


SHARED = _shared_functions()


def test_shared_functions_are_found():
    names = {name for _, name in SHARED}
    assert {"prepare_band", "prepare_windowed", "prepare_ell",
            "window_select", "make_train_step"} <= names
    assert SIGNATURE_EXCEPTIONS <= set(SHARED)


@pytest.mark.parametrize("module, name", SHARED,
                         ids=[f"{m.split('.', 1)[1]}.{n}" for m, n in SHARED])
def test_positional_parameters_start_with_the_jax_ones(module, name):
    fn = getattr(importlib.import_module(module), name)
    jfn = getattr(importlib.import_module(
        "flex_tpu." + module.split(".", 1)[1]), name)
    jax_pos, port_pos = _positional(jfn), _positional(fn)
    if (module, name) in SIGNATURE_EXCEPTIONS:
        assert port_pos[:len(jax_pos)] != jax_pos
    else:
        assert port_pos[:len(jax_pos)] == jax_pos


@pytest.mark.parametrize("which", ["band", "windowed"])
def test_positional_tm_builds_the_jax_plan(which):
    """``prepare_band(g, dev, 128)`` and ``prepare_windowed(g, dev, 128)``,
    valid JAX calls, build tm = 128 in the port too."""
    if which == "band":
        g = banded_graph(2048, 64, 8.0, seed=1)
        port, jax_ = prepare_band, j_prepare_band
        jkw = dict(interpret=True)
    else:
        g = _community()
        port, jax_ = prepare_windowed, j_prepare_windowed
        jkw = {}
    jg = jax_graph(g)
    plan = port(g, DeviceCSR.from_graph(g, "cpu"), 128)
    jplan = jax_(jg, JDeviceCSR.from_graph(jg), 128, **jkw)
    assert plan.tm == jplan.tm == 128
    stats, jstats = plan.stats, jplan.stats
    assert set(jstats) <= set(stats)
    assert {key: stats[key] for key in jstats} == pytest.approx(jstats)
    B = _features(g)
    np.testing.assert_allclose(plan(torch.from_numpy(B)).numpy(),
                               np.asarray(jplan(jnp.asarray(B))), **TOL)
