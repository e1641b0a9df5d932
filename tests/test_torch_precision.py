"""The precision pair (``experiments/micro_precision.py``,
``experiments/high_precision_host.py``) on the port, against the scripts'
own arithmetic.

``micro_precision`` runs its rows when it is imported, so its data lines
(everything before its loop, with TM, JW, K and P shrunk) are taken out
with ``ast``; the port's inputs equal them bit for bit, and its CPU rows
equal the script's einsums on the CPU (where JAX's dot is f32 at every
precision) of the rounded operands (``default``), the sum of the three
products of the split operands (``high``) and the plain operands
(``highest``), at rtol = atol = 1e-5.  ``high_precision_host`` guards its
``main``; it is loaded from its path with ``np.load`` patched to hand it a
small graph, and its check lines (n_bad, err_frac, max_err of each
variant) must equal the port's ``main(device="cpu", graph=...)`` lines;
its ``split_hi_lo`` (ml_dtypes) equals the port's bit for bit.
"""
import ast
import importlib.util
import pathlib

import ml_dtypes
import numpy as np
import pytest

import jax.numpy as jnp

from flex_tpu_torch.experiments import high_precision_host, micro_precision
from flex_tpu_torch.io import community_graph
from flex_tpu_torch.reorder import reorder
from test_torch_micro import t

TOL = dict(rtol=1e-5, atol=1e-5)
EXPERIMENTS = pathlib.Path(__file__).resolve().parents[1] / "experiments"
SHRUNK = dict(P=3, TM=16, JW=256, K=8)


def script_data(P, TM, JW, K) -> dict:
    """micro_precision's statements before its loop (no cache
    configuration), with its sizes replaced."""
    tree = ast.parse((EXPERIMENTS / "micro_precision.py").read_text())
    body = []
    for node in tree.body:
        if isinstance(node, ast.For):
            break
        src = ast.unparse(node)
        if src.startswith("jax.config"):
            continue
        if src.startswith("TM, JW, K ="):
            node = ast.parse(f"TM, JW, K = {TM}, {JW}, {K}").body[0]
        elif src.startswith("P ="):
            node = ast.parse(f"P = {P}").body[0]
        body.append(node)
    ns = {}
    exec(compile(ast.Module(body=body, type_ignores=[]),
                 str(EXPERIMENTS / "micro_precision.py"), "exec"), ns)
    return ns


def bf16(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


def test_inputs_are_the_scripts():
    ns = script_data(**SHRUNK)
    A, B = micro_precision.make_inputs(**SHRUNK)
    np.testing.assert_array_equal(A, ns["A"])
    np.testing.assert_array_equal(B, ns["B"])
    assert 0 < np.count_nonzero(A) < A.size


def _einsum(a, b):
    return np.asarray(jnp.einsum("ptw,wk->ptk", jnp.asarray(a),
                                 jnp.asarray(b), precision="highest",
                                 preferred_element_type=jnp.float32))


@pytest.mark.parametrize("prec", micro_precision.PRECISIONS)
def test_rows_match_the_scripts_einsums(prec):
    ns = script_data(**SHRUNK)
    A, B = ns["A"], ns["B"]
    a_hi, a_lo = bf16(A), bf16(A - bf16(A))
    b_hi, b_lo = bf16(B), bf16(B - bf16(B))
    ref = {"default": lambda: _einsum(a_hi, b_hi),
           "high": lambda: (_einsum(a_hi, b_hi) + _einsum(a_hi, b_lo)
                            + _einsum(a_lo, b_hi)),
           "highest": lambda: _einsum(A, B),
           "tf32": lambda: _einsum(A, B)}[prec]()
    f, how = micro_precision.rungs(t(A), t(B))[prec]
    np.testing.assert_allclose(f().numpy(), ref, **TOL)
    assert how


def test_main_reports_the_ladder(capsys):
    r = micro_precision.main(device="cpu", iters=1, **SHRUNK)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device: cpu")
    assert [line.split(":")[0].strip() for line in out[1:]] == list(
        micro_precision.PRECISIONS)
    ns = script_data(**SHRUNK)
    gold = ns["gold"]
    rungs = micro_precision.rungs(t(ns["A"]), t(ns["B"]))
    for prec in micro_precision.PRECISIONS:
        err = np.abs(rungs[prec][0]().numpy() - gold)
        tol = (np.finfo(np.float32).eps * np.maximum(ns["row_nnz"], 1)
               [:, :, None] * 4 * np.maximum(np.abs(gold), 1.0))
        assert r[prec]["frac_beyond_tol"] == pytest.approx(
            float((err > tol).mean()))
    assert r["highest"]["frac_beyond_tol"] == 0.0
    assert r["default"]["max_rel"] > r["high"]["max_rel"]


# -- high_precision_host ------------------------------------------------------

def load_script():
    spec = importlib.util.spec_from_file_location(
        "jax_high_precision_host", EXPERIMENTS / "high_precision_host.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_split_hi_lo_is_the_scripts_bit_for_bit():
    script = load_script()
    rng = np.random.default_rng(3)
    x = np.concatenate([
        (rng.standard_normal(5000) * 10.0 ** rng.integers(-30, 30, 5000)),
        [0.0, -0.0, 1.0, 1.00390625, 1.005859375, 3.4e38, 1e-40, -2.5e-39],
    ]).astype(np.float32)
    hi, lo = script.split_hi_lo(x)
    phi, plo = high_precision_host.split_hi_lo(t(x))
    np.testing.assert_array_equal(phi.numpy().view(np.int32),
                                  hi.view(np.int32))
    np.testing.assert_array_equal(plo.numpy().view(np.int32),
                                  lo.view(np.int32))


def test_high_precision_host_matches_the_script(monkeypatch, capsys):
    g = reorder(community_graph(2048, 120_000, n_comm=6, seed=4), "rbdeg",
                check=False)
    script = load_script()
    arrays = {"row_ptr": g.row_ptr, "col": g.col, "vals": g.vals}
    monkeypatch.setattr(np, "load", lambda path: arrays)
    script.main()
    ref = capsys.readouterr().out.splitlines()
    monkeypatch.undo()
    r = high_precision_host.main(device="cpu", graph=g, chunk=50_000)
    out = capsys.readouterr().out.splitlines()
    checks = [line for line in ref if "n_bad=" in line]
    assert len(checks) == 3
    assert [line for line in out if "n_bad=" in line] == checks
    assert next(x for x in out if x.startswith("coverage")) == next(
        x for x in ref if x.startswith("coverage"))
    assert 0 < r["coverage"] < 1
    assert r["highest"]["n_bad"] == 0
    # the control rung fails on this graph as it did on the TPU's
    assert r["default"]["n_bad"] > r["high"]["n_bad"]
