"""The bf16 gather mode (``b_dtype="bfloat16"``) of the PyTorch port
against the JAX package's, on the CPU: the ELL plan and the windowed plan
with a bf16 residue give the JAX bf16 plan's output (both compute f32
products of the same bf16-rounded B, so rtol = atol = 1e-5 holds), and so
does a NumPy emulation of kernel 7's bf16 instance (``csrc/gespmm.cu``:
the f32 instance's order on B rounded to bf16 and widened).  g_B of the
bf16 residue through its transposed backward plan, which gathers the
cotangent in bf16, against ``jax.grad`` of the JAX plan with its
``with_bwd_plan`` (1e-4).  ``bench_spmm``'s check scales its tolerance by
bf16 eps / f32 eps for such a plan, as the JAX harness does; the f32
tolerance flags the same output.  The kernel itself runs only on a card:
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flex_tpu.ops.ell_spmm import prepare_ell as j_prepare_ell
from flex_tpu.ops.ell_spmm import with_bwd_plan as j_with_bwd_plan
from flex_tpu.ops.window_spmm import prepare_windowed as j_prepare_windowed
from flex_tpu.ops.window_spmm import with_training_bwd as j_with_training_bwd

from flex_tpu_torch.bench.harness import bench_spmm, check_eps_scale
from flex_tpu_torch.io import community_graph
from flex_tpu_torch.ops.ell_spmm import (
    check_b_dtype, prepare_ell, with_bwd_plan,
)
from flex_tpu_torch.ops.gespmm import (
    gespmm_rows, gespmm_rows_bf16, gespmm_rows_plain,
)
from flex_tpu_torch.ops.ref import spmm_scipy
from flex_tpu_torch.ops.window_spmm import prepare_windowed, with_training_bwd
from flex_tpu_torch.reorder import reorder
from flex_tpu_torch.utils.check import res_check
from test_torch_ell import (
    assert_sums_close, dup_graph, emulate_row_units, hub_graph_with_empty_rows,
    jax_graph,
)

WIN_KW = dict(tm=256, W=128, J=4, min_count=32)


def _community():
    return reorder(community_graph(3000, 200_000, n_comm=6, seed=5), "rbdeg")


GRAPHS = {"hub": hub_graph_with_empty_rows, "dups": dup_graph,
          "community_rbdeg": _community}


def _features(g, k, seed=1):
    """Features whose bf16 rounding is visible: uniform in (-1, 1) with
    full f32 mantissas."""
    rng = np.random.default_rng(seed)
    return (2 * rng.random((g.n, k)) - 1).astype(np.float32)


def _bf16(B: np.ndarray) -> np.ndarray:
    return torch.from_numpy(B).bfloat16().float().numpy()


@pytest.mark.parametrize("k", [16, 41])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bf16_ell_matches_jax(name, k):
    g = GRAPHS[name]()
    B = _features(g, k)
    plan = prepare_ell(g, b_dtype="bfloat16", device="cpu")
    assert plan.b_dtype == "bfloat16"
    C = plan(torch.from_numpy(B))
    assert C.dtype == torch.float32
    C_jax = np.asarray(j_prepare_ell(jax_graph(g), b_dtype="bfloat16")(
        jnp.asarray(B)))
    np.testing.assert_allclose(C.numpy(), C_jax, rtol=1e-5, atol=1e-5)
    # the plain version on B rounded once: the bf16 mode is exactly that
    np.testing.assert_array_equal(
        C.numpy(), prepare_ell(g, device="cpu")(
            torch.from_numpy(_bf16(B))).numpy())
    # kernel 7's bf16 instance, emulated: the f32 order on widened bf16 B
    absprod = np.abs(g.to_scipy()) @ np.abs(_bf16(B))
    assert_sums_close(emulate_row_units(plan.row_tables(), _bf16(B)), C_jax,
                      g.degrees, absprod)


@pytest.mark.parametrize("into", [False, True])
def test_bf16_rows_wrapper_on_the_cpu(into):
    """``gespmm_rows`` sends bf16 B to ``gespmm_rows_bf16``, whose CPU path
    is the plain version on B widened; f32 stays f32, and any other dtype
    is refused.  No launch is counted on the CPU."""
    g = hub_graph_with_empty_rows()
    t = prepare_ell(g, device="cpu").row_tables()
    B = torch.from_numpy(_features(g, 24))
    acc = torch.from_numpy(_features(g, 24, seed=3)) if into else None
    before = (gespmm_rows.launches, gespmm_rows_bf16.launches)
    got = gespmm_rows(t, B.bfloat16(), None if acc is None else acc.clone())
    want = gespmm_rows_plain(t, B.bfloat16().float(),
                             None if acc is None else acc.clone())
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (gespmm_rows.launches, gespmm_rows_bf16.launches) == before
    with pytest.raises(ValueError, match="bfloat16"):
        gespmm_rows_bf16(t, B)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gespmm_rows(t, B.half())


@pytest.mark.parametrize("k", [16, 41])
def test_bf16_windowed_residue_matches_jax(k):
    """The windowed plan with a bf16 residue: the dense half stays f32."""
    g = _community()
    B = _features(g, k)
    plan = prepare_windowed(g, b_dtype="bfloat16", device="cpu", **WIN_KW)
    assert plan.b_dtype == "bfloat16" and plan.ell.nnz > 0
    jplan = j_prepare_windowed(jax_graph(g), b_dtype="bfloat16", **WIN_KW)
    assert jplan.b_dtype == "bfloat16"
    C = plan(torch.from_numpy(B)).numpy()
    np.testing.assert_allclose(C, np.asarray(jplan(jnp.asarray(B))),
                               rtol=1e-5, atol=1e-5)
    dense = plan.dense_half(torch.from_numpy(B))
    f32 = prepare_windowed(g, device="cpu", **WIN_KW)
    np.testing.assert_array_equal(dense.numpy(),
                                  f32.dense_half(torch.from_numpy(B)).numpy())


def _co(m, k, seed=7):
    return np.random.default_rng(seed).standard_normal((m, k)).astype(
        np.float32)


@pytest.mark.parametrize("case", ["ell", "windowed"])
def test_bf16_residue_grad_matches_jax(case):
    """g_B of (plan(B)·co).sum() through the transposed backward plans,
    which inherit the bf16 gather (the cotangent is rounded to bf16)."""
    g = _community()
    k = 16
    B, co = _features(g, k), _co(g.m, k)
    if case == "ell":
        plan = with_bwd_plan(prepare_ell(g, b_dtype="bfloat16", device="cpu"),
                             g.n)
        jplan = j_with_bwd_plan(j_prepare_ell(jax_graph(g),
                                              b_dtype="bfloat16"), g.n)
        assert plan.bwd_plan.b_dtype == "bfloat16"
    else:
        plan = with_training_bwd(prepare_windowed(
            g, b_dtype="bfloat16", device="cpu", **WIN_KW))
        jplan = j_with_training_bwd(j_prepare_windowed(
            jax_graph(g), b_dtype="bfloat16", **WIN_KW))
        assert plan.ell.bwd_plan.b_dtype == "bfloat16"
    Bt = torch.from_numpy(B).requires_grad_()
    (plan(Bt) * torch.from_numpy(co)).sum().backward()
    want = jax.grad(lambda b: (jplan(b) * jnp.asarray(co)).sum())(
        jnp.asarray(B))
    np.testing.assert_allclose(Bt.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("method,kw", [("ell", {}), ("windowed", WIN_KW)])
def test_bench_check_scales_to_bf16(method, kw):
    """bench_spmm's check passes a bf16 plan at the bf16 scale; the same
    output fails the f32 scale (bf16 rounding exceeds it)."""
    g = _community()
    B = _features(g, 16)
    r = bench_spmm(g, 16, method=method, B=B, iters=1, b_dtype="bfloat16",
                   device="cpu", **kw)
    assert r.check.ok and r.check.err_frac == 0.0
    plan = prepare_ell(g, b_dtype="bfloat16", device="cpu") \
        if method == "ell" else prepare_windowed(
            g, b_dtype="bfloat16", device="cpu", **kw)
    scale = check_eps_scale(plan)
    assert scale == 4.0 * 2 ** 16
    assert check_eps_scale(prepare_ell(g, device="cpu")) == 4.0
    C = plan(torch.from_numpy(B)).numpy()
    gold = spmm_scipy(g, B)
    assert res_check(gold, C, g.degrees, eps_scale=scale).ok
    assert not res_check(gold, C, g.degrees).ok


@pytest.mark.parametrize("b_dtype", ["float16", "float64", "bf16"])
def test_check_b_dtype_refuses_other_dtypes(b_dtype):
    with pytest.raises(ValueError, match="b_dtype"):
        check_b_dtype(b_dtype)
    for ok in ("float32", "bfloat16"):
        check_b_dtype(ok)


def test_cli_b_dtype_flag_reaches_the_plan(tmp_path, capsys):
    """``--b_dtype=bfloat16`` goes through ``FlexConfig.prep_kwargs`` to the
    ELL plan: the run's check passes at the bf16 scale and its row names
    the method."""
    import csv

    from flex_tpu_torch import cli
    from flex_tpu_torch.config import FlexConfig
    from flex_tpu_torch.io import rmat_graph, save_csv

    path = str(tmp_path / "g.csv")
    save_csv(rmat_graph(1500, 20_000, seed=4, name="small"), path)
    cfg, _ = FlexConfig.from_args([path, "--b_dtype=bfloat16"])
    assert cfg.prep_kwargs("ell")["b_dtype"] == "bfloat16"
    assert cfg.prep_kwargs("windowed")["b_dtype"] == "bfloat16"
    out_csv = tmp_path / "o.csv"
    assert cli.main([path, "16", "--order=ovo", "--method=ell",
                     "--b_dtype=bfloat16", "--iters=1", f"--csv={out_csv}",
                     "--device=cpu"]) == 0
    with open(out_csv) as f:
        (row,) = list(csv.DictReader(f))
    assert row["method"] == "ell" and float(row["err_frac"]) == 0.0
    assert "kernel launches: " in capsys.readouterr().out
