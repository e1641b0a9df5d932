"""The ported probes of ``experiments/`` against the JAX scripts' own code.

The scripts run their measurements when they are imported, so their code
is taken out of the source with ``ast``: each Pallas body (``kernel`` of
``m3_final``, ``kernel2`` of ``m3_row_dma``, the body of
``m6_vmem_probe``, ``k_take`` / ``k_dynslice`` / ``k_onehot``, ``kernel`` /
``mxu_kernel``) with the script's own ``pallas_call`` and BlockSpecs, and
the XLA functions the scripts time, is executed with the script's closure
constants shrunk, every ``pallas_call`` in interpret mode.  The same numpy
inputs then go through the port's function (its plain path on the CPU),
held to the JAX output at rtol = atol = 1e-5; ``k_onehot`` (bf16 rounding
of a copy) and the copies are exact, the ``u16x2`` planes and rebuilt
rows bit-exact.  The kernels' plain versions are also held to a NumPy
emulation of each kernel's own order of sums (bit for bit where the card
check is), and each module's ``main(device="cpu")`` runs at small sizes.
"""
import ast
import functools
import pathlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from flex_tpu_torch import kernels
from flex_tpu_torch.experiments import (
    micro, micro_dma_u16, micro_ellreduce, micro_tpu, micro_vmem_gather,
)

TOL = dict(rtol=1e-5, atol=1e-5)
EXPERIMENTS = pathlib.Path(__file__).resolve().parents[1] / "experiments"

# ``pl`` with every pallas_call in interpret mode: the scripts' calls run
# on the CPU as written
PL_INTERPRET = types.SimpleNamespace(
    **{a: getattr(pl, a) for a in dir(pl) if not a.startswith("__")})
PL_INTERPRET.pallas_call = functools.partial(pl.pallas_call, interpret=True)


def _name(node):
    if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
        return node.name
    if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
        return node.targets[0].id
    return None


def script_code(script: str, names, within: str | None = None) -> dict:
    """Execute the definitions ``names`` of ``experiments/<script>.py`` (in
    the function ``within``, at any depth of its body, else at the top of
    the module) in the order they appear, with ``consts`` bound as the
    script's closure or module constants.  Returns a function of the
    constants that gives the namespace."""
    tree = ast.parse((EXPERIMENTS / f"{script}.py").read_text())
    scope = tree
    if within is not None:
        scope = next(n for n in tree.body
                     if isinstance(n, ast.FunctionDef) and n.name == within)
    nodes = [n for n in ast.walk(scope) if n is not scope
             and _name(n) in names and (within is not None or n in tree.body)]
    # a definition nested in another one that is taken is taken with it
    nodes = [n for n in nodes if not any(
        n is not o and n in ast.walk(o) for o in nodes)]
    nodes.sort(key=lambda n: n.lineno)
    assert {_name(n) for n in nodes} == set(names), (script, names)
    code = compile(ast.Module(body=nodes, type_ignores=[]),
                   str(EXPERIMENTS / f"{script}.py"), "exec")

    def run(**consts):
        ns = dict(jax=jax, jnp=jnp, np=np, pl=PL_INTERPRET, pltpu=pltpu,
                  **consts)
        exec(code, ns)
        return ns
    return run


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- kernel 8: micro_dma_u16.m3_final (E1), micro_tpu.m3_row_dma (E2) --------

def test_m3_final_matches_the_dma_ring_body():
    m, k, rps, steps = 2048, 128, 48, 3
    ns = script_code("micro_dma_u16", ("kernel", "call"), within="m3_final")(
        m=m, k=k, ROWS_PER_STEP=rps, N_STEPS=steps, DEPTH=16)
    rng = np.random.default_rng(0)
    B = rng.random((m, k), dtype=np.float32)
    idx = rng.integers(0, m, (steps * 8, 128)).astype(np.int32)
    ref = np.asarray(ns["call"](jnp.asarray(idx), jnp.asarray(B)))
    got = micro_dma_u16.m3_final(t(B), t(idx), rows_per_step=rps, iters=1)
    np.testing.assert_allclose(got["out_row0"].numpy(), ref[0], **TOL)
    # every step's sum, not only the last that the script keeps
    blocks = idx.reshape(steps, -1)[:, :rps]
    np.testing.assert_allclose(got["sums"].numpy(),
                               B.astype(np.float64)[blocks].sum(1), **TOL)


def test_m3_row_dma_matches_kernel2():
    m, k, rps, steps = 1024, 128, 40, 3
    ns = script_code("micro_tpu", ("kernel2", "grid_spec", "call"),
                     within="m3_row_dma")(
        m=m, k=k, rows_per_step=rps, n_steps=steps, DEPTH=8)
    rng = np.random.default_rng(1)
    B = rng.random((m, k), dtype=np.float32)
    idx = rng.integers(0, m, (steps, rps)).astype(np.int32)
    ref = np.asarray(ns["call"](jnp.asarray(idx), jnp.asarray(B)))
    got = micro_tpu.m3_row_dma(t(B), t(idx), iters=1)
    np.testing.assert_allclose(got["out_row0"].numpy(), ref[0], **TOL)


def emulate_gather_sum(B, idx, warps=micro.GATHER_WARPS):
    """Kernel 8's order in NumPy f32: warp w of a step adds the step's rows
    w, w + 8, ... in turn from 0, then warp 0 adds the warp sums in
    order."""
    out = np.zeros((idx.shape[0], B.shape[1]), np.float32)
    for s, row in enumerate(idx):
        acc = np.zeros((warps, B.shape[1]), np.float32)
        for i, r in enumerate(row):
            acc[i % warps] = acc[i % warps] + B[r]
        tot = acc[0].copy()
        for w in range(1, warps):
            tot = tot + acc[w]
        out[s] = tot
    return out


@pytest.mark.parametrize("rows", [1, 7, 8, 37, 200])
def test_gather_sum_plain_sums_in_the_kernels_order(rows):
    rng = np.random.default_rng(rows)
    B = (rng.standard_normal((300, 12)) * 10.0 ** rng.integers(
        -3, 4, (300, 1))).astype(np.float32)
    idx = rng.integers(0, 300, (4, rows)).astype(np.int32)
    got = micro.row_gather_sum_plain(t(B), t(idx)).numpy()
    assert np.array_equal(got.view(np.int32),
                          emulate_gather_sum(B, idx).view(np.int32))
    # the wrapper on CPU tensors is the plain version, and counts nothing
    before = micro.row_gather_sum.launches
    assert torch.equal(micro.row_gather_sum(t(B), t(idx), depth=8),
                       t(got))
    assert micro.row_gather_sum.launches == before


# -- kernel 9: micro_tpu.m6_vmem_probe (E3) -----------------------------------

def test_smem_probe_matches_the_vmem_probe_body():
    tree = ast.parse((EXPERIMENTS / "micro_tpu.py").read_text())
    fn = next(n for n in tree.body
              if getattr(n, "name", "") == "m6_vmem_probe")
    loop = next(n for n in fn.body if isinstance(n, ast.For))
    body = [n for n in ast.walk(loop) if _name(n) in ("kernel", "f")]
    ns = dict(jax=jax, jnp=jnp, pl=PL_INTERPRET, pltpu=pltpu, nrows=64)
    exec(compile(ast.Module(body=body, type_ignores=[]), "micro_tpu.py",
                 "exec"), ns)
    x = np.random.default_rng(2).random((8, 128), dtype=np.float32)
    ref = np.asarray(ns["f"](jnp.asarray(x)))
    for kb in (48, 227):
        assert np.array_equal(micro.smem_probe(t(x), kb * 1024).numpy(), ref)
    r = micro_tpu.m6_vmem_probe(device="cpu")
    assert r == {"ok_kb": 228, "refused_kb": None, "limit_bytes": None}


@pytest.mark.parametrize("ok, refused, limit, good", [
    (227, 228, 232_448, True),     # the H100's limit
    (224, 227, 232_448, False),    # a refusal at the limit
    (228, None, 232_448, False),   # nothing refused above it
    (160, 224, 200_000, True),     # another card's limit
])
def test_probe_limit_check(ok, refused, limit, good):
    call = functools.partial(micro_tpu.check_probe_limit,
                             micro_tpu.SMEM_SIZES_KB, ok, refused, limit)
    if good:
        call()
    else:
        with pytest.raises(AssertionError):
            call()


@pytest.mark.parametrize("call", [
    lambda: micro.smem_probe(torch.ones(8, 128), 4094),
    lambda: micro.smem_probe(torch.ones(8, 64), 8192),
    lambda: micro.row_gather_sum(torch.ones(4, 8), torch.zeros(
        (1, 2), dtype=torch.int32), depth=3),
    lambda: micro.row_gather_sum(torch.ones(4, 8), torch.zeros(
        (1, 2), dtype=torch.int64)),
    lambda: micro.slab_gather(torch.ones(4, 8), torch.zeros(
        2, dtype=torch.int32), placement="vmem"),
    lambda: micro.ell_reduce(torch.ones(4, 3), torch.ones(4, 2, 8)),
    lambda: micro.ell_reduce(torch.ones(4, 3, dtype=torch.float64),
                             torch.ones(4, 3, 8)),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()


# -- kernel 10: micro_vmem_gather (E4) ----------------------------------------

VMEM = dict(U=64, K=128, RB=16, R=128, STEPS=2)


@pytest.mark.parametrize("body", ["k_take", "k_dynslice", "k_onehot"])
def test_vmem_gather_bodies(body):
    ns = script_code("micro_vmem_gather", ("make", body))(**VMEM)
    rng = np.random.default_rng(3)
    slab = rng.random((VMEM["U"], VMEM["K"]), dtype=np.float32)
    idx = rng.integers(0, VMEM["U"], (VMEM["STEPS"] * 8, VMEM["RB"])
                       ).astype(np.int32)
    f = ns["make"](jnp.asarray(idx), jnp.asarray(slab), ns[body])
    ref = np.asarray(f(jnp.asarray(idx), jnp.asarray(slab)))
    got = getattr(micro_vmem_gather, body)(t(idx), t(slab)).numpy()
    assert got.shape == ref.shape == (VMEM["R"], VMEM["K"])
    assert np.array_equal(got, ref)  # a copy, or bf16 rounding of one


@pytest.mark.parametrize("placement", micro.PLACEMENTS)
@pytest.mark.parametrize("round_bf16", [False, True])
def test_slab_gather_plain(placement, round_bf16):
    rng = np.random.default_rng(4)
    slab = rng.standard_normal((50, 20)).astype(np.float32)
    idx = rng.integers(0, 50, (3, 7)).astype(np.int32)
    got = micro.slab_gather(t(slab), t(idx), placement, round_bf16).numpy()
    src = np.asarray(jnp.asarray(slab).astype(jnp.bfloat16).astype(
        jnp.float32)) if round_bf16 else slab
    assert np.array_equal(got, src[idx.reshape(-1)])


# -- kernel 11: micro_ellreduce (E5, E6) --------------------------------------

ELL = dict(N=128, w=16, k=32, CB=64)


@pytest.mark.parametrize("name, body", [
    ("pallas_reduce", "kernel"), ("pallas_reduce_mxu", "mxu_kernel"),
    ("xla_reduce", None)])
def test_ellreduce_matches_the_script(name, body):
    names = (name,) if body is None else (body, name)
    ns = script_code("micro_ellreduce", names)(**ELL)
    rng = np.random.default_rng(5)
    v = rng.random((ELL["N"], ELL["w"]), dtype=np.float32)
    Bg = rng.random((ELL["N"], ELL["w"], ELL["k"]), dtype=np.float32)
    ref = np.asarray(ns[name](jnp.asarray(v), jnp.asarray(Bg)))
    got = getattr(micro_ellreduce, name)(t(v), t(Bg)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_ell_reduce_plain_within_the_kernels_order_bound():
    """The kernel sums j in order with one rounding a term (fmaf); the plain
    version's order differs, so the card check holds them to the f32
    order bound 2·w·eps·Σ_j |v·Bg|, which this emulation of the kernel's
    order in float64-then-f32 steps respects."""
    rng = np.random.default_rng(6)
    v = rng.standard_normal((40, 33)).astype(np.float32)
    Bg = rng.standard_normal((40, 33, 8)).astype(np.float32)
    acc = np.zeros((40, 8), np.float32)
    for j in range(33):   # fmaf: the exact product added, rounded once
        acc = (acc.astype(np.float64) + v[:, j, None].astype(np.float64)
               * Bg[:, j]).astype(np.float32)
    got = micro.ell_reduce(t(v), t(Bg)).numpy()
    bound = 2 * 33 * np.finfo(np.float32).eps * np.abs(
        v[:, :, None] * Bg).sum(1)
    assert np.all(np.abs(got - acc) <= bound)


# -- u16x2 (plain, micro_dma_u16) ---------------------------------------------

def test_u16x2_planes_and_sums_match_the_script():
    NN, w, k, m = 40, 8, 16, 300
    rng = np.random.default_rng(7)
    B = rng.standard_normal((m, k)).astype(np.float32)
    cols = rng.integers(0, m, (NN, w)).astype(np.int32)
    v = np.ones((NN, w), np.float32)
    # the planes, from the script's own lines on this B
    ns = script_code("micro_dma_u16", ("Bi", "B_hi", "B_lo", "spmm_u16",
                                       "u16_small"), within="u16x2")(
        NN=NN, w=w, k=k, B=jnp.asarray(B))
    hi, lo = micro_dma_u16.u16_planes(t(B))
    assert np.array_equal(hi.numpy().view(np.uint16), np.asarray(ns["B_hi"]))
    assert np.array_equal(lo.numpy().view(np.uint16), np.asarray(ns["B_lo"]))
    ids = cols[:2].reshape(-1)
    rebuilt = micro_dma_u16.u16_small(t(ids), hi, lo).numpy()
    ref = np.asarray(ns["u16_small"](jnp.asarray(ids), ns["B_hi"],
                                     ns["B_lo"]))
    assert np.array_equal(rebuilt.view(np.int32), ref.view(np.int32))
    assert np.array_equal(rebuilt.view(np.int32), B[ids].view(np.int32))
    ref_sum = np.asarray(ns["spmm_u16"](jnp.asarray(cols), jnp.asarray(v),
                                        ns["B_hi"], ns["B_lo"]))
    for step in (NN, 16):   # chunking does not change a row's sum
        got = micro_dma_u16.spmm_u16(t(cols), t(v), hi, lo, step=step)
        np.testing.assert_allclose(got.numpy(), ref_sum, **TOL)
    r = micro_dma_u16.u16x2(t(B), t(cols), t(v), take_rows=10, iters=1)
    assert r["bits_equal"] and r["max_abs_diff"] == 0.0


# -- the plain probes of micro_tpu against the scripts' XLA functions --------

def test_plain_probes_match_the_scripts_xla_functions():
    m, nnz, k, w = 200, 3_000, 16, 7
    rng = np.random.default_rng(8)
    rows = np.sort(rng.integers(0, m, nnz)).astype(np.int32)
    cols = rng.integers(0, m, nnz).astype(np.int32)
    vals = rng.random(nnz, dtype=np.float32)
    B = rng.random((m, k), dtype=np.float32)
    z = rng.random((nnz, k), dtype=np.float32)
    ecols = rng.integers(0, m, (m, w)).astype(np.int32)
    evals = rng.random((m, w), dtype=np.float32)

    m1 = script_code("micro_tpu", ("spmm",), within="m1_xla_spmm")(m=m)
    np.testing.assert_allclose(
        micro_tpu.xla_spmm(t(rows).long(), t(cols).long(), t(vals), t(B),
                           m).numpy(),
        np.asarray(m1["spmm"](*map(jnp.asarray, (rows, cols, vals, B)))),
        **TOL)
    m2 = script_code("micro_tpu", ("f",), within="m2_gather_bw")()
    assert np.array_equal(
        torch.index_select(t(B), 0, t(cols).long()).numpy(),
        np.asarray(m2["f"](jnp.asarray(cols), jnp.asarray(B))))
    m4 = script_code("micro_tpu", ("f",), within="m4_segsum")(m=m)
    np.testing.assert_allclose(
        micro_tpu.segsum(t(rows).long(), t(z), m).numpy(),
        np.asarray(m4["f"](jnp.asarray(rows), jnp.asarray(z))), **TOL)
    m8 = script_code("micro_tpu", ("ell",), within="m_ell_fused")()
    np.testing.assert_allclose(
        micro_tpu.ell(t(ecols), t(evals), t(B)).numpy(),
        np.asarray(m8["ell"](*map(jnp.asarray, (ecols, evals, B)))), **TOL)


def test_m5_peaks_restores_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    r = micro_tpu.m5_peaks(n=32, stream_len=2048, device="cpu", iters=1)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert set(r) == {"f32_tf32", "f32_highest", "bf16", "stream"}
    assert all(v["ms"] > 0 for v in r.values())


# -- the slice as a whole: each module's main on the CPU ---------------------

MAINS = {
    "micro_ellreduce": lambda: micro_ellreduce.main(
        "cpu", N=200, w=8, k=16, iters=1),
    "micro_dma_u16": lambda: micro_dma_u16.main(
        "cpu", u16x2=dict(m=500, k=16, w=8, NN=100, take_rows=20, iters=1),
        m3_final=dict(m=1000, k=16, rows_per_step=50, n_steps=3, iters=1)),
    "micro_tpu": lambda: micro_tpu.main(
        "cpu", m5_peaks=dict(n=32, stream_len=2048, iters=1),
        m3_row_dma=dict(rows_per_step=30, n_steps=4, m=500, k=16, iters=1),
        m2_gather_bw=dict(m=500, k=16, nrows=1000, iters=1),
        m4_segsum=dict(m=300, nnz=3000, k=8, iters=1),
        m1_xla_spmm=dict(m=300, nnz=3000, k=8, iters=1),
        m_ell_fused=dict(m=300, k=8, w=5, iters=1)),
    "micro_vmem_gather": lambda: micro_vmem_gather.main(
        "cpu", slab=torch.rand(64, 16), idx=torch.randint(
            0, 64, (4 * 8, 10), dtype=torch.int32), iters=1),
}
MAIN_KEYS = {
    "micro_ellreduce": {"xla", "pallas_vpu", "pallas_mxu", "bytes"},
    "micro_dma_u16": {"u16x2", "m3_final"},
    "micro_tpu": set(micro_tpu.SEQUENCE),
    "micro_vmem_gather": {tag for tag, _ in micro_vmem_gather.BODIES},
}


@pytest.mark.parametrize("name", list(MAINS))
def test_main_on_the_cpu(name, capsys):
    before = {**kernels.launch_counts(), **micro.launch_counts()}
    r = MAINS[name]()
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device: cpu") and len(out) > 1
    assert set(r) == MAIN_KEYS[name] | {"device"}
    # no kernel on the host
    assert {**kernels.launch_counts(), **micro.launch_counts()} == before
    if name == "micro_ellreduce":
        assert all(r[n]["maxerr"] <= 1e-5 for n in ("xla", "pallas_vpu",
                                                    "pallas_mxu"))
    if name == "micro_dma_u16":
        assert r["u16x2"]["bits_equal"]


# the modules of the fourteenth slice: E7, E8, the precision pair and the
# windowed and training studies
SLICE_MODULES = {"micro_winstep", "pallas_band_v2", "micro_precision",
                 "high_precision_host", "gen_graphs", "bench_windowed",
                 "profile_windowed", "sweep_windowed_r3", "sweep_windowed_r4",
                 "analyze_windows", "subtile_occupancy", "bench_gcn_train"}


def test_probes_import_no_jax():
    paths = list((pathlib.Path(micro.__file__).parent).glob("*.py"))
    assert SLICE_MODULES <= {path.stem for path in paths}
    for path in paths:
        tree = ast.parse(path.read_text())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names} | {n.module for n in ast.walk(tree)
                                     if isinstance(n, ast.ImportFrom)
                                     and n.module}
        assert not {mod for mod in mods if mod == "jax" or mod.startswith(
            ("jax.", "flex_tpu.", "ml_dtypes")) or mod in (
            "flex_tpu", "ml_dtypes")}, path


def test_entry_points_default_to_the_card(monkeypatch):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    slice_mains = [importlib.import_module(
        f"flex_tpu_torch.experiments.{name}").main
        for name in sorted(SLICE_MODULES)]
    for call in (micro_ellreduce.main, micro_dma_u16.main, micro_tpu.main,
                 micro_vmem_gather.main, *slice_mains):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_probe_launch_counts_stay_out_of_the_package_registry():
    counts = micro.launch_counts()
    assert set(counts) == {"row_gather_sum", "smem_probe", "slab_gather",
                           "ell_reduce", "window_step_bf16"}
    assert not set(counts) & set(kernels.launch_counts())
    micro.reset_launch_counts()
    assert set(micro.launch_counts().values()) == {0}
