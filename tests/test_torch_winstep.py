"""E7 (``experiments/micro_winstep.py``) on the port: kernel 1's window
step at ``highest`` and kernel 12's at ``default``, against the script's
own Pallas body.

The script measures when it is imported, so its body (``kernel``,
``b_spec``, ``grid_spec``, ``call`` of ``run``) is taken out with ``ast``
and run with ``pallas_call`` in interpret mode at shrunk G, S, W, k, TM
and nblk.  The same NumPy inputs go through the port's ``run`` (the plain
versions on the CPU), held to the body at rtol = atol = 1e-5: at
``highest`` with four steps and with one step a panel; at ``default`` the
body gets A and B rounded to bf16 (f32 arrays holding bf16 values), which
is the TPU's DEFAULT dot, since JAX's DEFAULT on the CPU is full f32,
while the port gets them unrounded and rounds itself.  Kernel 12's plain
version is also held to a NumPy emulation on the rounded operands.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flex_tpu_torch import kernels
from flex_tpu_torch.experiments import micro, micro_winstep
from test_torch_micro import script_code, t

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(m=300, k=16, W=32, TM=32)    # nblk = 10


def bf16(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


def inputs(G, S, seed):
    rng = np.random.default_rng(seed)
    m, k, W, TM = (SMALL[x] for x in ("m", "k", "W", "TM"))
    nblk = -(-m // W)
    A = rng.random((S, TM, G * W), dtype=np.float32)
    B_pad = rng.random(((nblk + 1) * W, k), dtype=np.float32)
    return A, B_pad, nblk


def jax_run(G, S, precision, spp, A, B_pad, seed):
    """The script's ``run`` body on the CPU, its tables as it makes
    them, with the window ids from ``default_rng(seed)``."""
    m, k, W, TM = (SMALL[x] for x in ("m", "k", "W", "TM"))
    nblk = -(-m // W)
    n_panels = S // spp
    ns = script_code("micro_winstep", ("kernel", "b_spec", "grid_spec",
                                       "call"), within="run")(
        G=G, S=S, W=W, k=k, TM=TM, n_panels=n_panels, precision=precision)
    out_panel = jnp.asarray(np.repeat(np.arange(n_panels, dtype=np.int32),
                                      spp))
    first = jnp.asarray((np.arange(S) % spp == 0).astype(np.int32))
    win = jnp.asarray(np.random.default_rng(seed).integers(
        0, nblk, S * G).astype(np.int32))
    return np.asarray(ns["call"](first, out_panel, win, jnp.asarray(A),
                                 *([jnp.asarray(B_pad)] * G)))


def port_run(G, S, precision, spp, A, B_pad, seed):
    r = micro_winstep.run(G, S, precision, spp, device="cpu", A=t(A),
                          B_pad=t(B_pad), rng=np.random.default_rng(seed),
                          iters=1, yardsticks=False, **SMALL)
    return r["out"].numpy()


@pytest.mark.parametrize("G, S, spp", [(4, 8, 4), (2, 12, 4), (4, 8, 1),
                                       (3, 6, 1)])
def test_highest_matches_the_winstep_body(G, S, spp):
    A, B_pad, _ = inputs(G, S, seed=G * 10 + spp)
    ref = jax_run(G, S, "highest", spp, A, B_pad, seed=spp)
    np.testing.assert_allclose(port_run(G, S, "highest", spp, A, B_pad,
                                        seed=spp), ref, **TOL)


@pytest.mark.parametrize("G, S, spp", [(4, 8, 4), (2, 12, 4), (4, 4, 1)])
def test_default_matches_the_body_on_rounded_inputs(G, S, spp):
    A, B_pad, _ = inputs(G, S, seed=G + spp)
    # ~1/4 of A's entries keep more than bf16's 8 bits: rounding matters
    assert not np.array_equal(bf16(A), A)
    ref = jax_run(G, S, "default", spp, bf16(A), bf16(B_pad), seed=spp)
    got = port_run(G, S, "default", spp, A, B_pad, seed=spp)
    np.testing.assert_allclose(got, ref, **TOL)
    # and the unrounded body differs from it: the row is not f32's
    full = jax_run(G, S, "highest", spp, A, B_pad, seed=spp)
    assert np.abs(full - got).max() > 1e-3


def emulate_step_bf16(first, out_panel, win, A, B, n_panels, W):
    """Kernel 12's function in NumPy: every step's windows of bf16(B)
    (the sentinel id and rows >= n as zero) times bf16(A[s]) in f64,
    summed into its panel."""
    S, TM, GW = A.shape
    G = GW // W
    n, k = B.shape
    Br = np.zeros(((-(-n // W) + 1) * W, k))
    Br[:n] = bf16(B)
    Ar = bf16(A).astype(np.float64)
    C = np.zeros((n_panels, TM, k))
    for s in range(S):
        rows = (win[s * G:(s + 1) * G, None] * W
                + np.arange(W)[None, :]).reshape(-1)
        C[out_panel[s]] += Ar[s] @ Br[rows]
    return C.reshape(n_panels * TM, k)


@pytest.mark.parametrize("k, n", [(16, 200), (41, 130), (8, 97)])
def test_window_step_bf16_plain_against_numpy(k, n):
    rng = np.random.default_rng(k)
    W, G, TM = 32, 3, 24
    nblk = -(-n // W)
    steps = [1, 3, 2]
    S = sum(steps)
    out_panel = np.repeat(np.arange(len(steps)), steps).astype(np.int32)
    first = np.zeros(S, np.int32)
    first[np.cumsum([0] + steps[:-1])] = 1
    win = rng.integers(0, nblk + 1, S * G).astype(np.int32)  # sentinels too
    A = rng.random((S, TM, G * W), dtype=np.float32)
    B = rng.random((n, k), dtype=np.float32)
    got = micro.window_step_bf16(
        t(first), t(out_panel), t(win), t(A), t(B), n_panels=len(steps), W=W,
        panel_step_ptr=t(np.r_[0, np.cumsum(steps)].astype(np.int32)))
    ref = emulate_step_bf16(first, out_panel, win, A, B, len(steps), W)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_array_equal(
        got.numpy(), micro.window_step_bf16_plain(
            t(first), t(out_panel), t(win), t(A), t(B), n_panels=len(steps),
            W=W).numpy())


def test_window_step_bf16_refuses_what_it_does_not_take():
    A = torch.zeros((2, 8, 64))
    B = torch.zeros((100, 4))
    tabs = (torch.ones(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32))
    ptr = torch.tensor([0, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of W"):
        micro.window_step_bf16(*tabs, A, B, n_panels=1, W=48,
                               panel_step_ptr=ptr)
    with pytest.raises(ValueError, match="int32"):
        micro.window_step_bf16(*tabs[:2], tabs[2][:3], A, B, n_panels=1,
                               W=32, panel_step_ptr=ptr)
    with pytest.raises(ValueError, match="float32"):
        micro.window_step_bf16(*tabs, A.double(), B, n_panels=1, W=32,
                               panel_step_ptr=ptr)
    with pytest.raises(ValueError, match="no micro kernel"):
        micro.window_step_bf16(*(x.to("meta") for x in tabs),
                               A.to("meta"), B.to("meta"), n_panels=1, W=32,
                               panel_step_ptr=ptr.to("meta"))


def step_case(k, n, W=32, G=3, TM=24, seed=0):
    """Tables of three panels (1, 3 and 2 steps, sentinels among the
    windows), A and B, as NumPy arrays."""
    rng = np.random.default_rng(seed)
    nblk = -(-n // W)
    steps = [1, 3, 2]
    S = sum(steps)
    out_panel = np.repeat(np.arange(len(steps)), steps).astype(np.int32)
    first = np.zeros(S, np.int32)
    first[np.cumsum([0] + steps[:-1])] = 1
    win = rng.integers(0, nblk + 1, S * G).astype(np.int32)
    ptr = np.r_[0, np.cumsum(steps)].astype(np.int32)
    A = (2 * rng.random((S, TM, G * W)) - 1).astype(np.float32)
    B = (2 * rng.random((n, k)) - 1).astype(np.float32)
    return (first, out_panel, win), ptr, A, B, len(steps)


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("k", [41, 128, 200])
def test_plain_on_the_bf16_copy_of_B_is_the_plain_version(k, misaligned):
    """The kernel's B, cast once into rows of 16 bytes, holds the rounding
    the plain version makes itself: the plain version on it gives the same
    bits as on B (n % W != 0; B contiguous, or a view 4 bytes past a
    16-byte boundary)."""
    from flex_tpu_torch.ops.gespmm import bf16_layout, to_bf16_padded

    tabs, _, A, B, n_panels = step_case(k, n=130, seed=k)
    Bt = t(B)
    if misaligned:
        buf = torch.zeros(B.size + 1)
        buf[1:] = Bt.reshape(-1)
        Bt = buf[1:].view(B.shape)
        assert Bt.data_ptr() % 16 == 4
    Bb = to_bf16_padded(Bt)
    assert Bb.dtype == torch.bfloat16 and Bb.data_ptr() % 16 == 0
    assert Bb.stride(0) == bf16_layout(k)[0] and Bb.stride(0) % 8 == 0
    kw = dict(n_panels=n_panels, W=32)
    want = micro.window_step_bf16_plain(*map(t, tabs), t(A), Bt, **kw)
    got = micro.window_step_bf16_plain(*map(t, tabs), t(A), Bb, **kw)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(Bb.float().numpy(), bf16(B))


@pytest.fixture
def kernel_path(monkeypatch):
    """The wrapper's CUDA branch on CPU tensors, up to the launch: the
    device check says "cuda" and ``kernels.launch`` records its calls."""
    calls = []
    monkeypatch.setattr(micro, "_device_of",
                        lambda **tensors: torch.device("cuda", 0))
    monkeypatch.setattr(kernels, "launch",
                        lambda name, symbol, dev, *args: calls.append(
                            (symbol, args)))
    return calls


def test_window_step_bf16_hands_the_kernel_a_bf16_B(kernel_path):
    tabs, ptr, A, B, n_panels = step_case(41, n=130)
    before = micro.window_step_bf16.launches
    out = micro.window_step_bf16(*map(t, tabs), t(A), t(B),
                                 n_panels=n_panels, W=32,
                                 panel_step_ptr=t(ptr))
    assert micro.window_step_bf16.launches == before + 1
    assert out.shape == (n_panels * 24, 41) and out.dtype == torch.float32
    symbols = [c[0] for c in kernel_path]
    assert symbols == ["flex_winstep_bf16", "flex_window_spmm_reduce"]
    args = kernel_path[0][1]
    # (A, Bb, win_step, units, out, scratch, n_units, TM, G, W, n, k,
    #  nblk, S, ldb): S and B's row stride after kernel 1's arguments
    assert args[6:] == (3, 24, 3, 32, 130, 41, 5, 6, 48)


def test_window_step_bf16_refuses_on_its_kernel_path(kernel_path):
    tabs, ptr, A, B, n_panels = step_case(16, n=130)
    kw = dict(n_panels=n_panels, panel_step_ptr=t(ptr))
    A40 = t(np.zeros((6, 24, 80), np.float32))   # G = 2 windows of 40
    with pytest.raises(ValueError, match="W % 16 == 0"):
        micro.window_step_bf16(*map(t, tabs[:2]), t(tabs[2][:12]), A40,
                               t(B), W=40, **kw)
    buf = torch.zeros(A.size + 1)
    Am = buf[1:].view(A.shape)                   # 4 bytes past 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        micro.window_step_bf16(*map(t, tabs), Am, t(B), W=32, **kw)
    with pytest.raises(ValueError, match="float32"):
        micro.window_step_bf16(*map(t, tabs), t(A), t(B).bfloat16(), W=32,
                               **kw)
    assert kernel_path == []


def test_precision_names():
    assert micro_winstep.step_fn("highest").__name__ == "window_spmm_fwd"
    assert micro_winstep.step_fn("default") is micro.window_step_bf16
    with pytest.raises(ValueError, match="precision"):
        micro_winstep.step_fn("high")


def test_main_prints_the_scripts_rows(capsys):
    before = {**kernels.launch_counts(), **micro.launch_counts()}
    r = micro_winstep.main(device="cpu", windows=96, iters=1, **SMALL)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device: cpu")
    rows = [line for line in out if line.startswith("G=")]
    assert [line.split(":")[0] for line in rows] == [
        "G=4 S=24  highest", "G=4 S=24  default", "G=8 S=12  highest",
        "G=8 S=12  default", "G=4 S=24  highest"]
    assert all("us/step" in line and "mxu=" in line and "dma=" in line
               for line in rows)
    assert sum("plain" in line and "library" in line for line in out) == 5
    assert set(r) == {"device"} | {f"G={G} spp={spp} {prec}"
                                   for G, prec, spp in micro_winstep.ROWS}
    row = r["G=4 spp=4 default"]
    assert row["flops"] == 2 * 24 * 32 * 4 * 32 * 16
    assert row["library_call"] == "torch.bmm bf16, bf16 output"
    assert {**kernels.launch_counts(), **micro.launch_counts()} == before
