"""The precision ladder of a dense f32 product: speed and error of each
rung, at the shapes of one windowed panel step.

Counterpart of ``experiments/micro_precision.py``: P = 64 panels of A
[TM = 256, JW = 4096] (2 % of entries nonzero, uniform in [-1, 1)) times B
[JW, K = 128], the script's NumPy data as written (seed 0), the gold in
f64 on the device.  Each row prints ms, TF/s, the largest relative error
and the fraction of outputs beyond the script's tolerance
eps32 · max(row_nnz, 1) · 4 · max(|gold|, 1):

- ``default``: one product of bf16-rounded operands, f32 out (the TPU's
  DEFAULT);
- ``high``: three such products hi·hi + hi·lo + lo·hi (hi = bf16(x),
  lo = bf16(x − hi)), summed in f32 (the TPU's HIGH);
- ``highest``: ``torch.einsum`` in f32 with TF32 off (the TPU's HIGHEST,
  exact f32 on the card);
- ``tf32``: the card's own rung, not the TPU's: the f32 einsum under
  ``torch.set_float32_matmul_precision("high")`` (TF32 tensor cores).

The bf16 products take ``torch.bmm(..., out_dtype=torch.float32)`` where
this torch has it on the device, else kernel 12
(:func:`.micro.window_step_bf16`) with G = JW / 128 windows a step and
one step a panel; never a bf16 output, which would round the result.  On
the CPU every row is f32 arithmetic on the rounded operands (the host has
no TF32: its ``tf32`` row is the f32 product), timed on the host clock.
The script's compile-cache configuration is dropped.

    python -m flex_tpu_torch.experiments.micro_precision
"""
from __future__ import annotations

import numpy as np
import torch

from flex_tpu_torch.bench.harness import time_ms
from flex_tpu_torch.experiments import banner, exact_f32, micro, p
from flex_tpu_torch.experiments.high_precision_host import split_hi_lo
from flex_tpu_torch.sparse.device import resolve_device

TM, JW, K = 256, 4096, 128
P = 64               # batched panels per dispatch
W_STEP = 128         # kernel 12's window, when it carries the bf16 rows
EPS32 = float(np.finfo(np.float32).eps)
PRECISIONS = ("default", "high", "highest", "tf32")


def make_inputs(P: int = P, TM: int = TM, JW: int = JW, K: int = K,
                seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """The script's A f32 [P, TM, JW] (density ~2 %) and B f32 [JW, K]."""
    rng = np.random.default_rng(seed)
    A = np.zeros((P, TM, JW), np.float32)
    nz = rng.random((P, TM, JW)) < 0.02
    A[nz] = (2 * rng.random(nz.sum()) - 1).astype(np.float32)
    B = (2 * rng.random((JW, K)) - 1).astype(np.float32)
    return A, B


def bf16_product(A: torch.Tensor, B: torch.Tensor):
    """A function (a, b) -> f32 [P, TM, K] of one product of bf16 operands
    with an f32 result on this device, and its name.  ``a``, ``b`` are f32
    tensors holding bf16 values (rounded already)."""
    Pn, TMn, JWn = A.shape
    if A.device.type == "cpu":
        return (lambda a, b: (a.reshape(-1, JWn) @ b).view(Pn, TMn, -1)), \
            "f32 product of the rounded operands (host)"
    try:
        torch.bmm(A[:1, :16].bfloat16(), B[None, :, :8].bfloat16(),
                  out_dtype=torch.float32)

        def bmm(a, b):
            return torch.bmm(a.bfloat16(), b.bfloat16().expand(Pn, -1, -1),
                             out_dtype=torch.float32)

        return bmm, "torch.bmm bf16, out_dtype=float32"
    except (RuntimeError, NotImplementedError, TypeError):
        pass
    # kernel 12: step p is panel p, its windows the G blocks of B in order
    G = JWn // W_STEP
    dev = A.device
    first = torch.ones(Pn, dtype=torch.int32, device=dev)
    out_panel = torch.arange(Pn, dtype=torch.int32, device=dev)
    win = torch.arange(G, dtype=torch.int32, device=dev).repeat(Pn)
    ptr = torch.arange(Pn + 1, dtype=torch.int32, device=dev)

    def k12(a, b):
        return micro.window_step_bf16(
            first, out_panel, win, a, b, n_panels=Pn, W=W_STEP,
            panel_step_ptr=ptr).view(Pn, TMn, -1)

    return k12, "kernel 12 (window_step_bf16), G = JW / 128"


def rungs(A: torch.Tensor, B: torch.Tensor) -> dict:
    """name -> (function of no arguments giving f32 [P, TM, K], what runs
    it)."""
    a_hi, a_lo = split_hi_lo(A)
    b_hi, b_lo = split_hi_lo(B)
    prod, how = bf16_product(A, B)

    def tf32():
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        try:
            return torch.einsum("ptw,wk->ptk", A, B)
        finally:
            torch.set_float32_matmul_precision(prev)

    def highest():
        with exact_f32():
            return torch.einsum("ptw,wk->ptk", A, B)

    return {
        "default": (lambda: prod(a_hi, b_hi), how),
        "high": (lambda: prod(a_hi, b_hi) + prod(a_hi, b_lo)
                 + prod(a_lo, b_hi), f"3 x {how}, summed in f32"),
        "highest": (highest, "torch.einsum f32, TF32 off"),
        "tf32": (tf32, "the card's own rung: torch.einsum f32 under "
                 "set_float32_matmul_precision('high')"
                 if A.device.type == "cuda" else "f32 einsum (no TF32 on "
                 "the host)"),
    }


def main(device=None, P: int = P, TM: int = TM, JW: int = JW, K: int = K,
         seed: int = 0, iters: int = 50) -> dict:
    """The script's rows and the card's ``tf32`` row.  Returns each row's
    numbers and what ran it."""
    dev = resolve_device(device)
    p(banner(dev))
    A_h, B_h = make_inputs(P, TM, JW, K, seed)
    row_nnz = torch.from_numpy((A_h != 0).sum(axis=2)).to(dev)   # [P, TM]
    A = torch.from_numpy(A_h).to(dev)
    B = torch.from_numpy(B_h).to(dev)
    del A_h
    gold = torch.einsum("ptw,wk->ptk", A.double(), B.double())
    tol = (EPS32 * row_nnz.clamp_min(1)[:, :, None].double() * 4
           * gold.abs().clamp_min(1.0))
    flops = 2 * P * TM * JW * K
    res = {"device": banner(dev)}
    for prec, (f, how) in rungs(A, B).items():
        out = f()
        ms = time_ms(dev, f, iters=iters)
        err = (out.double() - gold).abs()
        frac_bad = float((err > tol).double().mean())
        max_rel = float((err / gold.abs().clamp_min(1e-30)).max())
        p(f"{prec:>8s}: {ms:7.3f} ms  {flops/ms/1e9:6.1f} TF/s  "
          f"max_rel={max_rel:.2e} frac_beyond_tol={frac_bad:.2e}  ({how})")
        res[prec] = {"ms": ms, "tflops": flops / ms / 1e9,
                     "max_rel": max_rel, "frac_beyond_tol": frac_bad,
                     "how": how}
        del out, err
    return res


if __name__ == "__main__":
    main()
