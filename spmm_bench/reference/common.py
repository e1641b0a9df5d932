"""The plain reference's common part: SpMM, dense products, masked
cross-entropy and full-graph training with Adam, in plain PyTorch.  Each
model's forward is a module of its own beside this one,
``reference/<model kind>.py``, with a ``forward(A, X, params, mode)``
built from :func:`spmm` and :func:`matmul`.

It imports nothing of the program and takes nothing the program made: it
gets the benchmark's graph (before ordering), the ordering's permutation,
which it checks, and the benchmark's inputs and weights.  It runs in one
of two precisions:

- ``"f64"``: every product and sum in float64.  This is the reference
  that each output of the program is judged against.
- ``"tf32"``: the control.  Both operands of every product (the SpMMs and
  the dense matrix products, forward and backward) are rounded to TF32
  (10 mantissa bits, round to nearest even) and the sums are float32:
  what a TF32 tensor core computes.  The configuration states exact
  float32 with TF32 off, so this is the nearest precision below it.

The SpMM is a gather, a multiply and an ``index_add_`` over the nonzeros
in blocks of at most :data:`BLOCK_ELEMS` products, so that it fits beside
what the run keeps.
"""
from __future__ import annotations

import math

import numpy as np
import torch

BLOCK_ELEMS = 1 << 28  # products per block of the gathered operand
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
MODES = ("f64", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32: the low 13 of the 23 mantissa bits
    cleared, rounding to nearest, ties to even."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def _dtype(mode: str) -> torch.dtype:
    if mode not in MODES:
        raise ValueError(f"unknown reference mode {mode!r}")
    return torch.float64 if mode == "f64" else torch.float32


def _operand(x: torch.Tensor, mode: str) -> torch.Tensor:
    """An operand of a product in ``mode``'s precision."""
    return x.to(torch.float64) if mode == "f64" else round_tf32(x)


def check_permutation(perm: np.ndarray, m: int) -> np.ndarray:
    """``perm`` (perm[new] = old) as int64 after checking that it is a
    permutation of range(m); returns its inverse (old → new)."""
    perm = np.asarray(perm)
    if perm.shape != (m,) or not np.issubdtype(perm.dtype, np.integer):
        raise ValueError(f"ordering has shape {perm.shape} and dtype "
                         f"{perm.dtype}, expected ({m},) integers")
    perm = perm.astype(np.int64)
    if m and (perm.min() < 0 or perm.max() >= m):
        raise ValueError("ordering has entries outside [0, m)")
    inv = np.full(m, -1, dtype=np.int64)
    inv[perm] = np.arange(m, dtype=np.int64)
    if (inv < 0).any():
        raise ValueError("ordering is not a permutation")
    return inv


class Adjacency:
    """A' = P·A·Pᵀ (rows and columns renumbered by the ordering) as COO
    tensors on ``device``: ``rows``, ``cols`` int64, ``vals`` float64."""

    def __init__(self, row_ptr, col, vals, perm, device):
        m = len(row_ptr) - 1
        inv = torch.from_numpy(check_permutation(perm, m)).to(device)
        deg = torch.from_numpy(np.diff(np.asarray(row_ptr, np.int64)))
        rows = torch.repeat_interleave(torch.arange(m), deg).to(device)
        self.m = m
        self.rows = inv[rows]
        self.cols = inv[torch.from_numpy(np.asarray(col, np.int64))
                        .to(device)]
        self.vals = torch.from_numpy(np.asarray(vals, np.float64)).to(device)

    def _apply(self, B, mode, transpose=False, absolute=False):
        dst, src = (self.cols, self.rows) if transpose else \
            (self.rows, self.cols)
        dt = _dtype(mode)
        vals = self.vals.abs() if absolute else self.vals
        vals = vals if mode == "f64" else round_tf32(vals.to(torch.float32))
        B = B.abs() if absolute else B
        B = _operand(B, mode)
        out = torch.zeros((self.m, B.shape[1]), dtype=dt, device=B.device)
        step = max(1, BLOCK_ELEMS // max(B.shape[1], 1))
        for s in range(0, len(vals), step):
            e = s + step
            out.index_add_(0, dst[s:e],
                           vals[s:e, None].to(dt) * B.index_select(0,
                                                                   src[s:e]))
        return out

    def mm(self, B, mode="f64"):
        """A'·B in ``mode``."""
        return self._apply(B, mode)

    def mm_t(self, G, mode="f64"):
        """A'ᵀ·G in ``mode``."""
        return self._apply(G, mode, transpose=True)

    def abs_mm(self, B):
        """|A'|·|B| in float64: the scale each SpMM output is judged on."""
        return self._apply(B, "f64", absolute=True)


class _Spmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, B, mode):
        ctx.A, ctx.mode = A, mode
        return A.mm(B, mode)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.A.mm_t(g, ctx.mode), None


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, X, W, mode):
        ctx.save_for_backward(X, W)
        ctx.mode = mode
        return _operand(X, mode) @ _operand(W, mode)

    @staticmethod
    def backward(ctx, g):
        X, W = ctx.saved_tensors
        m = ctx.mode
        gX = _operand(g, m) @ _operand(W, m).T if ctx.needs_input_grad[0] \
            else None
        gW = _operand(X, m).T @ _operand(g, m) if ctx.needs_input_grad[1] \
            else None
        return gX, gW, None


def spmm(A: Adjacency, B, mode="f64") -> torch.Tensor:
    """A'·B in ``mode``, differentiable in B (by A'ᵀ·G in ``mode``)."""
    return _Spmm.apply(A, B, mode)


def matmul(X, W, mode="f64") -> torch.Tensor:
    """X·W in ``mode``, differentiable in both."""
    return _Matmul.apply(X, W, mode)


def masked_xent(logits, y, mask) -> torch.Tensor:
    """Mean softmax cross-entropy over the nodes that ``mask`` selects."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, y.long()[:, None])[:, 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1)


def train(A: Adjacency, forward, X, y, mask, params, lr: float, steps: int,
          mode="f64"):
    """``steps`` full-graph steps of ``forward(A, X, params, mode)``'s
    masked cross-entropy and Adam
    (torch.optim.Adam's update: betas 0.9, 0.999, eps 1e-8 outside the
    root, bias-corrected).  Returns (losses, the first step's gradients,
    the parameters after the last step), each parameter in ``mode``'s
    storage type."""
    dt = _dtype(mode)
    theta = [p.detach().to(dt).clone() for p in params]
    Xd, maskd = X.to(dt), mask.to(dt)
    m1 = [torch.zeros_like(p) for p in theta]
    m2 = [torch.zeros_like(p) for p in theta]
    b1, b2 = ADAM_BETAS
    losses, first_grads = [], None
    for t in range(1, steps + 1):
        leaves = [p.clone().requires_grad_(True) for p in theta]
        loss = masked_xent(forward(A, Xd, leaves, mode), y, maskd)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = [g.detach().clone() for g in grads]
        with torch.no_grad():
            for p, g, a, s in zip(theta, grads, m1, m2):
                a.mul_(b1).add_(g, alpha=1 - b1)
                s.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = s.sqrt() / math.sqrt(1 - b2 ** t) + ADAM_EPS
                p.addcdiv_(a, denom, value=-lr / (1 - b1 ** t))
    return losses, first_grads, theta
