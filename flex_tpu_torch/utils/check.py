"""Result verification with the per-row tolerance model (host, NumPy).

Copy of ``flex_tpu.utils.check``: in :func:`res_check` the tolerance for
row r is ``eps_f32 · row_nnz(r) · 4``, relative when |gold| ≥ 1 and
absolute otherwise; a gold output that is mostly zeros is refused; with
``verbose`` it prints up to ``max_report`` mismatches, one line each.
:func:`res_check2` is the plain |diff| > tol variant.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CheckResult:
    n_bad: int
    n_total: int
    max_err: float
    err_frac: float  # fraction of outputs beyond tolerance

    @property
    def ok(self) -> bool:
        return self.n_bad == 0


def res_check(
    gold: np.ndarray,
    res: np.ndarray,
    row_nnz: np.ndarray,
    eps_scale: float = 4.0,
    max_report: int = 20,
    verbose: bool = False,
) -> CheckResult:
    gold = np.asarray(gold, dtype=np.float32)
    res = np.asarray(res, dtype=np.float32)
    if gold.shape != res.shape:
        raise ValueError(f"shape mismatch {gold.shape} vs {res.shape}")
    eps = np.finfo(np.float32).eps
    tol = (eps * eps_scale) * np.maximum(row_nnz, 1).astype(np.float64)[:, None]

    diff = np.abs(gold.astype(np.float64) - res.astype(np.float64))
    denom = np.abs(gold.astype(np.float64))
    err = np.where(denom >= 1.0, diff / np.maximum(denom, 1e-300), diff)
    bad = err > tol

    n_bad = int(bad.sum())
    if verbose and n_bad:
        for r, c in np.argwhere(bad)[:max_report]:
            print(f"  mismatch C[{r},{c}]: gold={gold[r, c]:.6g} "
                  f"got={res[r, c]:.6g} err={err[r, c]:.3g} "
                  f"tol={tol[r, 0]:.3g}")
    nz_frac = float((gold != 0).mean()) if gold.size else 0.0
    if gold.size and nz_frac < 0.01:
        raise AssertionError(f"gold output suspiciously sparse ({nz_frac:.2%} nonzero)")

    return CheckResult(
        n_bad=n_bad,
        n_total=gold.size,
        max_err=float(err.max()) if gold.size else 0.0,
        err_frac=n_bad / max(gold.size, 1),
    )


def res_check2(gold: np.ndarray, res: np.ndarray, tol: float = 0.01) -> CheckResult:
    """Plain absolute-difference check."""
    diff = np.abs(np.asarray(gold, np.float64) - np.asarray(res, np.float64))
    bad = diff > tol
    return CheckResult(
        n_bad=int(bad.sum()),
        n_total=diff.size,
        max_err=float(diff.max()) if diff.size else 0.0,
        err_frac=float(bad.mean()) if diff.size else 0.0,
    )
