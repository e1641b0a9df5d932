"""Carry a JAX plan's format arrays into the port's plans.

The system has no weights: its parameters are the format arrays.  These
functions take a plan's fields as NumPy arrays (``np.asarray`` of each
JAX array) and return the port's plan on ``device``, so both packages
compute on identical formats.

``ell_plan_from_numpy`` keys: ``m``, ``nnz``, ``padded_nnz``,
``buckets`` (sequence of (cols [N,w], vals [N,w])), ``chunk_row``, and
optionally ``chunk1`` and ``extras`` ((extra_idx, extra_first) or None).

``windowed_plan_from_numpy`` keys: ``m``, ``n``, ``tm``, ``W``,
``n_used_panels``, ``A``, ``first``, ``out_panel``, ``win_step``,
``row_gather``, ``coverage``, ``ell`` (a dict as above), and optionally
``min_count_eff``.
"""
from __future__ import annotations

import numpy as np
import torch

from flex_tpu_torch.ops.ell_spmm import EllPlan
from flex_tpu_torch.ops.window_spmm import WindowedPlan, panel_step_ptr


def _t(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)  # a copy


def ell_plan_from_numpy(d: dict, device) -> EllPlan:
    extras = d.get("extras")
    chunk1 = d.get("chunk1")
    return EllPlan(
        m=int(d["m"]), nnz=int(d["nnz"]), padded_nnz=int(d["padded_nnz"]),
        buckets=tuple((_t(c, np.int32, device), _t(v, np.float32, device))
                      for c, v in d["buckets"]),
        chunk_row=_t(d["chunk_row"], np.int32, device),
        chunk1=None if chunk1 is None else _t(chunk1, np.int32, device),
        extras=None if extras is None else tuple(
            _t(e, np.int32, device) for e in extras),
    )


def windowed_plan_from_numpy(d: dict, device) -> WindowedPlan:
    first = np.asarray(d["first"], np.int32)
    return WindowedPlan(
        m=int(d["m"]), n=int(d["n"]), tm=int(d["tm"]), W=int(d["W"]),
        n_used_panels=int(d["n_used_panels"]),
        A=_t(d["A"], np.float32, device),
        first=_t(first, np.int32, device),
        out_panel=_t(d["out_panel"], np.int32, device),
        win_step=_t(d["win_step"], np.int32, device),
        row_gather=_t(d["row_gather"], np.int32, device),
        panel_step_ptr=_t(panel_step_ptr(first), np.int32, device),
        ell=ell_plan_from_numpy(d["ell"], device),
        coverage=float(d["coverage"]),
        min_count_eff=int(d.get("min_count_eff", 0)),
    )
