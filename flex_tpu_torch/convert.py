"""Carry a JAX plan's format arrays, and a JAX model's parameters, into
the port.

An SpMM plan has no weights: its parameters are the format arrays.  The
plan functions take a plan's fields as NumPy arrays (``np.asarray`` of
each JAX array) and return the port's plan on ``device``, so both
packages compute on identical formats.

``ell_plan_from_numpy`` keys: ``m``, ``nnz``, ``padded_nnz``,
``buckets`` (sequence of (cols [N,w], vals [N,w])), ``chunk_row``, and
optionally ``chunk1``, ``extras`` ((extra_idx, extra_first) or None) and
``bwd_plan`` (a dict of the same keys: the transposed-pattern plan).

``windowed_plan_from_numpy`` keys: ``m``, ``n``, ``tm``, ``W``,
``n_used_panels``, ``A``, ``first``, ``out_panel``, ``win_step``,
``row_gather``, ``coverage``, ``ell`` (a dict as above), and optionally
``min_count_eff`` and ``transposed`` (then ``A`` is the Aᵀ step array
[S, G·W, TM]).  The backward tables are recomputed from ``win_step`` and
``out_panel``; a transposed plan carries none.

``band_plan_from_numpy`` keys: ``m``, ``n``, ``tm``, ``w_pad``, ``impl``,
``band`` (one array [P, TM, W], or the (left, right) pair of
``impl="pallas2"``) and ``ws``.

``gespmm_plan_from_numpy`` keys: ``m``, ``w``, ``cols``, ``vals``,
``chunk_row``, ``nnz``, ``padded_nnz``.

``gcn_params_from_numpy`` loads the JAX GCN's parameter pytree
(``W1``, ``b1``, ``W2``, ``b2``) into the port's module.
"""
from __future__ import annotations

import numpy as np
import torch

from flex_tpu_torch.ops.ell_spmm import EllPlan
from flex_tpu_torch.ops.gespmm import GeSpmmPlan
from flex_tpu_torch.ops.pallas_band import BandPlan
from flex_tpu_torch.ops.window_spmm import (
    WindowedPlan, bwd_device_tables, panel_step_ptr,
)


def _t(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)  # a copy


def ell_plan_from_numpy(d: dict, device) -> EllPlan:
    extras = d.get("extras")
    chunk1 = d.get("chunk1")
    bwd_plan = d.get("bwd_plan")
    return EllPlan(
        m=int(d["m"]), nnz=int(d["nnz"]), padded_nnz=int(d["padded_nnz"]),
        buckets=tuple((_t(c, np.int32, device), _t(v, np.float32, device))
                      for c, v in d["buckets"]),
        chunk_row=_t(d["chunk_row"], np.int32, device),
        chunk1=None if chunk1 is None else _t(chunk1, np.int32, device),
        extras=None if extras is None else tuple(
            _t(e, np.int32, device) for e in extras),
        bwd_plan=None if bwd_plan is None
        else ell_plan_from_numpy(bwd_plan, device),
    )


def windowed_plan_from_numpy(d: dict, device) -> WindowedPlan:
    first = np.asarray(d["first"], np.int32)
    win_step = np.asarray(d["win_step"], np.int32)
    W = int(d["W"])
    transposed = bool(d.get("transposed", False))
    bwd = {}
    if len(first) and not transposed:
        bwd = bwd_device_tables(
            win_step, np.asarray(d["out_panel"], np.int32),
            max(-(-int(d["n"]) // W), 1), len(win_step) // len(first), W,
            device)
    return WindowedPlan(
        m=int(d["m"]), n=int(d["n"]), tm=int(d["tm"]), W=int(d["W"]),
        n_used_panels=int(d["n_used_panels"]),
        A=_t(d["A"], np.float32, device),
        first=_t(first, np.int32, device),
        out_panel=_t(d["out_panel"], np.int32, device),
        win_step=_t(win_step, np.int32, device),
        row_gather=_t(d["row_gather"], np.int32, device),
        panel_step_ptr=_t(panel_step_ptr(first), np.int32, device),
        ell=ell_plan_from_numpy(d["ell"], device),
        coverage=float(d["coverage"]),
        min_count_eff=int(d.get("min_count_eff", 0)),
        transposed=transposed,
        **bwd,
    )


def band_plan_from_numpy(d: dict, device) -> BandPlan:
    band = d["band"]
    band = tuple(_t(b, np.float32, device) for b in band) \
        if isinstance(band, (tuple, list)) else _t(band, np.float32, device)
    return BandPlan(m=int(d["m"]), n=int(d["n"]), tm=int(d["tm"]),
                    w_pad=int(d["w_pad"]), band=band,
                    ws=_t(d["ws"], np.int32, device), impl=str(d["impl"]))


def gespmm_plan_from_numpy(d: dict, device) -> GeSpmmPlan:
    return GeSpmmPlan(
        m=int(d["m"]), w=int(d["w"]), cols=_t(d["cols"], np.int32, device),
        vals=_t(d["vals"], np.float32, device),
        chunk_row=_t(d["chunk_row"], np.int32, device), nnz=int(d["nnz"]),
        padded_nnz=int(d["padded_nnz"]))


def gcn_params_from_numpy(params: dict, model) -> None:
    """Copy the four arrays of a JAX GCN parameter pytree into ``model``
    (a :class:`flex_tpu_torch.models.GCN`), on the module's own device."""
    with torch.no_grad():
        for name in ("W1", "b1", "W2", "b2"):
            p = getattr(model, name)
            a = torch.from_numpy(np.array(params[name], dtype=np.float32))
            if a.shape != p.shape:
                raise ValueError(f"{name}: shape {tuple(a.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(a)
