"""Row-sharded windowed-hybrid SpMM across a mesh of torch devices.

Counterpart of ``flex_tpu.parallel.window_sharded``.  The rows are cut by
nnz as in :mod:`.spmm_sharded`; per shard:

- the window selection runs on the shard's rows (host, with a per-shard
  ``max_dense_bytes``: each shard's count gate rises to fit its device);
- the format build runs on the shard's device from its slice of the
  resident CSR (moved device-to-device): dense A and the residue's ELL
  buckets, the residue under the same row bounds and with the buckets'
  common allocation over the shards (the JAX package's
  ``_assemble_sharded_residue``);
- the call runs kernel 1 (the dense half) and kernel 7 (the residue,
  added into it) on the shard's device.

Row ownership is exclusive, so no reduction runs between devices; the
shards' rows are concatenated on the mesh's first device.  The JAX
package pads every shard to the most steps of any shard, because
``shard_map`` wants one shape; here each shard keeps its own step count,
so ``stats["dense_bytes"]`` counts real steps only (``S_max`` is the same).
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from flex_tpu_torch.ops.ell_spmm import EllPlan
from flex_tpu_torch.ops.window_spmm import (
    WindowedPlan, _build_windowed_ell, _device_tables, pattern_is_unique,
    plan_from_selection, residue_layout, window_select,
)
from flex_tpu_torch.parallel.mesh import Mesh
from flex_tpu_torch.parallel.spmm_sharded import (
    SHARDED_WIDTHS, ShardedEllPlan, _split_rows_by_nnz, common_bucket_alloc,
    mesh_shard_devices, shard_csr,
)
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.sparse.device import DeviceCSR


@dataclasses.dataclass
class ShardedWindowedPlan:
    mesh: Mesh
    axis: str
    m: int
    n: int
    tm: int
    W: int
    row_bounds: list[tuple[int, int]]
    m_shard_pad: int
    plans: tuple[WindowedPlan, ...]     # shard d's rows, on devices[d]
    devices: tuple[torch.device, ...]
    coverage: float
    impl: str = "pallas"
    res_shard_nnz: tuple = ()
    # per shard (dense_bytes, min_count_eff, coverage): the realized
    # budgeted selection of each device
    shard_sel: tuple = ()

    def shard_outputs(self, B) -> list[torch.Tensor]:
        """Shard d's C rows, f32 on devices[d] (dense half + residue)."""
        return [p(B.to(d)) for p, d in zip(self.plans, self.devices)]

    def __call__(self, B) -> torch.Tensor:
        home = self.devices[0]
        return torch.cat([o.to(home) for o in self.shard_outputs(B)])

    @property
    def ell(self) -> ShardedEllPlan:
        """The residue: the shards' ELL plans as one sharded plan under the
        same row bounds."""
        plans = tuple(p.ell for p in self.plans)
        return ShardedEllPlan(
            mesh=self.mesh, axis=self.axis, m=self.m, n=self.n,
            row_bounds=self.row_bounds, m_shard_pad=self.m_shard_pad,
            plans=plans, devices=self.devices,
            nnz=sum(p.nnz for p in plans),
            padded_nnz=sum(p.padded_nnz for p in plans))

    @property
    def stats(self) -> dict:
        d = {
            "n_shards": len(self.row_bounds),
            "coverage": round(self.coverage, 4),
            "dense_bytes": sum(int(np.prod(p.A.shape)) * 4
                               for p in self.plans),
            "S_max": max(int(p.A.shape[0]) for p in self.plans),
            "n_res": sum(p.ell.nnz for p in self.plans),
            "impl": self.impl,
        }
        if self.res_shard_nnz:
            avg = max(sum(self.res_shard_nnz) / len(self.res_shard_nnz), 1)
            d["res_imbalance"] = round(max(self.res_shard_nnz) / avg - 1, 3)
        if self.shard_sel:
            d["min_count_eff"] = max(s[1] for s in self.shard_sel)
        return d

    def for_training(self) -> "ShardedWindowedPlan":
        """The plan a train step differentiates through
        (:func:`.models.common.training_plan`): a copy whose shards'
        residues carry their transposed-pattern backward plans
        (:meth:`.window_spmm.WindowedPlan.for_training`), so g_B runs
        kernel 3 and kernel 7 on every shard's device.  Valid when A's
        values are constants (a graph adjacency)."""
        return dataclasses.replace(self, plans=tuple(
            p.for_training() for p in self.plans))


def prepare_windowed_sharded(
    g: CSRGraph,
    mesh: Mesh,
    axis: str | None = None,
    tm: int = 256,
    W: int = 128,
    J: int = 1024,
    min_count: int = 128,
    min_coverage: float = 0.15,
    max_dense_bytes: int = 6 << 30,
    impl: str = "pallas",
    interpret: bool | None = None,
    dev: DeviceCSR | None = None,
) -> ShardedWindowedPlan:
    """Shard rows by nnz; per shard run the window selection on its rows
    and the format build on its own device; the residues stay on their
    shards under the same row bounds.  ``max_dense_bytes`` is a PER-SHARD
    budget (each shard's selection is budgeted like one device's plan).
    Refuses (ValueError) only when the total coverage falls below
    ``min_coverage``.  The selection is a host pass over the shard's
    columns, so ``g`` needs its host ``col``; the nnz-sized device data
    comes from the resident ``dev`` (or ``g`` moved to the mesh's first
    device).  ``interpret`` is accepted and ignored."""
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown impl {impl!r}")
    axis = axis or mesh.axis_names[0]
    D = mesh.shape[axis]
    bounds = _split_rows_by_nnz(g, D)
    devices_of_shard, _ = mesh_shard_devices(mesh, axis, D)
    homes = tuple(devices_of_shard[d][0] for d in range(D))
    if dev is None:
        dev = DeviceCSR.from_graph(g, homes[0])

    full_unique = pattern_is_unique(g)
    sels, subs = [], []
    for r0, r1 in bounds:
        s0, s1 = int(g.row_ptr[r0]), int(g.row_ptr[r1])
        # the shard's rows as the host selection reads them (views)
        sub = SimpleNamespace(m=r1 - r0, n=g.n, nnz=s1 - s0,
                              row_ptr=g.row_ptr[r0:r1 + 1] - g.row_ptr[r0],
                              col=g.col[s0:s1])
        sel = window_select(sub, tm=tm, W=W, J=J, min_count=min_count,
                            max_dense_bytes=min(max_dense_bytes,
                                                (2**31 - 2) * 4))
        # row slices of a duplicate-free graph are duplicate-free
        sel["unique_rc"] = full_unique
        sels.append(sel)
        subs.append(sub)
    covered = sum(round(s["coverage"] * sub.nnz) for s, sub in zip(sels,
                                                                    subs))
    coverage = covered / max(g.nnz, 1)
    if coverage < min_coverage:
        raise ValueError(
            f"sharded window coverage {coverage:.3f} < {min_coverage} — "
            f"use prepare_ell_sharded (or apply rbdeg first)")

    # the residues' common bucket allocation, known before any build
    allocs = common_bucket_alloc([s["res_deg"] for s in sels])
    plans = []
    for (r0, r1), sel, sub, home in zip(bounds, sels, subs, homes):
        ds = shard_csr(g, dev, r0, r1, home)
        tabs = _device_tables(sel, home)
        res = residue_layout(sel, home, SHARDED_WIDTHS, allocs or None)
        layout = (ds.nnz, ds.m, tm, W, sel["nblk"], sel["total_steps"],
                  sel["G"], bool(sel["unique_rc"]), False)
        A, buckets, chunk_row, rows = _build_windowed_ell(
            ds.row_ptr, ds.col, ds.vals, tabs["slot"], tabs["pstep0"], res,
            layout=layout)
        ell = EllPlan(m=ds.m, buckets=buckets, chunk_row=chunk_row,
                      padded_nnz=res["padded"], nnz=int(sel["n_res"]),
                      rows=rows)
        plans.append(plan_from_selection(sel, tabs, A, ell, m=ds.m, n=g.n,
                                         nnz=ds.nnz, tm=tm, W=W, impl=impl))
    return ShardedWindowedPlan(
        mesh=mesh, axis=axis, m=g.m, n=g.n, tm=tm, W=W, row_bounds=bounds,
        m_shard_pad=max(-(-(r1 - r0) // tm) for r0, r1 in bounds) * tm,
        plans=tuple(plans), devices=homes, coverage=coverage, impl=impl,
        res_shard_nnz=tuple(int(s["n_res"]) for s in sels),
        shard_sel=tuple(
            (int(s["dense_bytes"]), int(s["min_count_eff"]),
             round(float(s["coverage"]), 4)) for s in sels))
