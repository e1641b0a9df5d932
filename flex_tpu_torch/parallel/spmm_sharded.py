"""Row-sharded ELL SpMM across a mesh of torch devices.

Counterpart of ``flex_tpu.parallel.spmm_sharded``.  A is cut into
contiguous row shards balanced by nnz; each shard's device holds its rows
as a width-bucketed :class:`.ell_spmm.EllPlan` and computes its C rows
there (on the card: kernel 7, ``csrc/gespmm.cu``).  Row ownership is
exclusive, so no reduction runs between devices.  Every shard's buckets
share one allocation (``bucket_alloc``, the maximum over the shards), as
the JAX package's ``shard_map`` requires of its uniform shapes.

Two B layouts (``b_layout``):

- ``"replicated"`` (default): B is copied to every shard's device; no
  traffic between devices beyond that copy.
- ``"gathered"``: B arrives as column shards, shard d on device d (the
  layout of a column-sharded producer, H = X·W with W column-sharded), and
  every shard's device concatenates the copies of all of them: the
  counterpart of ``all_gather(tiled=True)``.  It moves n·k·4·(D-1)/D bytes
  a call (:meth:`ShardedEllPlan.ici_bytes_per_call`).

One process drives every shard (:mod:`.mesh`); the result is C (m, k) on
the mesh's first device.  The call is differentiable: each shard's plan
is its own autograd function, and autograd sums g_B over the copies of B.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flex_tpu_torch.ops.ell_spmm import (
    EllPlan, host_bucket_sizes, prepare_ell_device, with_bwd_plan,
)
from flex_tpu_torch.parallel.mesh import Mesh
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.sparse.device import DeviceCSR

# Coarser ladder than one device's: every bucket exists on every shard
# (shapes are the maximum over the shards), so many buckets inflate the
# padding between shards.
SHARDED_WIDTHS = (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)


def _split_rows_by_nnz(g, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous row ranges with ~equal nnz (static load balance)."""
    targets = np.linspace(0, g.nnz, n_shards + 1)[1:-1]
    cuts = np.searchsorted(g.row_ptr, targets, side="left")
    bounds = np.concatenate([[0], cuts, [g.m]]).astype(np.int64)
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(n_shards)]


def mesh_shard_devices(mesh: Mesh, axis: str, D: int | None = None):
    """(devices_of_shard, shard_of_position) for rows sharded over
    ``axis``: shard s -> the mesh's devices at index s along ``axis`` (the
    other axes replicate it), and mesh position -> its shard.  A shard's
    home is the first of its devices."""
    ax = mesh.axis_names.index(axis)
    if D is not None and D != mesh.devices.shape[ax]:
        raise ValueError(f"{D} shards on an axis of size "
                         f"{mesh.devices.shape[ax]}")
    devices_of_shard: dict[int, list] = {}
    shard_of_position: dict[tuple, int] = {}
    for pos, dvc in np.ndenumerate(mesh.devices):
        devices_of_shard.setdefault(pos[ax], []).append(dvc)
        shard_of_position[pos] = pos[ax]
    return devices_of_shard, shard_of_position


def common_bucket_alloc(degrees, widths=SHARDED_WIDTHS) -> dict:
    """width -> the most chunks any shard has in that bucket, from each
    shard's row degrees: the ``bucket_alloc`` of every shard's plan."""
    allocs: dict[int, int] = {}
    for deg in degrees:
        by_w, _, _ = host_bucket_sizes(np.asarray(deg, dtype=np.int64),
                                       widths)
        for w, nc in by_w.items():
            allocs[w] = max(allocs.get(w, 0), nc)
    return allocs


def shard_csr(g, dev: DeviceCSR, r0: int, r1: int, home) -> DeviceCSR:
    """Rows r0..r1 of the resident CSR, moved device-to-device to
    ``home`` (row_ptr rebased to 0)."""
    s0, s1 = int(g.row_ptr[r0]), int(g.row_ptr[r1])
    return DeviceCSR(
        row_ptr=(dev.row_ptr[r0:r1 + 1] - dev.row_ptr[r0]).to(home),
        col=dev.col[s0:s1].to(home), vals=dev.vals[s0:s1].to(home),
        m=r1 - r0, n=dev.n, nnz=s1 - s0)


@dataclasses.dataclass
class ShardedEllPlan:
    mesh: Mesh
    axis: str
    m: int
    n: int                              # B's row count
    row_bounds: list[tuple[int, int]]
    m_shard_pad: int                    # the most rows of one shard
    plans: tuple[EllPlan, ...]          # shard d's rows, on devices[d]
    devices: tuple[torch.device, ...]   # each shard's home
    nnz: int
    padded_nnz: int
    b_layout: str = "replicated"

    def shard_inputs(self, B) -> list[torch.Tensor]:
        """B as each shard's device holds it for its product: a copy of B
        (replicated), or the concatenation of the copies of every column
        shard (gathered).  Under "gathered" ``B`` is the list of column
        shards, or one tensor that is cut into them here, shard d placed
        on devices[d]."""
        if self.b_layout == "replicated":
            return [B.to(d) for d in self.devices]
        D = len(self.devices)
        if torch.is_tensor(B):
            B = [c.to(d) for c, d in zip(torch.tensor_split(B, D, dim=1),
                                          self.devices)]
        if len(B) != D:
            raise ValueError(f"{len(B)} column shards for {D} shards")
        return [torch.cat([c.to(d) for c in B], dim=1) for d in self.devices]

    def shard_outputs(self, B) -> list[torch.Tensor]:
        """Shard d's C rows (r1 - r0, k), f32 on devices[d]: the result
        without the final copy to one device."""
        return [p(b) for p, b in zip(self.plans, self.shard_inputs(B))]

    def __call__(self, B) -> torch.Tensor:
        home = self.devices[0]
        return torch.cat([o.to(home) for o in self.shard_outputs(B)])

    @property
    def stats(self) -> dict:
        D = len(self.row_bounds)
        return {
            "n_shards": D,
            "padded_nnz": self.padded_nnz,
            "pad_ratio": self.padded_nnz / max(self.nnz, 1),
            "bucket_shapes": [(D, *c.shape) for c, _ in self.plans[0].buckets],
            "b_layout": self.b_layout,
        }

    def ici_bytes_per_call(self, n: int, k: int) -> int:
        """Bytes moved between devices by one call's B layout."""
        D = len(self.row_bounds)
        return 0 if self.b_layout == "replicated" \
            else n * k * 4 * (D - 1) // D

    def for_training(self) -> "ShardedEllPlan":
        """The plan a train step differentiates through
        (:func:`.models.common.training_plan`): a copy whose shards carry
        their transposed-pattern backward plans
        (:func:`.ell_spmm.with_bwd_plan`), so g_B runs on kernel 7 on each
        shard's device.  Valid when A's values are constants."""
        return dataclasses.replace(self, plans=tuple(
            p if p.bwd_plan is not None or not p.buckets
            else with_bwd_plan(p, self.n) for p in self.plans))


def prepare_ell_sharded(
    g: CSRGraph,
    mesh: Mesh,
    axis: str | None = None,
    widths: tuple[int, ...] = SHARDED_WIDTHS,
    b_layout: str = "replicated",
    dev: DeviceCSR | None = None,
) -> ShardedEllPlan:
    """Per-shard CSR slices are cut from the resident CSR (``dev``, or
    ``g`` moved to the mesh's first device) and moved device-to-device to
    each shard's home, where :func:`.ell_spmm.prepare_ell_device` builds
    its buckets with the common allocation; the host computes only O(m)
    metadata."""
    if b_layout not in ("replicated", "gathered"):
        raise ValueError(f"unknown b_layout {b_layout!r}")
    axis = axis or mesh.axis_names[0]
    D = mesh.shape[axis]
    bounds = _split_rows_by_nnz(g, D)
    devices_of_shard, _ = mesh_shard_devices(mesh, axis, D)
    homes = tuple(devices_of_shard[d][0] for d in range(D))
    if dev is None:
        dev = DeviceCSR.from_graph(g, homes[0])
    row_ptr_h = np.asarray(g.row_ptr, dtype=np.int64)
    allocs = common_bucket_alloc(
        [g.degrees[r0:r1] for r0, r1 in bounds], widths)
    plans = tuple(
        prepare_ell_device(
            s.row_ptr, s.col, s.vals, m=s.m, nnz=s.nnz,
            res_row_ptr_host=row_ptr_h[r0:r1 + 1] - row_ptr_h[r0],
            widths=tuple(widths), bucket_alloc=allocs or None)
        for (r0, r1), home in zip(bounds, homes)
        for s in (shard_csr(g, dev, r0, r1, home),))
    return ShardedEllPlan(
        mesh=mesh, axis=axis, m=g.m, n=g.n, row_bounds=bounds,
        m_shard_pad=max(r1 - r0 for r0, r1 in bounds), plans=plans,
        devices=homes, nnz=sum(p.nnz for p in plans),
        padded_nnz=sum(p.padded_nnz for p in plans), b_layout=b_layout)
