"""GE-SpMM-style row-parallel CSR SpMM: the independent second-opinion
baseline.

Counterpart of ``flex_tpu.ops.gespmm``.  Every row goes through one code
path: it is cut into chunks of at most ``w`` nonzeros, padded to ``w``; a
chunk's partial sum is Σ_j vals[c, j] · B[cols[c, j], :], and the
partials are scatter-added into their rows by ``chunk_row``.

- :func:`prepare_gespmm` computes the O(chunks) metadata on the host and
  builds the ``[N, w]`` arrays on the device from the resident CSR,
  with the ELL buckets' own gather (:func:`.ell_spmm.gather_chunks`).
- :func:`gespmm_partials` computes the partials: the hand-written CUDA
  kernel ``csrc/gespmm.cu`` for CUDA tensors (a warp per chunk, B rows
  read straight from global memory), :func:`gespmm_partials_plain` for CPU
  tensors.
- The scatter-add stays outside the kernel, as in the JAX package; on the
  card ``index_add_`` sums a split row's chunks in no fixed order, so two
  runs may differ by f32 rounding.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flex_tpu_torch.ops.ell_spmm import gather_chunks
from flex_tpu_torch.ops.operands import check_kernel_operands, check_operands
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.sparse.device import DeviceCSR, resident_csr

CH = 8  # the chunk count is padded to a multiple of CH, as in the JAX plan


def gespmm_partials_plain(cols, vals, B, max_gather_rows: int = 1 << 21):
    """Plain PyTorch version of the partials: gather the (N, w, k) rows of
    B, multiply by vals, sum over w; in sub-batches of about
    ``max_gather_rows`` gathered rows.  Returns f32 [N, k]."""
    N, w = cols.shape
    k = B.shape[1]
    step = max(1, max_gather_rows // max(w, 1))
    parts = [(vals[s:s + step, :, None]
              * B.index_select(0, cols[s:s + step].reshape(-1)).view(-1, w, k)
              ).sum(dim=1) for s in range(0, N, step)]
    return torch.cat(parts) if parts else B.new_zeros((0, k))


def gespmm_partials(cols, vals, B):
    """partial[c, :] = Σ_j vals[c, j] · B[cols[c, j], :] for every chunk c.
    ``cols`` i32 [N, w] (pads point at row 0), ``vals`` f32 [N, w] (pads
    are 0), ``B`` f32 [n, k].  Returns f32 [N, k].

    CUDA tensors launch ``csrc/gespmm.cu`` (and count the launch in
    ``gespmm_partials.launches``); CPU tensors take
    :func:`gespmm_partials_plain`.  Anything else raises."""
    if cols.dim() != 2 or vals.shape != cols.shape or B.dim() != 2:
        raise ValueError(f"cols and vals must be [N, w] and B 2-D, got "
                         f"{tuple(cols.shape)}, {tuple(vals.shape)}, "
                         f"{tuple(B.shape)}")
    check_operands({"cols": (cols, cols.shape)}, {"vals": vals, "B": B})
    if B.device.type == "cpu":
        return gespmm_partials_plain(cols, vals, B)
    if B.device.type != "cuda":
        raise ValueError(f"no gespmm kernel for device {B.device}")
    check_kernel_operands(cols=cols, vals=vals, B=B)
    if cols.numel() and B.shape[0] == 0:
        raise ValueError("B has no rows for cols to point at")
    from flex_tpu_torch import kernels

    N, w = cols.shape
    k = B.shape[1]
    partial = torch.empty((N, k), dtype=torch.float32, device=B.device)
    kernels.launch("gespmm", "flex_gespmm_partials", B.device,
                   cols.data_ptr(), vals.data_ptr(), B.data_ptr(),
                   partial.data_ptr(), N, w, k)
    gespmm_partials.launches += 1
    return partial


gespmm_partials.launches = 0


@dataclasses.dataclass
class GeSpmmPlan:
    m: int
    w: int
    cols: torch.Tensor       # i32 [N, w] (N a multiple of CH; pads -> row 0)
    vals: torch.Tensor       # f32 [N, w] (pads are 0)
    chunk_row: torch.Tensor  # i32 [N] (pad chunks point at dump row m)
    nnz: int
    padded_nnz: int

    def __call__(self, B: torch.Tensor) -> torch.Tensor:
        partial = gespmm_partials(self.cols, self.vals, B)
        out = B.new_zeros((self.m + 1, B.shape[1]))
        return out.index_add_(0, self.chunk_row, partial)[:self.m]

    @property
    def stats(self) -> dict:
        return {
            "n_chunks": int(self.cols.shape[0]),
            "w": self.w,
            "padded_nnz": self.padded_nnz,
            "pad_ratio": self.padded_nnz / max(self.nnz, 1),
        }

    def traffic_model(self, k: int) -> dict:
        """Byte model: one (1, k) row of B per padded slot, the partials
        written and read again, and the scattered C."""
        N = int(self.cols.shape[0])
        by = self.padded_nnz * (k * 4 + 8) + 2 * N * k * 4 + self.m * k * 4
        return {"bytes": int(by), "gathered_rows": self.padded_nnz}


def prepare_gespmm(g: CSRGraph, w: int = 32, dev: DeviceCSR | None = None,
                   device=None) -> GeSpmmPlan:
    """Single fixed chunk width; rows longer than ``w`` split into several
    chunks, the chunk count is padded to a multiple of CH.  The host ships
    only O(chunks) metadata; each chunk is a contiguous CSR run, gathered
    on the device."""
    if w < 1:
        raise ValueError(f"chunk width must be positive, got w={w}")
    dev = resident_csr(g, dev, device)
    deg = g.degrees.astype(np.int64)
    n_chunks = np.where(deg > 0, -(-deg // w), 0)
    rows_rep = np.repeat(np.arange(g.m, dtype=np.int64), n_chunks)
    total = len(rows_rep)
    cum0 = np.concatenate([[0], np.cumsum(n_chunks)[:-1]])
    local = np.arange(total, dtype=np.int64) - np.repeat(cum0, n_chunks)

    N = max(-(-total // CH) * CH, CH)
    starts = np.full(N, g.nnz, np.int32)  # pads slice the zero pad region
    lengths = np.zeros(N, np.int32)
    chunk_row = np.full(N, g.m, np.int32)  # pads -> dump row
    starts[:total] = g.row_ptr[rows_rep] + local * w
    lengths[:total] = np.minimum(deg[rows_rep] - local * w, w)
    chunk_row[:total] = rows_rep

    meta = torch.from_numpy(np.stack([starts, lengths, chunk_row])).to(
        dev.device)
    cols, vals = gather_chunks(
        torch.cat([dev.col, dev.col.new_zeros(w)]),
        torch.cat([dev.vals, dev.vals.new_zeros(w)]), meta[0], meta[1], w)
    return GeSpmmPlan(m=g.m, w=w, cols=cols, vals=vals, chunk_row=meta[2],
                      nnz=g.nnz, padded_nnz=N * w)


def spmm_gespmm(g: CSRGraph, B: torch.Tensor, **kwargs) -> torch.Tensor:
    return prepare_gespmm(g, **kwargs)(B)
