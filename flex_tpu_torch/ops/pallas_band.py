"""Band SpMM: the dense column-window path for bandwidth-limited matrices.

Counterpart of ``flex_tpu.ops.pallas_band`` (the file keeps its name so
the two are found side by side; nothing here is Pallas).  After a
bandwidth-reducing ordering, matrices from meshes and PDEs have all the
nonzeros of a row panel inside a narrow column window, so the panel's
product reads *contiguous* rows of B: no gather at all.

Three implementations, under the JAX package's names:

- ``impl="pallas2"`` (default): the panel's 128-aligned window [s, s+W)
  lies inside [W·i, W·i + 2W) for i = s // W, so the band is split at
  format time into a left half (columns in [W·i, W·(i+1))) and a right
  half, and a panel is two dense products against two W-aligned row ranges
  of B.  :func:`band_spmm_v2`, hand-written kernel ``csrc/band_spmm.cu``;
  the plan also keeps each 128-row tile's depth range of the two halves
  (:func:`band_depth_ranges`), and the kernel reads that range alone.
- ``impl="xla"``: contiguous-window gather + one batched product, plain
  torch ops (:func:`_band_spmm_xla`).
- ``impl="pallas"``: the unsplit band, one product per 128-column chunk of
  the window.  :func:`band_spmm_v1`, the same source's second entry on the
  same ranged kernel body (the chunks meet contiguous rows of B, so the
  band is one product of depth W); its plan keeps depth ranges too.

Band arrays are built on the device by one accumulating scatter from the
resident CSR.  Only viable when the window is narrow: density =
nnz / (m·W) must clear ``min_density`` or :func:`prepare_band` refuses.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flex_tpu_torch.ops.operands import (
    check_interpret, check_kernel_operands, check_operands,
)
from flex_tpu_torch.sparse.csr import CSRGraph
from flex_tpu_torch.sparse.device import (
    DeviceCSR, resident_csr, round_up, rows_from_row_ptr,
)

IMPLS = ("pallas2", "xla", "pallas")


# ---------------------------------------------------------------------------
# device builds
# ---------------------------------------------------------------------------

def _build_band(row_ptr, col, vals, ws, *, layout):
    """Dense band [P, TM, W] (impl "xla" and "pallas"); ``ws`` i64 [P] is
    each panel's window start.  The scatter accumulates, so duplicate
    (row, col) entries sum as in every other path."""
    nnz, m, P, TM, W = layout
    rows = rows_from_row_ptr(row_ptr, nnz, m)
    p = rows // TM
    flat = p * (TM * W) + (rows % TM) * W + (col.long() - ws[p])
    band = torch.zeros(P * TM * W, dtype=torch.float32, device=col.device)
    return band.index_add_(0, flat, vals).view(P, TM, W)


def _build_split_band(row_ptr, col, vals, iW, *, layout):
    """A_left, A_right [P, TM, W] (impl "pallas2"); ``iW`` i64 [P].  A
    nonzero at column c of panel p goes left at c − W·iW[p] when that is
    below W, else right at c − W·(iW[p]+1).  Accumulating, as above."""
    nnz, m, P, TM, W = layout
    rows = rows_from_row_ptr(row_ptr, nnz, m)
    p = rows // TM
    c_loc = col.long() - iW[p] * W
    is_left = c_loc < W
    pos = p * (TM * W) + (rows % TM) * W + torch.where(is_left, c_loc,
                                                       c_loc - W)
    halves = []
    for side in (is_left, ~is_left):
        half = torch.zeros(P * TM * W, dtype=torch.float32, device=col.device)
        halves.append(half.index_add_(0, pos[side], vals[side]).view(P, TM, W))
    return tuple(halves)


# ---------------------------------------------------------------------------
# products: plain versions and kernel wrappers
# ---------------------------------------------------------------------------

def _pad_rows(B, n_pad: int):
    """B followed by zero rows up to ``n_pad`` (plain versions only: the
    kernels mask instead)."""
    Bp = B.new_zeros((n_pad, B.shape[1]))
    Bp[:B.shape[0]] = B
    return Bp


def _window_product(tiles, starts, Bp):
    """Σ_w tiles[p][:, w] · Bp[starts[p] + w]: a contiguous-window gather,
    then one batched product.  Returns f32 [P·TM, k]."""
    P, TM, W = tiles.shape
    idx = starts[:, None] + torch.arange(W, device=Bp.device)
    return torch.bmm(tiles, Bp[idx]).view(P * TM, Bp.shape[1])


def _band_spmm_xla(band, ws128, B, *, m: int):
    """Window-band SpMM in plain torch ops (``ws128`` in units of 128)."""
    Bp = _pad_rows(B, round_up(B.shape[0], 128) + band.shape[2])
    return _window_product(band, ws128.long() * 128, Bp)[:m]


def band_spmm_v1_plain(band, ws128, B):
    """Plain PyTorch version of :func:`band_spmm_v1`: f32 [P·TM, k]."""
    return _band_spmm_xla(band, ws128, B, m=band.shape[0] * band.shape[1])


def band_spmm_v2_plain(a_left, a_right, iW, B):
    """Plain PyTorch version of :func:`band_spmm_v2`: the two halves'
    batched products against B[iW·W : +W] and B[(iW+1)·W : +W], B read as
    zero beyond its rows.  Returns f32 [P·TM, k]."""
    W = a_left.shape[2]
    Bp = _pad_rows(B, (-(-B.shape[0] // W) + 2) * W)
    start = iW.long() * W
    return _window_product(a_left, start, Bp) \
        + _window_product(a_right, start + W, Bp)


BAND_TILE_ROWS = 128  # output rows of one block of the band kernels
RANGE_STEP = 16       # depth of one stage of the ranged split-band kernel


def band_depth_ranges(*bands, bm: int = BAND_TILE_ROWS):
    """int32 [P, ⌈TM/bm⌉, 2]: for each (panel, bm-row tile) the first and
    one-past-last column of the concatenated depth ``[bands[0] | bands[1]
    | ...]`` (the split band's [A_left | A_right], length 2W, or the
    unsplit band alone, length W) that holds a nonzero, rounded out to
    multiples of ``RANGE_STEP`` and clipped to the depth; an all-zero tile
    gets lo == hi == 0.  The ranged kernel reads only these columns, and B
    only at the rows they meet.  Built on the band's device from the dense
    arrays alone, so a plan converted from the JAX plan's arrays gets the
    same table as the port's own build."""
    P, TM, W = bands[0].shape
    D = len(bands) * W
    n_tiles = max(-(-TM // bm), 1)
    nz = torch.zeros((P, n_tiles, D), dtype=torch.bool,
                     device=bands[0].device)
    for t in range(n_tiles):
        rows = slice(t * bm, (t + 1) * bm)
        for h, band in enumerate(bands):
            nz[:, t, h * W:(h + 1) * W] = band[:, rows].ne(0).any(dim=1)
    col = torch.arange(D, device=bands[0].device)
    lo = torch.where(nz, col, D).amin(dim=2, keepdim=True)
    hi = torch.where(nz, col + 1, 0).amax(dim=2, keepdim=True)
    lo = lo // RANGE_STEP * RANGE_STEP
    hi = torch.clamp(-(-hi // RANGE_STEP) * RANGE_STEP, max=D)
    empty = hi == 0
    return torch.cat([lo.masked_fill(empty, 0), hi], dim=2).to(torch.int32)


def _check_ranges(ranges, P: int, TM: int, B) -> None:
    if ranges is not None:
        check_operands({"ranges": (ranges, (
            P, max(-(-TM // BAND_TILE_ROWS), 1), 2))}, {"B": B})


def _check_band_operands(tiles: dict, ws, B):
    """Shapes, dtypes and devices for both wrappers; returns (P, TM, W)."""
    shapes = {tuple(t.shape) for t in tiles.values()}
    first = next(iter(tiles.values()))
    if first.dim() != 3 or len(shapes) != 1 or B.dim() != 2:
        raise ValueError(f"band arrays must be [P, TM, W] and B 2-D, got "
                         f"{sorted(shapes)}, {tuple(B.shape)}")
    check_operands({"the window table": (ws, first.shape[0])},
                   dict(tiles, B=B))
    return first.shape


def _check_band_kernel_operands(W: int, B, **tiles):
    """What the CUDA kernels add: they take any TM ≥ 1 (rows are masked)
    and any W that is a multiple of 128 (the unit of the v1 window table
    and of the aligned float4 loads)."""
    if W % 128:
        raise ValueError(f"the band kernels need W % 128 == 0, got W={W}")
    check_kernel_operands(tuple(tiles), B=B, **tiles)


def band_spmm_v2(a_left, a_right, iW, B, ranges=None):
    """Split-band product: out[p·TM : +TM] = A_left[p] · B[iW[p]·W : +W] +
    A_right[p] · B[(iW[p]+1)·W : +W], rows of B ≥ n read as zero.
    ``a_left``, ``a_right`` f32 [P, TM, W], ``iW`` i32 [P], ``B`` f32
    [n, k].  Returns f32 [P·TM, k].  ``ranges`` is the halves'
    :func:`band_depth_ranges`; without it the CUDA path derives it.

    CUDA tensors launch ``csrc/band_spmm.cu`` (and count the launch in
    ``band_spmm_v2.launches``): a block reads its 128-row tile's depth
    range alone, so B's values outside it never reach the output (a
    non-finite one there would through the dense product).  CPU tensors
    take :func:`band_spmm_v2_plain`.  Anything else raises."""
    P, TM, W = _check_band_operands({"a_left": a_left, "a_right": a_right},
                                    iW, B)
    _check_ranges(ranges, P, TM, B)
    if B.device.type == "cpu":
        return band_spmm_v2_plain(a_left, a_right, iW, B)
    if B.device.type != "cuda":
        raise ValueError(f"no band kernel for device {B.device}")
    _check_band_kernel_operands(W, B, a_left=a_left, a_right=a_right)
    if ranges is None:
        ranges = band_depth_ranges(a_left, a_right)
    check_kernel_operands((), ranges=ranges)
    from flex_tpu_torch import kernels

    n, k = B.shape
    out = torch.empty((P * TM, k), dtype=torch.float32, device=B.device)
    kernels.launch("band_spmm", "flex_band_spmm_v2", B.device,
                   a_left.data_ptr(), a_right.data_ptr(), iW.data_ptr(),
                   ranges.data_ptr(), B.data_ptr(), out.data_ptr(), P, TM, W,
                   n, k)
    band_spmm_v2.launches += 1
    return out


band_spmm_v2.launches = 0


def band_spmm_v1(band, ws128, B, ranges=None):
    """Unsplit-band product: out[p·TM : +TM] = Σ_j band[p][:, 128j : +128] ·
    B[(ws128[p]+j)·128 : +128], rows of B ≥ n read as zero.  ``band`` f32
    [P, TM, W], ``ws128`` i32 [P] in units of 128, ``B`` f32 [n, k].
    Returns f32 [P·TM, k].  ``ranges`` is the band's
    :func:`band_depth_ranges`; without it the CUDA path derives it.

    CUDA tensors launch ``csrc/band_spmm.cu`` (and count the launch in
    ``band_spmm_v1.launches``): the chunks meet the contiguous rows
    B[ws128·128 : +W], so a block reads its 128-row tile's depth range of
    that one product alone, as :func:`band_spmm_v2` does.  CPU tensors take
    :func:`band_spmm_v1_plain`.  Anything else raises."""
    P, TM, W = _check_band_operands({"band": band}, ws128, B)
    _check_ranges(ranges, P, TM, B)
    if B.device.type == "cpu":
        return band_spmm_v1_plain(band, ws128, B)
    if B.device.type != "cuda":
        raise ValueError(f"no band kernel for device {B.device}")
    _check_band_kernel_operands(W, B, band=band)
    if ranges is None:
        ranges = band_depth_ranges(band)
    check_kernel_operands((), ranges=ranges)
    from flex_tpu_torch import kernels

    n, k = B.shape
    out = torch.empty((P * TM, k), dtype=torch.float32, device=B.device)
    kernels.launch("band_spmm", "flex_band_spmm_v1", B.device,
                   band.data_ptr(), ws128.data_ptr(), ranges.data_ptr(),
                   B.data_ptr(), out.data_ptr(), P, TM, W, n, k)
    band_spmm_v1.launches += 1
    return out


band_spmm_v1.launches = 0


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BandPlan:
    m: int
    n: int
    tm: int
    w_pad: int           # window width (multiple of 128)
    band: object         # impl xla/pallas: f32 [P, TM, W]; pallas2: (L, R)
    ws: torch.Tensor     # impl xla/pallas: ws128 i32 [P]; pallas2: iW i32 [P]
    impl: str = "pallas2"
    # impl pallas2: band_depth_ranges of (L, R), pallas: of the band; i32
    # [P, ⌈TM/128⌉, 2]
    ranges: torch.Tensor | None = None

    def __call__(self, B: torch.Tensor) -> torch.Tensor:
        if B.dim() != 2 or B.shape[0] != self.n:
            raise ValueError(f"B must be ({self.n}, k), got {tuple(B.shape)}")
        if self.impl == "xla":
            return _band_spmm_xla(self.band, self.ws, B, m=self.m)
        if self.impl == "pallas2":
            return band_spmm_v2(*self.band, self.ws, B,
                                ranges=self.ranges)[:self.m]
        return band_spmm_v1(self.band, self.ws, B,
                            ranges=self.ranges)[:self.m]

    @property
    def stats(self) -> dict:
        split = isinstance(self.band, tuple)
        shape = tuple((self.band[0] if split else self.band).shape)
        return {
            "n_panels": shape[0],
            "w_pad": self.w_pad,
            "band_bytes": (2 if split else 1) * int(np.prod(shape)) * 4,
            "impl": self.impl,
        }

    def traffic_model(self, k: int) -> dict:
        """Byte model: the dense band read once; per panel its window of B
        (two W-row ranges for the split band, one otherwise; an upper
        bound, neighbouring panels share rows); C written once."""
        st = self.stats
        n_b_blocks = 2 if self.impl == "pallas2" else 1
        by = (st["band_bytes"]
              + st["n_panels"] * n_b_blocks * self.w_pad * k * 4
              + self.m * k * 4)
        return {"bytes": int(by)}


def panel_window_stats(g: CSRGraph, tm: int):
    """Per-panel column-window model (host): returns (ws int64[P] aligned
    window starts, w_pad, density, band_bytes).  O(P) memory via reduceat
    over the contiguous CSR panel segments."""
    m = g.m
    P = max(-(-m // tm), 1)
    seg_starts = g.row_ptr[np.minimum(np.arange(P) * tm, m)].astype(np.int64)
    nnz_per = np.diff(np.append(seg_starts, g.nnz))
    # reduceat only over non-empty panels: their seg_starts are strictly
    # increasing and < nnz, so each segment ends exactly at the next
    # non-empty panel's start.  Clamping every start to nnz-1 instead would
    # drop the last nonzero from the final non-empty panel's window when
    # trailing panels are empty, and the band scatter would then land in
    # another row.
    lo = np.zeros(P, np.int64)
    hi = np.zeros(P, np.int64)
    nonempty = nnz_per > 0
    if g.nnz:
        lo[nonempty] = np.minimum.reduceat(g.col, seg_starts[nonempty])
        hi[nonempty] = np.maximum.reduceat(g.col, seg_starts[nonempty])
    ws = (lo // 128) * 128
    w_pad = max(round_up(int((hi - ws).max()) + 1, 128), 128)
    band_bytes = P * tm * w_pad * 4
    density = g.nnz / max(P * tm * w_pad, 1)
    return ws, w_pad, density, band_bytes


def prepare_band(
    g: CSRGraph,
    dev: DeviceCSR | None = None,
    tm: int = 256,
    min_density: float = 0.02,
    max_band_bytes: int = 4 << 30,
    interpret: bool | None = None,
    impl: str = "pallas2",
    *,
    device=None,
) -> BandPlan:
    """Build the band plan on ``dev``'s device (or ``device``, a keyword
    after the JAX parameters; CUDA when neither is given).  Refuses (ValueError) when the matrix is not
    band-friendly.  ``interpret`` is accepted and ignored
    (:func:`.operands.check_interpret`)."""
    check_interpret(interpret)
    if impl not in IMPLS:
        raise ValueError(f"unknown band impl {impl!r}: one of {IMPLS}")
    dev = resident_csr(g, dev, device)
    device = dev.device
    P = max(-(-g.m // tm), 1)

    ws, w_pad, density, band_bytes = panel_window_stats(g, tm)
    if band_bytes > max_band_bytes or density < min_density:
        raise ValueError(
            f"matrix not band-friendly: window={w_pad} density={density:.4f} "
            f"band_bytes={band_bytes/1e9:.2f}GB — use 'ell' instead "
            f"(or apply RCM ordering first)"
        )

    layout = (g.nnz, g.m, P, tm, w_pad)
    ranges = None
    if impl == "pallas2":
        table = ws // w_pad
        band = _build_split_band(dev.row_ptr, dev.col, dev.vals,
                                 torch.from_numpy(table).to(device),
                                 layout=layout)
        ranges = band_depth_ranges(*band)
    else:
        table = ws // 128
        band = _build_band(dev.row_ptr, dev.col, dev.vals,
                           torch.from_numpy(ws).to(device), layout=layout)
        if impl == "pallas":
            ranges = band_depth_ranges(band)
    return BandPlan(
        m=g.m, n=g.n, tm=tm, w_pad=w_pad, band=band,
        ws=torch.from_numpy(table.astype(np.int32)).to(device), impl=impl,
        ranges=ranges)


def spmm_band(g: CSRGraph, B: torch.Tensor, **kwargs) -> torch.Tensor:
    return prepare_band(g, **kwargs)(B)
