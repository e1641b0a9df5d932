"""g_vals of the dynamic-value SpMM (``ops/dyn_ell.edge_dots_rows``) on
the CPU: the lane layout the edge-dot kernel takes from k, a NumPy
emulation of the kernel's schedule (lane groups, passes of G·W columns,
stages and the butterfly reduce-scatter) against float64 dot products,
the plain version's results and its ``plain_calls`` count, and what the
wrapper refuses.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``)."""
import dataclasses

import numpy as np
import pytest
import torch

from flex_tpu_torch.ops.dyn_ell import (
    edge_dots_layout, edge_dots_plain, edge_dots_rows, prepare_dyn_ell,
)
from flex_tpu_torch.ops.gespmm import ROW_UNIT_ENTRIES, rows_layout
from flex_tpu_torch.sparse.csr import CSRGraph

EPS32 = float(np.finfo(np.float32).eps)
WIDTHS = [1, 7, 16, 41, 64, 65, 128, 256, 257]


def _graph(m=300):
    """Random rows, an empty row and two rows split into several units."""
    rng = np.random.default_rng(7)
    deg = rng.integers(0, 40, m)
    deg[:3] = (0, 2 * ROW_UNIT_ENTRIES + 88, ROW_UNIT_ENTRIES + 1)
    rows = np.repeat(np.arange(m), deg)
    cols = rng.integers(0, m, len(rows))
    return CSRGraph.from_coo(rows, cols, np.ones(len(rows), np.float32), m,
                             name="split_and_empty")


@pytest.fixture(scope="module")
def case():
    g = _graph()
    return g, prepare_dyn_ell(g, device="cpu")


def _operands(g, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((g.m, k)).astype(np.float32),
            rng.standard_normal((g.n, k)).astype(np.float32))


def _dots64(g, gm, B):
    rows = np.repeat(np.arange(g.m), g.degrees)
    return (gm.astype(np.float64)[rows] * B.astype(np.float64)[g.col]).sum(1)


def _bound(g, gm, B, k):
    """The f32 rounding bound of a k-term dot product in any order."""
    rows = np.repeat(np.arange(g.m), g.degrees)
    return 2 * max(k, 1) * EPS32 * (np.abs(gm)[rows]
                                    * np.abs(B)[g.col]).sum(1) + 1e-30


def emulate_edge_dots(t, gm, B):
    """``csrc/edge_dots.cu``'s schedule in NumPy f32: for each unit, G
    lanes (``edge_dots_layout``) hold their columns of g[row] for each pass
    of G·W columns; each stage of S = max(G, 8) edges gives every lane S
    partial dots (an f32 multiply-add chain over its columns), which the
    butterfly reduce-scatter sums so that lane gl holds edge q·G + gl of
    the stage; later passes add to the earlier ones' outputs."""
    k = gm.shape[1]
    G, W = edge_dots_layout(k)
    S = max(G, 8)
    R = S // G
    lane = np.arange(G)
    if k % 4 == 0:
        lane_cols = (4 * (lane[:, None] + G * np.arange(W // 4)[None, :]))
        lane_cols = (lane_cols[:, :, None] + np.arange(4)).reshape(G, W)
    else:
        lane_cols = lane[:, None] + G * np.arange(W)[None, :]
    cols = t.cols.numpy()
    start = t.row_start.numpy().astype(np.int64)
    out = np.full(cols.shape[0], np.nan, np.float32)
    for row, lo, hi, _ in t.units.numpy():
        base, length = start[row] + lo, hi - lo
        for c0 in range(0, k, G * W):
            cc = c0 + lane_cols
            live = cc < k
            cc = np.where(live, cc, 0)
            gv = np.where(live, gm[row][cc], 0).astype(np.float32)
            for j0 in range(0, length, S):
                p = np.zeros((G, S), np.float32)
                for jj in range(min(S, length - j0)):
                    b = np.where(live, B[cols[base + j0 + jj]][cc], 0)
                    d = np.zeros(G, np.float32)
                    for w in range(W):
                        d = (gv[:, w].astype(np.float64) * b[:, w]
                             + d).astype(np.float32)
                    p[:, jj] = d
                s = G // 2
                while s >= 1:
                    up = (lane & s) != 0
                    new = p.copy()
                    for q in range(R):
                        for i in range(s):
                            lo_, hi_ = p[:, q * G + i], p[:, q * G + i + s]
                            send = np.where(up, lo_, hi_)
                            new[:, q * G + i] = (np.where(up, hi_, lo_)
                                                 + send[lane ^ s])
                    p = new
                    s //= 2
                for q in range(R):
                    j = j0 + q * G + lane
                    ok = j < length
                    e = base + j[ok]
                    out[e] = p[ok, q * G] if c0 == 0 else out[e] + p[ok, q * G]
    return out


@pytest.mark.parametrize("k, want", [
    (0, (1, 4)), (1, (1, 4)), (4, (1, 4)), (5, (2, 4)), (7, (2, 4)),
    (16, (4, 4)), (17, (8, 4)), (41, (16, 4)), (64, (16, 4)), (65, (32, 4)),
    (128, (32, 4)), (129, (32, 8)), (256, (32, 8)), (257, (32, 8))])
def test_lane_layout_follows_k(k, want):
    """Kernel 7's lanes (a warp a unit above k = 64, else 4·G ≥ k), four
    columns a lane, eight at a whole warp above k = 128: every k up to 256
    is one pass of G·W columns."""
    lanes, width = edge_dots_layout(k)
    assert (lanes, width) == want
    assert lanes == rows_layout(k)[0]
    assert (lanes * width >= k) == (k <= 256)


@pytest.mark.parametrize("k", WIDTHS)
def test_emulated_schedule_gives_every_edge_its_dot(case, k):
    """The butterfly leaves each edge's whole sum with the lane that
    stores it: on split rows and an empty row, at k with one pass and two
    (k = 257), float4 columns and scalar ones, every edge of the CSR gets
    its dot product within the f32 order bound."""
    g, plan = case
    gm, B = _operands(g, k, seed=k)
    out = emulate_edge_dots(plan.fwd, gm, B)
    assert not np.isnan(out).any()
    assert np.all(np.abs(out - _dots64(g, gm, B)) <= _bound(g, gm, B, k))


@pytest.mark.parametrize("k", [8, 41, 256])
def test_plain_path_on_cpu_tensors_counts_plain_calls(case, k):
    """CPU tensors take ``edge_dots_plain`` (zero-column pad at k % 4 ==
    0, sub-batches of edges): the dot products within the f32 order bound,
    one plain call each, no launch; the plan's ``edge_dots`` is the same
    call on its forward tables."""
    g, plan = case
    gm, B = _operands(g, k, seed=100 + k)
    gt, Bt = torch.from_numpy(gm), torch.from_numpy(B)
    before = (edge_dots_rows.launches, edge_dots_rows.grouped_launches,
              edge_dots_rows.plain_calls)
    out = edge_dots_rows(plan.fwd, plan.rows, gt, Bt, max_gather_rows=1000)
    assert (edge_dots_rows.launches, edge_dots_rows.grouped_launches,
            edge_dots_rows.plain_calls) == (before[0], before[1],
                                            before[2] + 1)
    assert out.dtype == torch.float32 and tuple(out.shape) == (g.nnz,)
    assert np.all(np.abs(out.numpy() - _dots64(g, gm, B))
                  <= _bound(g, gm, B, k + 1))
    assert torch.equal(out, edge_dots_plain(plan.rows, plan.cols, gt, Bt,
                                            1000))
    assert torch.equal(plan.edge_dots(gt, Bt), edge_dots_plain(
        plan.rows, plan.cols, gt, Bt, plan.max_gather_rows))
    assert edge_dots_rows.plain_calls == before[2] + 2


def test_refuses_wrong_shapes_types_and_devices(case):
    g, plan = case
    t, k = plan.fwd, 8
    gt, Bt = torch.ones((g.m, k)), torch.ones((g.n, k))
    with pytest.raises(ValueError, match="rows"):
        edge_dots_rows(t, plan.rows, torch.ones((g.m + 1, k)), Bt)
    with pytest.raises(ValueError, match="one width"):
        edge_dots_rows(t, plan.rows, gt, torch.ones((g.n, k + 1)))
    with pytest.raises(ValueError, match="2-D"):
        edge_dots_rows(t, plan.rows, torch.ones(g.m), Bt)
    with pytest.raises(ValueError, match="rows must have shape"):
        edge_dots_rows(t, plan.rows[1:], gt, Bt)
    with pytest.raises(ValueError, match="float32"):
        edge_dots_rows(t, plan.rows, gt.double(), Bt)
    with pytest.raises(ValueError, match="int32"):   # when the table is made
        dataclasses.replace(t, cols=t.cols.long())
    with pytest.raises(ValueError, match="several devices"):
        edge_dots_rows(t, plan.rows, gt, Bt.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        dataclasses.replace(t, cols=t.cols.to("meta"))
    meta = dataclasses.replace(t, **{f: getattr(t, f).to("meta") for f in (
        "cols", "vals", "row_start", "units", "splits")})
    with pytest.raises(ValueError, match="no edge-dot kernel"):
        edge_dots_rows(meta, plan.rows, gt.to("meta"), Bt.to("meta"))
    with pytest.raises(ValueError, match="B must be"):
        plan.edge_dots(gt, torch.ones((g.n + 1, k)))
