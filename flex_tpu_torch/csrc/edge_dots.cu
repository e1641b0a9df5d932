// Per-edge dot products for Hopper (sm_90a), plain C interface: g_vals of
// the dynamic-value SpMM's backward (ops/dyn_ell.py:edge_dots_rows),
//
//   out[e] = <g[row_e, :], B[cols[e], :]>   for every nonzero e,
//
// the gradient of C = A(vals) . B with respect to vals.  It replaces no
// TPU kernel: the JAX package gets g_vals from autodiff of XLA gathers
// (flex_tpu/ops/dyn_ell.py), and the port's plain version gathers g[row_e]
// and B[col_e] into two nnz x k temporaries in device memory, multiplies
// them and sums each row, so every byte of the product makes three trips
// through memory.  Here nothing is gathered into memory: each g row is read
// once into registers and each B row straight from global memory, coalesced
// along k, as kernel 7 (gespmm.cu) reads it.
//
// Work units are kernel 7's forward tables (ops/gespmm.py:RowTables):
// units[u] = (row, lo, hi, part), the nonzeros row_start[row] + lo .. + hi
// of one row, at most 256 of them.  Every edge's output is independent, so
// a split row's units need no second pass: each reloads g[row] and writes
// its own outputs; `part` is not read.  One launch a call, no scratch, no
// atomics.
//
// Lanes.  G lanes own a unit, chosen from k alone (ops/dyn_ell.py:
// edge_dots_layout): at k > 64 a whole warp (G = 32, kernel 7's
// rows_layout), each lane holding W = 4 columns at k <= 128 and 8 above, so
// that k = 256 is one pass; at k <= 64 the smallest power of two with
// 4 G >= k, so a warp runs 32 / G units (G = 16 at k = 41).  Lane gl of a
// group owns columns 4 (gl + G h) .. + 3, h < W / 4, by float4 loads when
// k % 4 == 0 and g and B are 16-byte aligned, else gl + G t, t < W, by
// scalar loads with masks, so the G lanes read consecutive floats either
// way.  Above G W columns (k > 256) the unit is walked again for each
// further pass of G W columns, each pass adding its sums to the outputs of
// the one before (same lane, same address, so in order).
//
// Work per unit.  The group loads its g row once into registers.  It walks
// the unit in stages of S = max(G, 8) edges: each lane stages R = S / G
// cols (the next stage's loaded before this stage's B rows) and shuffles
// them within the group (width G), as kernel 7's rows_group_kernel does; the
// warp walks its longest unit and every lane takes every shuffle, so an edge
// past its group's unit loads nothing and its sum is dropped.  For each edge
// a lane reads its columns of the B row and runs an fmaf chain against the
// registers: S partial dots a lane.  A butterfly reduce-scatter across the
// G lanes then sums them, G - 1 shuffles for every G edges in place of
// log2 G for each: at step s (G / 2, ..., 1) a lane keeps the upper half of
// its pending partials if its bit s is set, else the lower half, and adds
// its partner's (lane ^ s) copy of the half it keeps.  Lane gl ends up with
// the whole sum of edge q G + gl of the stage for each q < R, and the group
// stores its outputs in CSR order, G consecutive floats at a time.  The
// order of every sum is fixed by k, so two launches give the same bits;
// the sums are f32 fmaf and adds, no TF32 and no atomics.
//
// Bound: 2 operations per 4 bytes of B row read, far below the FP32 ridge,
// and what the data needs once is g and B read once, a row and a column
// index per edge and one f32 written (spmm_bench/arith_gat.py:
// edge_dots_bytes).  What the kernel moves is more: every edge reads a
// whole B row, from L2 when the ordering keeps a row's columns close, as
// kernel 7 does.  On an H100 80GB HBM3 at 700 W on reddit-gat's graph
// (23,446,803 edges, rbdeg) it took 2.97 ms at k = 256 and 0.75 ms at
// k = 41, beside kernel 7's 2.74 and 0.64 ms on the same tables and the
// plain gathers' 65.0 and 14.2 ms, against bounds of 0.23 and 0.11 ms.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;  // warps per block
constexpr unsigned FULL = 0xffffffffu;

// W floats of a row ([*, k]) at lane gl's columns of the pass from column
// c0, zero past k: W / 4 float4 loads (VEC: k % 4 == 0 and the row 16-byte
// aligned) or W scalar loads
template <int G, int W, bool VEC>
__device__ __forceinline__ void load_cols(const float* row, int c0, int gl,
                                          int k, float (&v)[W]) {
  if (VEC) {
#pragma unroll
    for (int h = 0; h < W / 4; ++h) {
      const int c = c0 + 4 * (gl + G * h);
      float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < k) b = *reinterpret_cast<const float4*>(row + c);
      v[4 * h] = b.x, v[4 * h + 1] = b.y, v[4 * h + 2] = b.z,
      v[4 * h + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < W; ++t) {
      const int c = c0 + gl + G * t;
      v[t] = c < k ? row[c] : 0.f;
    }
  }
}

// the butterfly's steps H = G / 2, ..., 1 over the group's S partials a
// lane: edge q G + i of the stage sits in p[q G + i]; after step H a lane
// holds, in p[q G + 0 .. H), the sums of the half its bit H picks.  Each
// step is its own instance, so every index into p is a constant and p stays
// in registers
template <int G, int S, int H>
__device__ __forceinline__ void reduce_scatter(float (&p)[S], int gl) {
  if constexpr (H >= 1) {
    const bool up = gl & H;
#pragma unroll
    for (int q = 0; q < S / G; ++q) {
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float lo = p[q * G + i], hi = p[q * G + i + H];
        p[q * G + i] =
            (up ? hi : lo) + __shfl_xor_sync(FULL, up ? lo : hi, H, G);
      }
    }
    reduce_scatter<G, S, H / 2>(p, gl);
  }
}

// lane group lane / G of a warp owns unit (warp * 32 / G + lane / G), lane
// gl = lane % G the columns of load_cols in each pass of G W columns
template <int G, int W, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
edge_dots_kernel(const int32_t* __restrict__ cols,
                 const int32_t* __restrict__ row_start,
                 const int4* __restrict__ units, const float* __restrict__ g,
                 const float* __restrict__ B, float* __restrict__ out,
                 int n_units, int k) {
  constexpr int S = G > 8 ? G : 8;  // edges a stage
  constexpr int R = S / G;          // of them staged by each lane
  const int lane = threadIdx.x % 32;
  const int gl = lane % G;
  const int u = (blockIdx.x * WARPS + threadIdx.x / 32) * (32 / G) + lane / G;
  int4 unit = make_int4(0, 0, 0, -1);  // (row, lo, hi, part)
  if (u < n_units) unit = units[u];
  const int len = u < n_units ? unit.z - unit.y : 0;
  const int n = __reduce_max_sync(FULL, len);
  const int64_t first = len > 0 ? (int64_t)row_start[unit.x] + unit.y : 0;
  const int32_t* ucols = cols + first;
  float* uout = out + first;
  const float* grow = g + (int64_t)unit.x * k;

  for (int c0 = 0; c0 < k; c0 += G * W) {
    float gv[W];
#pragma unroll
    for (int t = 0; t < W; ++t) gv[t] = 0.f;
    if (len > 0) load_cols<G, W, VEC>(grow, c0, gl, k, gv);

    int cs[R], ncs[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int j = q * G + gl;
      cs[q] = j < len ? ucols[j] : 0;
    }
    for (int j0 = 0; j0 < n; j0 += S) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int j = j0 + S + q * G + gl;
        ncs[q] = j < len ? ucols[j] : 0;
      }
      float p[S];
#pragma unroll
      for (int jj = 0; jj < S; ++jj) {
        const int r = __shfl_sync(FULL, cs[jj / G], jj % G, G);
        float d = 0.f;
        if (j0 + jj < len) {
          float b[W];
          load_cols<G, W, VEC>(B + (int64_t)r * k, c0, gl, k, b);
#pragma unroll
          for (int t = 0; t < W; ++t) d = fmaf(gv[t], b[t], d);
        }
        p[jj] = d;
      }
      reduce_scatter<G, S, G / 2>(p, gl);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int j = j0 + q * G + gl;
        if (j < len) uout[j] = c0 ? uout[j] + p[q * G] : p[q * G];
      }
#pragma unroll
      for (int q = 0; q < R; ++q) cs[q] = ncs[q];
    }
  }
}

template <int G, int W>
void launch_units(const int32_t* cols, const int32_t* row_start,
                  const int32_t* units, const float* g, const float* B,
                  float* out, int n_units, int k, bool vec, cudaStream_t st) {
  const int per_block = WARPS * (32 / G);
  const dim3 grid((n_units + per_block - 1) / per_block);
  const int4* u = reinterpret_cast<const int4*>(units);
  if (vec)
    edge_dots_kernel<G, W, true><<<grid, WARPS * 32, 0, st>>>(
        cols, row_start, u, g, B, out, n_units, k);
  else
    edge_dots_kernel<G, W, false><<<grid, WARPS * 32, 0, st>>>(
        cols, row_start, u, g, B, out, n_units, k);
}

}  // namespace

// cols: int32[T], the flat store; row_start: int32[m]; units:
// int32[n_units][4] (16-byte aligned); g: f32[m, k]; B: f32[n, k]; out:
// f32[T], written at every entry the units cover.  lanes: a power of two
// <= 32 (below 32, 4 lanes >= k); width: the columns a lane holds in each
// pass, 4, or 8 at 32 lanes.  Returns the launch's cudaError_t.
extern "C" int flex_edge_dots(const int32_t* cols, const int32_t* row_start,
                              const int32_t* units, const float* g,
                              const float* B, float* out, int n_units, int k,
                              int lanes, int width, void* stream) {
  if (k < 0 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      (width != 4 && width != 8) ||
      (lanes < 32 && (width != 4 || 4 * lanes < k)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_units == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(B) % 16 == 0;
#define FLEX_DOTS(G, W) \
  launch_units<G, W>(cols, row_start, units, g, B, out, n_units, k, vec, st)
  switch (lanes) {
    case 1: FLEX_DOTS(1, 4); break;
    case 2: FLEX_DOTS(2, 4); break;
    case 4: FLEX_DOTS(4, 4); break;
    case 8: FLEX_DOTS(8, 4); break;
    case 16: FLEX_DOTS(16, 4); break;
    default:
      if (width == 8)
        FLEX_DOTS(32, 8);
      else
        FLEX_DOTS(32, 4);
      break;
  }
#undef FLEX_DOTS
  return static_cast<int>(cudaGetLastError());
}
