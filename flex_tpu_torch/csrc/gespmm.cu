// Row-unit CSR SpMM for Hopper (sm_90a), plain C interface: GE-SpMM's
// whole product and the windowed plan's ELL residue, forward and backward.
//
// Replaces the Pallas kernel flex_tpu/ops/gespmm.py:_gespmm_call: its chunk
// kernel (_make_kernel) AND the scatter-add by chunk_row after it, so C =
// A.B comes out of the card whole.  It also runs the ELL residue that
// flex_tpu/ops/ell_spmm.py:_ell_spmm computes in XLA (per width bucket a
// gather of B rows times the values, then the chunks of a row summed): both
// formats cut rows into chunks of a flat store, and a row's chunks are
// consecutive there and full but for the last, so row r's nonzeros are the
// one contiguous run
//
//   cols[row_start[r] .. row_start[r] + len(r)),  vals[...] the same
//
// and C[r, :] = sum over that run of vals[e] * B[cols[e], :].  The pads
// that round each chunk up to its width lie outside the run and are never
// read (a non-finite value in B row 0 no longer reaches a padded chunk's
// row, as it would through the plain product).
//
// Work units.  The host cuts every row's run into units of at most 256
// nonzeros (ops/gespmm.py:ROW_UNIT_ENTRIES), as evenly as the count allows:
// units[u] = (row, lo, hi, part), entries row_start[row] + lo .. + hi.  One
// warp owns one unit and one 128-column slice of k: it stages 32 cols and
// vals at a time in registers (one coalesced load each, then a warp shuffle
// per entry) and reads each B row straight from global memory, coalesced
// along k, into four sums a lane.  A row of one unit (part -1) writes its
// output row once, or adds its sum to it when the call accumulates (the
// windowed plan adds the residue into its dense half in place).  The units
// of a longer row write partial rows into scratch[part]; a second kernel
// adds each such row's partials and writes once: warp w of a block sums
// parts w, w + 8, ... in order and warp 0 adds the eight sums in warp
// order.  A hub row (the transposed residue's row 0 holds every pad entry
// of the forward's buckets) is thus cut into many units and summed by a
// whole block, not one warp.  No atomics and no order that changes between
// launches: two launches give the same bits.
//
// k is any width: a lane owns four consecutive columns of its slice (one
// float4 per B row) when k % 4 == 0 and the rows are 16-byte aligned, else
// columns lane, lane + 32, ... with masks; k > 128 takes more slices along
// grid y.  At k <= 64 a unit takes fewer lanes (flex_gespmm_rows_grouped,
// rows_group_kernel): G lanes, the smallest power of two with 4 G >= k, own
// one unit, so a warp runs 32 / G units (G = 16 at k = 41, 2 at k = 7) and
// one load instruction of the warp reads the B rows of 32 / G nonzeros.  A
// lane owns four columns: 4 gl .. 4 gl + 3 by float4 when k % 4 == 0 and
// the rows are aligned, else gl, gl + G, gl + 2 G, gl + 3 G by scalar loads,
// so the G lanes of a group read consecutive floats.  The group stages and
// walks its unit as rows_bf16_kernel's groups do (below); each column's sum
// is the same fmaf chain in the unit's order, and split rows go through the
// same reduce pass, so the grouped instance gives rows_kernel's bits.
//
// B in bf16 (flex_gespmm_rows_bf16): the JAX package's b_dtype="bfloat16"
// gather mode (flex_tpu/ops/ell_spmm.py:_ell_spmm, XLA there) casts B once
// and gathers bf16 rows; the products with the f32 values are summed in
// f32.  It has a body of its own (rows_bf16_kernel), shaped by the bytes
// of a bf16 row:
//   - a lane owns 8 consecutive columns: one 16-byte load (uint4) of a B
//     row, widened in registers with __bfloat1622float2.  The plans cast B
//     into rows of ldb = round_up(k, 8) elements with zero pads
//     (ops/gespmm.py:to_bf16_padded), so every k takes that load; the pad
//     columns are summed and never stored.  B rows that are not 16-byte
//     aligned (ldb % 8 != 0, or a misaligned pointer) take 2-byte loads in
//     the same body;
//   - G lanes (a power of two, 8 G >= min(k, 128)) own one unit, so a warp
//     runs 32 / G units: one load instruction of the warp fetches the B
//     rows of 2 (k = 128) to 32 (k <= 8) nonzeros.  A group stages its
//     unit's cols and vals in its own lanes, the next stage's ahead, and
//     shuffles them within the group (width G).  The warp walks its longest
//     unit: every lane takes every shuffle, with the whole warp's mask, and
//     an entry past its group's unit loads and adds nothing.  (With each
//     group's own mask, groups could leave on their own, but the compiler
//     then checks convergence before each shuffle of a partial stage, and
//     the body ran slower at k = 128.)  Units are in row order and the
//     orderings sort rows by degree, so the units of a warp have close
//     lengths: on the reddit_posts graph the warps walk 1.001-1.006 times
//     the entries they hold;
//   - each group walks its unit's nonzeros in order and each lane runs the
//     f32 instance's fmaf chain per column, and the partial rows go through
//     the same reduce pass, so on B rounded to bf16 and widened it gives
//     the f32 instance's bits.  out, scratch and the accumulator stay f32
//     [*, k]: float4 stores when k % 4 == 0 and they are aligned, else
//     masked scalar stores.
// On an H100 80GB HBM3 at 700 W on the reddit_posts graph, 16-byte loads of
// the padded cast ran at 7.3 / 4.8 / 4.5 TB/s of gathered rows (nnz x ldb
// x 2 bytes) at k = 128 / 41 / 32: 0.82 / 0.47 / 0.34 ms, where the f32
// body on 8-byte bf16 loads took 1.02 / 1.02 ms at k = 128 / 41.
//
// Bound: 2 operations per 4 bytes of B row read, far below the FP32 ridge
// (20 flop/byte), so bytes bound it; what this run's data needs once is
// cols, vals, B and C.  What the kernel moves is more: every nonzero reads
// a whole B row, from L2 when the graph's ordering keeps a row's columns
// close.  At k = 128 that L2 traffic of re-read B rows is the limit: on an
// H100 the f32 units pass ran at about 8.6 TB/s of gathered rows on the
// reddit_posts graph, and neither the unit size (64 to 1024 nonzeros) nor a
// cap of 32 registers (64 warps an SM, with spills) moved it.  Reuse of B
// rows through shared memory across the rows of a tile is not done here.
// At narrow k the limit was not bytes but lanes idle for each nonzero: with
// a warp a unit, k = 41 cost every nonzero two masked loads, two shuffles
// and a serial step with 23 of 32 lanes idle on the second load, 3.9 TB/s
// of gathered rows (0.99 ms); k = 7 left 25 of 32 lanes idle on its only
// load.  In lane groups, on an H100 80GB HBM3 at 700 W, k = 41 on the
// reddit_posts graph runs at 5.9 TB/s (0.65 ms) and k = 7 on the
// flickr_posts graph at 0.42 TB/s (0.066 ms, against 0.073 a warp a unit);
// with L2 flushed before the call k = 7 takes 0.087 ms either way, so there
// something else than lanes or bytes sets the time.  16-byte loads on a
// copy of B padded to round_up(k, 4) floats gathered faster (0.63 ms at
// k = 41), but the copy (0.05 ms) made the call slower than scalar loads
// of B as it lies.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;    // units per block of the unit kernel
constexpr int SLICE = 128;  // columns of k per warp: 4 per lane
constexpr int RWARPS = 8;   // warps per split row in the reduce pass

template <bool VEC>
__device__ __forceinline__ void load4(const float* row, int col0, int k,
                                      int lane, float (&v)[4]) {
  if (VEC) {
    if (col0 + lane * 4 < k) {
      const float4 b = *reinterpret_cast<const float4*>(row + lane * 4);
      v[0] = b.x, v[1] = b.y, v[2] = b.z, v[3] = b.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (col0 + lane + 32 * t < k) v[t] = row[lane + 32 * t];
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* row, int col0, int k, int lane,
                                       const float (&v)[4]) {
  if (VEC) {
    if (col0 + lane * 4 < k)
      *reinterpret_cast<float4*>(row + lane * 4) =
          make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (col0 + lane + 32 * t < k) row[lane + 32 * t] = v[t];
  }
}

// out[row] (+)= sum of the unit's entries, or scratch[part] = that sum;
// T is B's element type (float or __nv_bfloat16)
template <typename T, bool VEC, bool ACC>
__global__ void __launch_bounds__(WARPS * 32)
rows_kernel(const int32_t* __restrict__ cols, const float* __restrict__ vals,
            const int32_t* __restrict__ row_start,
            const int4* __restrict__ units, const T* __restrict__ B,
            float* __restrict__ out, float* __restrict__ scratch, int n_units,
            int k) {
  const int u = blockIdx.x * WARPS + threadIdx.x / 32;
  if (u >= n_units) return;  // the whole warp leaves together
  const int4 unit = units[u];  // (row, lo, hi, part)
  if (ACC && unit.w < 0 && unit.y == unit.z) return;  // adds nothing
  const int lane = threadIdx.x % 32;
  const int col0 = blockIdx.y * SLICE;
  const int64_t base = row_start[unit.x];

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j0 = unit.y; j0 < unit.z; j0 += 32) {
    int c = 0;
    float v = 0.f;
    if (j0 + lane < unit.z) {
      c = cols[base + j0 + lane];
      v = vals[base + j0 + lane];
    }
    const int cnt = min(32, unit.z - j0);
#pragma unroll 8
    for (int jj = 0; jj < cnt; ++jj) {
      const int r = __shfl_sync(0xffffffffu, c, jj);
      const float a = __shfl_sync(0xffffffffu, v, jj);
      float b[4] = {0.f, 0.f, 0.f, 0.f};
      load4<VEC>(B + (int64_t)r * k + col0, col0, k, lane, b);
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[t] = fmaf(a, b[t], acc[t]);
    }
  }

  if (unit.w >= 0) {
    store4<VEC>(scratch + (int64_t)unit.w * k + col0, col0, k, lane, acc);
    return;
  }
  float* orow = out + (int64_t)unit.x * k + col0;
  if (ACC) {
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    load4<VEC>(orow, col0, k, lane, o);
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[t] = o[t] + acc[t];
  }
  store4<VEC>(orow, col0, k, lane, acc);
}

// splits[i] = (row, part_lo, part_hi): out[row] (+)= the sum of scratch
// rows part_lo .. part_hi - 1, in a fixed order
template <bool VEC, bool ACC>
__global__ void __launch_bounds__(RWARPS * 32)
rows_reduce_kernel(const float* __restrict__ scratch,
                   const int32_t* __restrict__ splits, float* __restrict__ out,
                   int k) {
  __shared__ float sums[RWARPS][4][32];
  const int row = splits[3 * blockIdx.x];
  const int p_lo = splits[3 * blockIdx.x + 1];
  const int p_hi = splits[3 * blockIdx.x + 2];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col0 = blockIdx.y * SLICE;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int p = p_lo + warp; p < p_hi; p += RWARPS) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    load4<VEC>(scratch + (int64_t)p * k + col0, col0, k, lane, v);
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[t] += v[t];
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) sums[warp][t][lane] = acc[t];
  __syncthreads();
  if (warp) return;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    acc[t] = sums[0][t][lane];
#pragma unroll
    for (int w = 1; w < RWARPS; ++w) acc[t] += sums[w][t][lane];
  }
  float* orow = out + (int64_t)row * k + col0;
  if (ACC) {
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    load4<VEC>(orow, col0, k, lane, o);
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[t] = o[t] + acc[t];
  }
  store4<VEC>(orow, col0, k, lane, acc);
}

template <typename T, bool VEC, bool ACC>
int launch(const int32_t* cols, const float* vals, const int32_t* row_start,
           const int32_t* units, const int32_t* splits, const T* B,
           float* out, float* scratch, int n_units, int n_splits, int k,
           cudaStream_t st) {
  const int slices = (k + SLICE - 1) / SLICE;
  if (n_units) {
    const dim3 grid((n_units + WARPS - 1) / WARPS, slices);
    rows_kernel<T, VEC, ACC><<<grid, WARPS * 32, 0, st>>>(
        cols, vals, row_start, reinterpret_cast<const int4*>(units), B, out,
        scratch, n_units, k);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n_splits) {
    const dim3 grid(n_splits, slices);
    rows_reduce_kernel<VEC, ACC><<<grid, RWARPS * 32, 0, st>>>(scratch, splits,
                                                               out, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// the vector path moves 4 elements of B a lane (one float4) and float4
// rows of out and scratch
template <typename T>
int launch_any(const int32_t* cols, const float* vals,
               const int32_t* row_start, const int32_t* units,
               const int32_t* splits, const T* B, float* out, float* scratch,
               int n_units, int n_splits, int k, int accumulate,
               void* stream) {
  if (k == 0 || (n_units == 0 && n_splits == 0)) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = k % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(B) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(scratch) % 16 == 0;
#define FLEX_ROWS(VEC, ACC)                                                  \
  launch<T, VEC, ACC>(cols, vals, row_start, units, splits, B, out, scratch, \
                      n_units, n_splits, k, st)
  if (accumulate) return vec ? FLEX_ROWS(true, true) : FLEX_ROWS(false, true);
  return vec ? FLEX_ROWS(true, false) : FLEX_ROWS(false, false);
#undef FLEX_ROWS
}

// ---- B in bf16: G lanes a unit, 8 columns a lane --------------------------

// eight bf16 of a B row from column c, widened: one 16-byte load (VEC: the
// row and ldb 16-byte aligned; columns up to round_up(k, 8) lie in the row's
// pad) or 2-byte loads of the columns below k
template <bool VEC>
__device__ __forceinline__ void load8(const __nv_bfloat16* row, int c, int k,
                                      float (&v)[8]) {
  if (c >= k) return;
  if (VEC) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(h[t]);
      v[2 * t] = f.x, v[2 * t + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (c + t < k) v[t] = __bfloat162float(row[c + t]);
  }
}

// eight f32 of an out or scratch row from column c, columns below k only:
// two float4 (V4: k % 4 == 0 and the row 16-byte aligned) or scalars
__device__ __forceinline__ void load8f(const float* row, int c, int k, bool v4,
                                       float (&v)[8]) {
  if (v4) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (c + 4 * h < k) {
        const float4 o = *reinterpret_cast<const float4*>(row + c + 4 * h);
        v[4 * h] = o.x, v[4 * h + 1] = o.y, v[4 * h + 2] = o.z,
        v[4 * h + 3] = o.w;
      }
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (c + t < k) v[t] = row[c + t];
  }
}

__device__ __forceinline__ void store8f(float* row, int c, int k, bool v4,
                                        const float (&v)[8]) {
  if (v4) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (c + 4 * h < k)
        *reinterpret_cast<float4*>(row + c + 4 * h) = make_float4(
            v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (c + t < k) row[c + t] = v[t];
  }
}

// rows_kernel's function with B in bf16 (row stride ldb): lane group
// lane / G of a warp owns unit (warp * 32 / G + lane / G), lane lane % G
// columns col0 + 8 (lane % G) .. + 8 of the slice.  The warp walks its
// longest unit's length in stages of S = max(G, 8) entries, each lane
// staging R = S / G cols and vals (the next stage's loaded before this
// stage's B rows); every lane takes every shuffle, and an entry past its
// group's unit loads and adds nothing.  acc_into: out[row] += the sum; v4:
// out and scratch move by float4
template <int G, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
rows_bf16_kernel(const int32_t* __restrict__ cols,
                 const float* __restrict__ vals,
                 const int32_t* __restrict__ row_start,
                 const int4* __restrict__ units,
                 const __nv_bfloat16* __restrict__ B, float* __restrict__ out,
                 float* __restrict__ scratch, int n_units, int k, int ldb,
                 bool acc_into, bool v4) {
  constexpr int S = G > 8 ? G : 8;
  constexpr int R = S / G;
  const int lane = threadIdx.x % 32;
  const int gl = lane % G;
  const int u = (blockIdx.x * WARPS + threadIdx.x / 32) * (32 / G) + lane / G;
  int4 unit = make_int4(0, 0, 0, -1);  // (row, lo, hi, part)
  if (u < n_units) unit = units[u];
  // a group past the last unit, or whose unit adds nothing, has no entries
  const bool live =
      u < n_units && !(acc_into && unit.w < 0 && unit.y == unit.z);
  const int len = live ? unit.z - unit.y : 0;
  const int n = __reduce_max_sync(0xffffffffu, len);
  const int c = blockIdx.y * SLICE + gl * 8;
  const int32_t* ucols = cols + (live ? row_start[unit.x] + unit.y : 0);
  const float* uvals = vals + (ucols - cols);

  int cs[R], ncs[R];
  float vs[R], nvs[R];
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const int j = t * G + gl;
    cs[t] = j < len ? ucols[j] : 0;
    vs[t] = j < len ? uvals[j] : 0.f;
  }
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j0 = 0; j0 < n; j0 += S) {
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int j = j0 + S + t * G + gl;
      ncs[t] = j < len ? ucols[j] : 0;
      nvs[t] = j < len ? uvals[j] : 0.f;
    }
#pragma unroll 8
    for (int jj = 0; jj < S; ++jj) {
      const int r = __shfl_sync(0xffffffffu, cs[jj / G], jj % G, G);
      const float a = __shfl_sync(0xffffffffu, vs[jj / G], jj % G, G);
      if (j0 + jj < len) {
        float b[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        load8<VEC>(B + (int64_t)r * ldb, c, k, b);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = fmaf(a, b[i], acc[i]);
      }
    }
#pragma unroll
    for (int t = 0; t < R; ++t) cs[t] = ncs[t], vs[t] = nvs[t];
  }
  if (!live) return;

  if (unit.w >= 0) {
    store8f(scratch + (int64_t)unit.w * k, c, k, v4, acc);
    return;
  }
  float* orow = out + (int64_t)unit.x * k;
  if (acc_into) {
    float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    load8f(orow, c, k, v4, o);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = o[i] + acc[i];
  }
  store8f(orow, c, k, v4, acc);
}

template <int G>
void launch_bf16_units(const int32_t* cols, const float* vals,
                       const int32_t* row_start, const int32_t* units,
                       const __nv_bfloat16* B, float* out, float* scratch,
                       int n_units, int k, int ldb, bool vec, bool acc_into,
                       bool v4, cudaStream_t st) {
  const int per_block = WARPS * (32 / G);
  const dim3 grid((n_units + per_block - 1) / per_block,
                  (k + SLICE - 1) / SLICE);
  const int4* u = reinterpret_cast<const int4*>(units);
  if (vec)
    rows_bf16_kernel<G, true><<<grid, WARPS * 32, 0, st>>>(
        cols, vals, row_start, u, B, out, scratch, n_units, k, ldb, acc_into,
        v4);
  else
    rows_bf16_kernel<G, false><<<grid, WARPS * 32, 0, st>>>(
        cols, vals, row_start, u, B, out, scratch, n_units, k, ldb, acc_into,
        v4);
}

// the pass over split rows, by float4 when v4 (k % 4 == 0, out and scratch
// 16-byte aligned)
void launch_reduce(const float* scratch, const int32_t* splits, float* out,
                   int n_splits, int k, bool v4, bool acc_into,
                   cudaStream_t st) {
  const dim3 grid(n_splits, (k + SLICE - 1) / SLICE);
  if (v4 && acc_into)
    rows_reduce_kernel<true, true><<<grid, RWARPS * 32, 0, st>>>(
        scratch, splits, out, k);
  else if (v4)
    rows_reduce_kernel<true, false><<<grid, RWARPS * 32, 0, st>>>(
        scratch, splits, out, k);
  else if (acc_into)
    rows_reduce_kernel<false, true><<<grid, RWARPS * 32, 0, st>>>(
        scratch, splits, out, k);
  else
    rows_reduce_kernel<false, false><<<grid, RWARPS * 32, 0, st>>>(
        scratch, splits, out, k);
}

// ---- f32 B at narrow k: G lanes a unit, 4 columns a lane ------------------

// the t-th of the four columns that lane gl of a group owns: 4 gl + t
// (VEC: one float4 of a B row) or gl + G t (scalar loads, each of the
// group's G lanes on consecutive columns)
template <int G, bool VEC>
__device__ __forceinline__ int group_col(int gl, int t) {
  return VEC ? 4 * gl + t : gl + G * t;
}

// four f32 of a row ([*, k]) at the lane's columns below k: one float4
// (VEC: k % 4 == 0 and the row 16-byte aligned) or scalars
template <int G, bool VEC>
__device__ __forceinline__ void load4g(const float* row, int gl, int k,
                                       float (&v)[4]) {
  if (VEC) {
    if (4 * gl < k) {
      const float4 b = *reinterpret_cast<const float4*>(row + 4 * gl);
      v[0] = b.x, v[1] = b.y, v[2] = b.z, v[3] = b.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (group_col<G, VEC>(gl, t) < k) v[t] = row[group_col<G, VEC>(gl, t)];
  }
}

template <int G, bool VEC>
__device__ __forceinline__ void store4g(float* row, int gl, int k,
                                        const float (&v)[4]) {
  if (VEC) {
    if (4 * gl < k)
      *reinterpret_cast<float4*>(row + 4 * gl) =
          make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (group_col<G, VEC>(gl, t) < k) row[group_col<G, VEC>(gl, t)] = v[t];
  }
}

// rows_kernel's function for k <= 4 G <= 64, in rows_bf16_kernel's shape:
// lane group lane / G of a warp owns unit (warp * 32 / G + lane / G), and
// lane gl = lane % G the four columns group_col(gl, 0..3).  The warp walks
// its longest unit's length in stages of S = max(G, 8) entries, each lane
// staging R = S / G cols and vals (the next stage's loaded before this
// stage's B rows), shuffled within the group; every lane takes every
// shuffle, and an entry past its group's unit loads and adds nothing.  Each
// column's sum is rows_kernel's fmaf chain in the unit's order, so the bits
// are its bits.  VEC: B, out and scratch move by float4.
template <int G, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
rows_group_kernel(const int32_t* __restrict__ cols,
                  const float* __restrict__ vals,
                  const int32_t* __restrict__ row_start,
                  const int4* __restrict__ units, const float* __restrict__ B,
                  float* __restrict__ out, float* __restrict__ scratch,
                  int n_units, int k, bool acc_into) {
  constexpr int S = G > 8 ? G : 8;
  constexpr int R = S / G;
  const int lane = threadIdx.x % 32;
  const int gl = lane % G;
  const int u = (blockIdx.x * WARPS + threadIdx.x / 32) * (32 / G) + lane / G;
  int4 unit = make_int4(0, 0, 0, -1);  // (row, lo, hi, part)
  if (u < n_units) unit = units[u];
  // a group past the last unit, or whose unit adds nothing, has no entries
  const bool live =
      u < n_units && !(acc_into && unit.w < 0 && unit.y == unit.z);
  const int len = live ? unit.z - unit.y : 0;
  const int n = __reduce_max_sync(0xffffffffu, len);
  const int32_t* ucols = cols + (live ? row_start[unit.x] + unit.y : 0);
  const float* uvals = vals + (ucols - cols);

  int cs[R], ncs[R];
  float vs[R], nvs[R];
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const int j = t * G + gl;
    cs[t] = j < len ? ucols[j] : 0;
    vs[t] = j < len ? uvals[j] : 0.f;
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j0 = 0; j0 < n; j0 += S) {
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int j = j0 + S + t * G + gl;
      ncs[t] = j < len ? ucols[j] : 0;
      nvs[t] = j < len ? uvals[j] : 0.f;
    }
#pragma unroll
    for (int jj = 0; jj < S; ++jj) {
      const int r = __shfl_sync(0xffffffffu, cs[jj / G], jj % G, G);
      const float a = __shfl_sync(0xffffffffu, vs[jj / G], jj % G, G);
      if (j0 + jj < len) {
        float b[4] = {0.f, 0.f, 0.f, 0.f};
        load4g<G, VEC>(B + (int64_t)r * k, gl, k, b);
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[t] = fmaf(a, b[t], acc[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < R; ++t) cs[t] = ncs[t], vs[t] = nvs[t];
  }
  if (!live) return;

  if (unit.w >= 0) {
    store4g<G, VEC>(scratch + (int64_t)unit.w * k, gl, k, acc);
    return;
  }
  float* orow = out + (int64_t)unit.x * k;
  if (acc_into) {
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    load4g<G, VEC>(orow, gl, k, o);
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[t] = o[t] + acc[t];
  }
  store4g<G, VEC>(orow, gl, k, acc);
}

template <int G>
void launch_group_units(const int32_t* cols, const float* vals,
                        const int32_t* row_start, const int32_t* units,
                        const float* B, float* out, float* scratch,
                        int n_units, int k, bool vec, bool acc_into,
                        cudaStream_t st) {
  const int per_block = WARPS * (32 / G);
  const dim3 grid((n_units + per_block - 1) / per_block);
  const int4* u = reinterpret_cast<const int4*>(units);
  if (vec)
    rows_group_kernel<G, true><<<grid, WARPS * 32, 0, st>>>(
        cols, vals, row_start, u, B, out, scratch, n_units, k, acc_into);
  else
    rows_group_kernel<G, false><<<grid, WARPS * 32, 0, st>>>(
        cols, vals, row_start, u, B, out, scratch, n_units, k, acc_into);
}

}  // namespace

// cols, vals: the flat store; row_start: int32[m]; units: int32[n_units][4]
// (16-byte aligned); splits: int32[n_splits][3]; B: [n, k]; out: [m, k],
// added into when accumulate != 0; scratch: [n_parts, k].  Returns the
// launches' cudaError_t.
extern "C" int flex_gespmm_rows(const int32_t* cols, const float* vals,
                                const int32_t* row_start, const int32_t* units,
                                const int32_t* splits, const float* B,
                                float* out, float* scratch, int n_units,
                                int n_splits, int k, int accumulate,
                                void* stream) {
  return launch_any<float>(cols, vals, row_start, units, splits, B, out,
                           scratch, n_units, n_splits, k, accumulate, stream);
}

// the same with B in bf16, rows ldb elements apart (ldb >= k), read by
// lane groups of `lanes` (a power of two <= 16, 8 lanes >= min(k, 128));
// out, scratch and the sums f32
extern "C" int flex_gespmm_rows_bf16(const int32_t* cols, const float* vals,
                                     const int32_t* row_start,
                                     const int32_t* units,
                                     const int32_t* splits,
                                     const __nv_bfloat16* B, float* out,
                                     float* scratch, int n_units,
                                     int n_splits, int k, int accumulate,
                                     int ldb, int lanes, void* stream) {
  const int need = (k < SLICE ? k : SLICE);
  if (ldb < k || lanes < 1 || lanes > SLICE / 8 || (lanes & (lanes - 1)) ||
      (k > 0 && 8 * lanes < need))
    return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0 || (n_units == 0 && n_splits == 0)) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = ldb % 8 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
  const bool v4 = k % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(scratch) % 16 == 0;
  const bool acc_into = accumulate != 0;
  if (n_units) {
#define FLEX_BF16(G)                                                        \
  launch_bf16_units<G>(cols, vals, row_start, units, B, out, scratch,       \
                       n_units, k, ldb, vec, acc_into, v4, st)
    switch (lanes) {
      case 1: FLEX_BF16(1); break;
      case 2: FLEX_BF16(2); break;
      case 4: FLEX_BF16(4); break;
      case 8: FLEX_BF16(8); break;
      default: FLEX_BF16(16); break;
    }
#undef FLEX_BF16
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n_splits)
    launch_reduce(scratch, splits, out, n_splits, k, v4, acc_into, st);
  return static_cast<int>(cudaGetLastError());
}

// flex_gespmm_rows for k <= 64, read by lane groups of `lanes` (a power of
// two <= 16, 4 lanes >= k): one 16-byte load a lane when k % 4 == 0 and B,
// out and scratch are 16-byte aligned, else scalar loads.  The same bits as
// flex_gespmm_rows.
extern "C" int flex_gespmm_rows_grouped(const int32_t* cols,
                                        const float* vals,
                                        const int32_t* row_start,
                                        const int32_t* units,
                                        const int32_t* splits, const float* B,
                                        float* out, float* scratch,
                                        int n_units, int n_splits, int k,
                                        int accumulate, int lanes,
                                        void* stream) {
  if (lanes < 1 || lanes > 16 || (lanes & (lanes - 1)) || 4 * lanes < k)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0 || (n_units == 0 && n_splits == 0)) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v4 = k % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(scratch) % 16 == 0;
  const bool vec = v4 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
  const bool acc_into = accumulate != 0;
  if (n_units) {
#define FLEX_GROUP(G)                                                       \
  launch_group_units<G>(cols, vals, row_start, units, B, out, scratch,      \
                        n_units, k, vec, acc_into, st)
    switch (lanes) {
      case 1: FLEX_GROUP(1); break;
      case 2: FLEX_GROUP(2); break;
      case 4: FLEX_GROUP(4); break;
      case 8: FLEX_GROUP(8); break;
      default: FLEX_GROUP(16); break;
    }
#undef FLEX_GROUP
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n_splits)
    launch_reduce(scratch, splits, out, n_splits, k, v4, acc_into, st);
  return static_cast<int>(cudaGetLastError());
}
