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
// grid y.
//
// Bound: 2 operations per 4 bytes of B row read, far below the FP32 ridge
// (20 flop/byte), so bytes bound it; what this run's data needs once is
// cols, vals, B and C.  What the kernel moves is more: every nonzero reads
// a whole B row, from L2 when the graph's ordering keeps a row's columns
// close.  That L2 traffic of re-read B rows is the limit: on an H100 the
// units pass ran at about 8.6 TB/s of gathered rows on the reddit_posts
// graph, and neither the unit size (64 to 1024 nonzeros) nor a cap of 32
// registers (64 warps an SM, with spills) moved it.  Reuse of B rows
// through shared memory across the rows of a tile is not done here.

#include <cstdint>
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

// out[row] (+)= sum of the unit's entries, or scratch[part] = that sum
template <bool VEC, bool ACC>
__global__ void __launch_bounds__(WARPS * 32)
rows_kernel(const int32_t* __restrict__ cols, const float* __restrict__ vals,
            const int32_t* __restrict__ row_start,
            const int4* __restrict__ units, const float* __restrict__ B,
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

template <bool VEC, bool ACC>
int launch(const int32_t* cols, const float* vals, const int32_t* row_start,
           const int32_t* units, const int32_t* splits, const float* B,
           float* out, float* scratch, int n_units, int n_splits, int k,
           cudaStream_t st) {
  const int slices = (k + SLICE - 1) / SLICE;
  if (n_units) {
    const dim3 grid((n_units + WARPS - 1) / WARPS, slices);
    rows_kernel<VEC, ACC><<<grid, WARPS * 32, 0, st>>>(
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
  if (k == 0 || (n_units == 0 && n_splits == 0)) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(scratch) % 16 == 0;
#define FLEX_ROWS(VEC, ACC)                                                  \
  launch<VEC, ACC>(cols, vals, row_start, units, splits, B, out, scratch,   \
                   n_units, n_splits, k, st)
  if (accumulate) return vec ? FLEX_ROWS(true, true) : FLEX_ROWS(false, true);
  return vec ? FLEX_ROWS(true, false) : FLEX_ROWS(false, false);
#undef FLEX_ROWS
}
