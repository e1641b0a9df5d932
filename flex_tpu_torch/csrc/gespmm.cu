// GE-SpMM row-chunk partial sums for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel flex_tpu/ops/gespmm.py:_gespmm_call (kernel
// body _make_kernel).  Rows are cut into chunks of at most w nonzeros;
// chunk c holds its column ids cols[c, :] and values vals[c, :] (pads:
// column 0, value 0), and
//
//   partial[c, :] = sum over j < w of vals[c, j] * B[cols[c, j], :]
//
// The caller then scatter-adds the partials by chunk_row, as the JAX
// package does outside its kernel.  The TPU kernel took CH = 8 chunks a
// grid step and fetched each B row with an asynchronous row copy, 16 in
// flight, because that hardware has no per-lane gather.  The card has one,
// so this is the GPU design the TPU kernel was translated from: one warp
// per chunk, the chunk's cols/vals staged in registers (one coalesced load
// of 32 entries, then a warp shuffle per entry), each B row read straight
// from global memory coalesced along k, the chunk's sum kept in registers,
// one write of partial[c, :].  No shared memory, no atomics, no order
// between blocks.  A lane owns up to four of a 128-column slice of k: four
// consecutive ones (one float4 load per row) when k % 4 == 0 and the rows
// are 16-byte aligned, else columns lane, lane + 32, ... with masks, so
// any k works; k > 128 takes more blocks along y.  Pad entries read row 0
// of B and multiply it by 0, exactly as the plain version does, so they
// cannot fault.
//
// Bound: 2 operations per 4 bytes of B row read, far below the FP32 ridge
// (20 flop/byte), so bytes bound it: with no reuse of B rows through L2 it
// moves N*w*k*4 bytes of rows plus N*k*4 of partials.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;  // chunks per block
constexpr int SLICE = 128;  // columns of k per block: 4 per lane

template <bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
gespmm_kernel(const int32_t* __restrict__ cols, const float* __restrict__ vals,
              const float* __restrict__ B, float* __restrict__ partial,
              int N, int w, int k) {
  const int chunk = blockIdx.x * WARPS + threadIdx.x / 32;
  if (chunk >= N) return;  // the whole warp leaves together
  const int lane = threadIdx.x % 32;
  const int col0 = blockIdx.y * SLICE;
  const int32_t* crow = cols + (int64_t)chunk * w;
  const float* vrow = vals + (int64_t)chunk * w;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j0 = 0; j0 < w; j0 += 32) {
    int c = 0;
    float v = 0.f;
    if (j0 + lane < w) {
      c = crow[j0 + lane];
      v = vrow[j0 + lane];
    }
    const int cnt = min(32, w - j0);
#pragma unroll 8
    for (int jj = 0; jj < cnt; ++jj) {
      const int r = __shfl_sync(0xffffffffu, c, jj);
      const float a = __shfl_sync(0xffffffffu, v, jj);
      const float* brow = B + (int64_t)r * k + col0;
      if (VEC) {
        if (col0 + lane * 4 < k) {
          const float4 b = *reinterpret_cast<const float4*>(brow + lane * 4);
          acc[0] = fmaf(a, b.x, acc[0]);
          acc[1] = fmaf(a, b.y, acc[1]);
          acc[2] = fmaf(a, b.z, acc[2]);
          acc[3] = fmaf(a, b.w, acc[3]);
        }
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (col0 + lane + 32 * t < k)
            acc[t] = fmaf(a, brow[lane + 32 * t], acc[t]);
      }
    }
  }

  float* prow = partial + (int64_t)chunk * k + col0;
  if (VEC) {
    if (col0 + lane * 4 < k)
      *reinterpret_cast<float4*>(prow + lane * 4) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (col0 + lane + 32 * t < k) prow[lane + 32 * t] = acc[t];
  }
}

}  // namespace

// cols, vals: [N, w]; B: [n, k]; partial: [N, k].  Returns the launch's
// cudaError_t.
extern "C" int flex_gespmm_partials(const int32_t* cols, const float* vals,
                                    const float* B, float* partial, int N,
                                    int w, int k, void* stream) {
  if (N == 0 || k == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + WARPS - 1) / WARPS, (k + SLICE - 1) / SLICE);
  const bool vec = k % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(partial) % 16 == 0;
  if (vec)
    gespmm_kernel<true><<<grid, WARPS * 32, 0, st>>>(cols, vals, B, partial,
                                                     N, w, k);
  else
    gespmm_kernel<false><<<grid, WARPS * 32, 0, st>>>(cols, vals, B, partial,
                                                      N, w, k);
  return static_cast<int>(cudaGetLastError());
}
