// Windowed dense-half SpMM forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel flex_tpu/ops/window_spmm.py:_window_pallas_raw
// (kernel body _make_window_kernel).  The format is a flat list of steps;
// step s holds a dense (TM, G*W) f32 tile A[s] whose G column slices meet
// the W-row blocks win_step[s*G + g] of B.  For every used row panel p
//
//   out[p*TM : (p+1)*TM, :] = sum over the panel's steps s, windows g of
//                             A[s][:, g*W : (g+1)*W] . B[win_step[s*G+g]*W : +W, :]
//
// A panel's steps are consecutive (panel_step_ptr[p] .. panel_step_ptr[p+1]).
// The TPU grid ran step after step and carried the panel sum in its output
// block; CUDA blocks run in no order, so here one block owns one
// (panel, BM-row tile, BN-column tile) of the output, loops over the
// panel's steps and windows itself, and writes its tile once: no atomics,
// no zero-init pass.  Windows whose id is the sentinel nblk are skipped, and
// B rows >= n read as zero, so no padded copy of B is made.
//
// Bound: at the main-path shapes (TM=256, G=4, W=128, k=128, ~48.7K real
// windows) the block does 2*TM*W*k FMA-operations per window against
// TM*W*4 bytes of A, i.e. 64 flop/byte: above the FP32 ridge of an H100
// (67 TFLOP/s over 3.35 TB/s = 20 flop/byte), so the plain FP32 CUDA
// cores bound it.  The design is a shared-memory-tiled SGEMM with an 8x8
// register tile per thread, which keeps 64 FMAs per 4 shared loads.
// Exact f32 throughout: no TF32, no split precision.  Tensor cores
// (wgmma, TMA) are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;  // output rows per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 16;   // contraction depth per shared-memory stage
constexpr int RM = 8;    // rows per thread
constexpr int RN = 8;    // columns per thread: two runs of 4, BN/2 apart
constexpr int NT = (BM / RM) * (BN / RN);  // 256 threads

__global__ void __launch_bounds__(NT)
window_spmm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   const int32_t* __restrict__ win_step,
                   const int32_t* __restrict__ panel_step_ptr,
                   float* __restrict__ out, int TM, int G, int W, int n,
                   int k, int nblk) {
  __shared__ __align__(16) float As[BK][BM];  // A tile, transposed
  __shared__ __align__(16) float Bs[BK][BN];

  const int panel = blockIdx.x;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.z * BN;
  const int tid = threadIdx.x;
  const int tr = tid / (BN / RN);  // 0..15: rows tr*8 .. tr*8+7
  const int tc = tid % (BN / RN);  // 0..15: cols tc*4 .. +3 and BN/2 + tc*4 .. +3
  const int64_t GW = (int64_t)G * W;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  const int s_lo = panel_step_ptr[panel];
  const int s_hi = panel_step_ptr[panel + 1];
  for (int s = s_lo; s < s_hi; ++s) {
    const float* a_step = A + (int64_t)s * TM * GW;  // 64-bit: S*TM*GW ~ 1.6e9
    for (int g = 0; g < G; ++g) {
      const int blk = win_step[(int64_t)s * G + g];
      if (blk >= nblk) continue;  // sentinel window: same for the whole block
      const int64_t b_row0 = (int64_t)blk * W;
      for (int kk = 0; kk < W; kk += BK) {
        // A tile: BM rows x BK columns, two float4 per thread
#pragma unroll
        for (int t = 0; t < (BM * BK) / (4 * NT); ++t) {
          const int i = tid + t * NT;
          const int r = i / (BK / 4);
          const int c = (i % (BK / 4)) * 4;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (row0 + r < TM)
            v = *reinterpret_cast<const float4*>(
                a_step + (int64_t)(row0 + r) * GW + (int64_t)g * W + kk + c);
          As[c + 0][r] = v.x;
          As[c + 1][r] = v.y;
          As[c + 2][r] = v.z;
          As[c + 3][r] = v.w;
        }
        // B tile: BK rows x BN columns, coalesced scalar loads with masks
#pragma unroll
        for (int t = 0; t < (BK * BN) / NT; ++t) {
          const int i = tid + t * NT;
          const int r = i / BN;
          const int c = i % BN;
          const int64_t brow = b_row0 + kk + r;
          float v = 0.f;
          if (brow < n && col0 + c < k) v = B[brow * k + col0 + c];
          Bs[r][c] = v;
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < BK; ++q) {
          const float4 a0 = *reinterpret_cast<const float4*>(&As[q][tr * RM]);
          const float4 a1 = *reinterpret_cast<const float4*>(&As[q][tr * RM + 4]);
          const float4 b0 = *reinterpret_cast<const float4*>(&Bs[q][tc * 4]);
          const float4 b1 = *reinterpret_cast<const float4*>(&Bs[q][BN / 2 + tc * 4]);
          const float a[RM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float b[RN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }

  // epilogue: every output element of the tile is written exactly once
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = row0 + tr * RM + i;
    if (r >= TM) continue;
    float* orow = out + ((int64_t)panel * TM + r) * k;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = col0 + (j < 4 ? tc * 4 + j : BN / 2 + tc * 4 + (j - 4));
      if (c < k) orow[c] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int flex_window_spmm_fwd(const float* A, const float* B,
                                    const int32_t* win_step,
                                    const int32_t* panel_step_ptr, float* out,
                                    int n_panels, int TM, int G, int W, int n,
                                    int k, int nblk, void* stream) {
  if (n_panels == 0 || k == 0) return 0;
  const dim3 grid(n_panels, (TM + BM - 1) / BM, (k + BN - 1) / BN);
  window_spmm_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      A, B, win_step, panel_step_ptr, out, TM, G, W, n, k, nblk);
  return static_cast<int>(cudaGetLastError());
}
