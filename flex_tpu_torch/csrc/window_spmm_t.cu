// Transposed windowed dense-half SpMM forward for Hopper (sm_90a), plain C
// interface: the narrow-k variant of window_spmm.cu.
//
// Replaces the Pallas kernel flex_tpu/ops/window_spmm.py:_window_pallas_t_raw
// (kernel body _make_window_kernel_t).  The format is the same flat list of
// steps as the row-major kernel's, but step s holds its dense tile
// transposed: AT[s] is (G*W, TM) f32, its G row slices of W rows meet the
// W-column blocks win_step[s*G + g] of BT = B^T (k, n).  For every used row
// panel p
//
//   outT[:, p*TM : (p+1)*TM] = sum over the panel's steps s, windows g of
//                   BT[:, win_step[s*G+g]*W : +W] . AT[s][g*W : (g+1)*W, :]
//
// i.e. C^T, (k, n_panels*TM), which the caller transposes back.  Returning
// C^T keeps the kernel comparable with its TPU counterpart and with its
// plain version; the transposes of B and of the result are the caller's
// two small copies.
//
// The TPU grid ran step after step, zero-initialised a panel on its `first`
// step and carried the sum in the output block.  CUDA blocks run in no
// order, so one block owns one (panel, BR panel-rows, KC rows of k) tile of
// outT, loops over the panel's steps (panel_step_ptr) and windows itself
// and writes the tile once: no atomics, no zero-init pass.  Sentinel
// windows (id nblk) are skipped and BT columns >= n read as zero, so BT
// needs no padded copy.
//
// Bound: the block reads TM*W*4 bytes of AT per window for 2*TM*W*k
// operations, k/2 flop per byte: at k = 41 that is 20.5, about the FP32
// ridge of an H100 (67 TFLOP/s over 3.35 TB/s = 20 flop/byte), and at
// k = 32 below it.  So the point of this kernel is that the work scales
// with k: the tile over k is KC = 32, 48 or 64 rows, picked from k (k = 41
// runs one 48-row tile, k = 32 one 32-row tile, k > 64 several 64-row
// tiles), where the row-major kernel's tile is 128 columns whatever k is;
// with k <= 64 every byte of AT is read exactly once.
//
// Orientation in shared memory: AT[s] rows are TM-contiguous, and TM is the
// output's contiguous axis, so AT tiles go in as they lie, [w][r], by
// float4 (needs TM % 4 == 0 and a 16-byte aligned base).  BT rows are
// n-contiguous, which is the contraction axis, so a BT tile is read
// coalesced along w with scalar masked loads (n is any number, so rows are
// not 16-byte aligned) and stored transposed, [w][c]; the row pad of 2
// floats keeps those stores to 2-way bank conflicts and float2 reads
// aligned.  Exact f32 FMA throughout: no TF32, no split precision.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BK = 32;  // contraction depth per shared-memory stage
constexpr int TK = 8;   // thread rows along k
constexpr int RR = 8;   // panel rows per thread: two runs of 4, BR/2 apart

template <int KC, int BR>
__global__ void __launch_bounds__(TK * (BR / RR))
window_spmm_t_kernel(const float* __restrict__ AT, const float* __restrict__ BT,
                     const int32_t* __restrict__ win_step,
                     const int32_t* __restrict__ panel_step_ptr,
                     float* __restrict__ outT, int TM, int G, int W, int n,
                     int k, int nblk, int64_t ldc) {
  constexpr int NT = TK * (BR / RR);
  constexpr int RK = KC / TK;  // rows of k per thread (even)
  constexpr int LDB = KC + 2;
  static_assert(RK % 2 == 0 && (KC * BK) % NT == 0 &&
                (BK * BR) % (4 * NT) == 0, "tile shape");
  __shared__ __align__(16) float Bs[BK][LDB];  // BT tile, transposed: [w][c]
  __shared__ __align__(16) float As[BK][BR];   // AT tile: [w][r]

  const int panel = blockIdx.x;
  const int row0 = blockIdx.y * BR;
  const int c0 = blockIdx.z * KC;
  const int tid = threadIdx.x;
  const int tr = tid % (BR / RR);  // panel rows tr*4 .. +3 and BR/2 + tr*4 .. +3
  const int tk = tid / (BR / RR);  // rows of k: tk*RK .. tk*RK + RK-1
  const int64_t GW = (int64_t)G * W;

  float acc[RK][RR];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < RR; ++j) acc[i][j] = 0.f;

  const int s_lo = panel_step_ptr[panel];
  const int s_hi = panel_step_ptr[panel + 1];
  for (int s = s_lo; s < s_hi; ++s) {
    const float* a_step = AT + (int64_t)s * GW * TM;  // 64-bit: S*GW*TM ~ 1.6e9
    for (int g = 0; g < G; ++g) {
      const int blk = win_step[(int64_t)s * G + g];
      if (blk >= nblk) continue;  // sentinel window: same for the whole block
      const int64_t b_col0 = (int64_t)blk * W;
      for (int kk = 0; kk < W; kk += BK) {
        // BT tile: KC rows of k x BK columns, coalesced along the columns
#pragma unroll
        for (int t = 0; t < (KC * BK) / NT; ++t) {
          const int i = tid + t * NT;
          const int w = i % BK;
          const int c = i / BK;
          const int64_t col = b_col0 + kk + w;
          float v = 0.f;
          if (c0 + c < k && col < n) v = BT[(int64_t)(c0 + c) * n + col];
          Bs[w][c] = v;
        }
        // AT tile: BK rows x BR panel rows, float4
#pragma unroll
        for (int t = 0; t < (BK * BR) / (4 * NT); ++t) {
          const int i = tid + t * NT;
          const int r = (i % (BR / 4)) * 4;
          const int w = i / (BR / 4);
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (row0 + r < TM)
            v = *reinterpret_cast<const float4*>(
                a_step + ((int64_t)g * W + kk + w) * TM + row0 + r);
          *reinterpret_cast<float4*>(&As[w][r]) = v;
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < BK; ++q) {
          float b[RK];
#pragma unroll
          for (int i = 0; i < RK; i += 2) {
            const float2 v = *reinterpret_cast<const float2*>(&Bs[q][tk * RK + i]);
            b[i] = v.x;
            b[i + 1] = v.y;
          }
          const float4 a0 = *reinterpret_cast<const float4*>(&As[q][tr * 4]);
          const float4 a1 = *reinterpret_cast<const float4*>(&As[q][BR / 2 + tr * 4]);
          const float a[RR] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int i = 0; i < RK; ++i)
#pragma unroll
            for (int j = 0; j < RR; ++j) acc[i][j] = fmaf(b[i], a[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }

  // epilogue: every element of the tile is written exactly once, float4
  // along the panel rows (TM % 4 == 0 keeps them aligned)
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int c = c0 + tk * RK + i;
    if (c >= k) continue;
    float* orow = outT + (int64_t)c * ldc + (int64_t)panel * TM;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + h * (BR / 2) + tr * 4;
      if (r < TM)
        *reinterpret_cast<float4*>(orow + r) = make_float4(
            acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
  }
}

template <int KC, int BR>
int launch(const float* AT, const float* BT, const int32_t* win_step,
           const int32_t* panel_step_ptr, float* outT, int n_panels, int TM,
           int G, int W, int n, int k, int nblk, cudaStream_t stream) {
  const dim3 grid(n_panels, (TM + BR - 1) / BR, (k + KC - 1) / KC);
  window_spmm_t_kernel<KC, BR><<<grid, TK * (BR / RR), 0, stream>>>(
      AT, BT, win_step, panel_step_ptr, outT, TM, G, W, n, k, nblk,
      (int64_t)n_panels * TM);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Needs W % 32 == 0, TM % 4 == 0 and 16-byte aligned AT and outT (the
// wrapper checks).  Returns the launch's cudaError_t.
extern "C" int flex_window_spmm_t_fwd(const float* AT, const float* BT,
                                      const int32_t* win_step,
                                      const int32_t* panel_step_ptr,
                                      float* outT, int n_panels, int TM, int G,
                                      int W, int n, int k, int nblk,
                                      void* stream) {
  if (n_panels == 0 || k == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLEX_T_LAUNCH(KC)                                                      \
  return TM > 128                                                              \
             ? launch<KC, 256>(AT, BT, win_step, panel_step_ptr, outT,         \
                               n_panels, TM, G, W, n, k, nblk, st)             \
             : launch<KC, 128>(AT, BT, win_step, panel_step_ptr, outT,         \
                               n_panels, TM, G, W, n, k, nblk, st)
  if (k <= 32) { FLEX_T_LAUNCH(32); }
  if (k <= 48) { FLEX_T_LAUNCH(48); }
  FLEX_T_LAUNCH(64);
#undef FLEX_T_LAUNCH
}
