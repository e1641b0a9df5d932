// Backward of the windowed dense half for Hopper (sm_90a), plain C interface:
// the gradient wrt A's values (g_A) and the gradient wrt B (g_B, compact).
//
// Replaces the Pallas kernels flex_tpu/ops/window_spmm.py:_window_bwd_gA_raw
// and :_window_bwd_gB_raw.  The format is the forward's (csrc/window_spmm.cu):
// step s holds a dense (TM, G*W) f32 tile A[s] whose G column slices meet the
// W-row blocks win_step[s*G + j] of B, and its product lands in output panel
// out_panel[s].  With g the cotangent of that output, [n_panels*TM, k]:
//
//   g_A[s][:, j*W:(j+1)*W] = g[out_panel[s]*TM : +TM, :] . B[win_step[s*G+j]*W : +W, :]^T
//   g_B block b            = sum over the slots (s, j) with win_step[s*G+j] == b of
//                            A[s][:, j*W:(j+1)*W]^T . g[out_panel[s]*TM : +TM, :]
//
// g_A: every (step, window) tile is independent and is written exactly once,
// so one block owns one (window slot, BM-row, BN-column) tile.  A sentinel
// window (id nblk) and B rows >= n write zeros, which the TPU kernel got from
// a zero block appended to B; no padded copy of B is made, and the output
// needs no zero-fill pass.  The contraction runs over k, and both operands
// are k-contiguous rows, so both are staged transposed through shared memory
// (one padded column keeps the transposing stores to 2-way bank conflicts).
// Offsets into g_A are 64-bit (S*TM*G*W ~ 1.6e9 on the main path).
//
// g_B: the TPU grid walked the slots in block-id order and carried a block's
// sum from step to step; CUDA blocks run in no order.  The host sorts the
// real slots by block id and derives slot_ptr, and one block here owns one
// (block rank, BM-row, BN-column) output tile, loops over that rank's slots
// itself and writes its tile once: no atomics, no zero-init pass,
// deterministic.  The contraction runs over TM; A is read transposed, but a
// row of the A tile is already W-contiguous, so the stage through shared
// memory keeps the global reads coalesced (float4) with no transposing
// store.  The result is rank-indexed ([n_blk_used*W, k]); the caller
// scatters it to B's rows.
//
// Bound: each window does 2*TM*W*k FMA-operations against TM*W*4 bytes of A
// read (g_B) or written (g_A): 64 flop/byte at k=128, above the FP32 ridge of
// an H100 (67 TFLOP/s over 3.35 TB/s = 20 flop/byte), so the FP32 CUDA cores
// bound both.  The design is the forward's: a shared-memory-tiled SGEMM with
// an 8x8 register tile per thread.  Exact f32 throughout: no TF32, no split
// precision.  A block rank met by many panels makes one long chain of slots
// (the forward's long panels, turned); tensor cores and a split of long
// chains are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;  // output rows per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 16;   // contraction depth per shared-memory stage
constexpr int RM = 8;    // rows per thread
constexpr int RN = 8;    // columns per thread: two runs of 4, BN/2 apart
constexpr int NT = (BM / RM) * (BN / RN);  // 256 threads
constexpr int PAD = 4;   // keeps rows 16-byte aligned, spreads the banks

// acc += a (column of RM values) x b (row of RN values), for BK stages
template <int LDA, int LDB>
__device__ __forceinline__ void tile_fma(float (*As)[LDA], float (*Bs)[LDB],
                                         int tr, int tc,
                                         float (&acc)[RM][RN]) {
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
}

// rows [n_rows, k] row-major -> dst[q][r] = rows[row0 + r][kk + q], zero
// beyond n_rows (or row_limit) and beyond k
__device__ __forceinline__ void load_rows_transposed(
    float (*dst)[BM + PAD], const float* __restrict__ rows, int64_t row0,
    int64_t row_limit, int kk, int k, int tid) {
#pragma unroll
  for (int t = 0; t < (BM * BK) / NT; ++t) {
    const int i = tid + t * NT;
    const int r = i / BK;
    const int q = i % BK;
    float v = 0.f;
    if (row0 + r < row_limit && kk + q < k) v = rows[(row0 + r) * k + kk + q];
    dst[q][r] = v;
  }
}

__global__ void __launch_bounds__(NT)
window_bwd_gA_kernel(const float* __restrict__ g, const float* __restrict__ B,
                     const int32_t* __restrict__ win_step,
                     const int32_t* __restrict__ out_panel,
                     float* __restrict__ gA, int TM, int G, int W, int n,
                     int k, int nblk) {
  static_assert(BM == BN, "both operands use the BM-wide transposing loader");
  __shared__ __align__(16) float Gs[BK][BM + PAD];  // cotangent, [k][row]
  __shared__ __align__(16) float Bs[BK][BN + PAD];  // B block,   [k][w]

  const int sg = blockIdx.x;  // flat window slot s*G + j
  const int s = sg / G;
  const int j = sg % G;
  const int row0 = blockIdx.y * BM;  // within TM
  const int col0 = blockIdx.z * BN;  // within W
  const int tid = threadIdx.x;
  const int tr = tid / (BN / RN);
  const int tc = tid % (BN / RN);
  const int64_t GW = (int64_t)G * W;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[i][c] = 0.f;

  const int blk = win_step[sg];
  if (blk < nblk) {  // same for the whole block; a sentinel tile stays zero
    const float* g_rows = g + (int64_t)out_panel[s] * TM * k;
    const int64_t b_row0 = (int64_t)blk * W + col0;
    // rows of this W-block that exist: up to the block's end and up to n
    const int64_t b_end = (int64_t)blk * W + W;
    const int64_t b_limit = b_end < n ? b_end : (int64_t)n;
    for (int kk = 0; kk < k; kk += BK) {
      load_rows_transposed(Gs, g_rows, row0, TM, kk, k, tid);
      load_rows_transposed(Bs, B, b_row0, b_limit, kk, k, tid);
      __syncthreads();
      tile_fma<BM + PAD, BN + PAD>(Gs, Bs, tr, tc, acc);
      __syncthreads();
    }
  }

  // epilogue: every element of the tile is written exactly once (float4:
  // W % 4 == 0, so a run of 4 columns lies wholly inside or outside W)
  float* tile = gA + (int64_t)s * TM * GW + (int64_t)j * W;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = row0 + tr * RM + i;
    if (r >= TM) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + h * (BN / 2) + tc * 4;
      if (c < W)
        *reinterpret_cast<float4*>(tile + (int64_t)r * GW + c) = make_float4(
            acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
            acc[i][4 * h + 3]);
    }
  }
}

__global__ void __launch_bounds__(NT)
window_bwd_gB_kernel(const float* __restrict__ A, const float* __restrict__ g,
                     const int32_t* __restrict__ slot_s,
                     const int32_t* __restrict__ slot_g,
                     const int32_t* __restrict__ slot_ptr,
                     const int32_t* __restrict__ out_panel,
                     float* __restrict__ out, int TM, int G, int W, int k) {
  __shared__ __align__(16) float As[BK][BM];  // A tile rows, [tm][w]
  __shared__ __align__(16) float Gs[BK][BN];  // cotangent rows, [tm][k]

  const int rank = blockIdx.x;
  const int row0 = blockIdx.y * BM;  // within W
  const int col0 = blockIdx.z * BN;  // within k
  const int tid = threadIdx.x;
  const int tr = tid / (BN / RN);
  const int tc = tid % (BN / RN);
  const int64_t GW = (int64_t)G * W;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[i][c] = 0.f;

  const int t_lo = slot_ptr[rank];
  const int t_hi = slot_ptr[rank + 1];
  for (int t = t_lo; t < t_hi; ++t) {
    const int s = slot_s[t];
    // 64-bit: S*TM*GW ~ 1.6e9 on the main path
    const float* a_tile = A + (int64_t)s * TM * GW + (int64_t)slot_g[t] * W;
    const float* g_rows = g + (int64_t)out_panel[s] * TM * k;
    for (int q0 = 0; q0 < TM; q0 += BK) {
      // A: BK rows x BM columns, coalesced float4 along W, no transposition
#pragma unroll
      for (int u = 0; u < (BK * BM) / (4 * NT); ++u) {
        const int i = tid + u * NT;
        const int q = i / (BM / 4);
        const int w = (i % (BM / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q0 + q < TM && row0 + w < W)
          v = *reinterpret_cast<const float4*>(
              a_tile + (int64_t)(q0 + q) * GW + row0 + w);
        *reinterpret_cast<float4*>(&As[q][w]) = v;
      }
      // g: BK rows x BN columns, coalesced scalar loads with masks
#pragma unroll
      for (int u = 0; u < (BK * BN) / NT; ++u) {
        const int i = tid + u * NT;
        const int q = i / BN;
        const int c = i % BN;
        float v = 0.f;
        if (q0 + q < TM && col0 + c < k)
          v = g_rows[(int64_t)(q0 + q) * k + col0 + c];
        Gs[q][c] = v;
      }
      __syncthreads();
      tile_fma<BM, BN>(As, Gs, tr, tc, acc);
      __syncthreads();
    }
  }

  // epilogue: every output element of the tile is written exactly once
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int w = row0 + tr * RM + i;
    if (w >= W) continue;
    float* orow = out + ((int64_t)rank * W + w) * k;
#pragma unroll
    for (int c8 = 0; c8 < RN; ++c8) {
      const int c = col0 + (c8 < 4 ? tc * 4 + c8 : BN / 2 + tc * 4 + (c8 - 4));
      if (c < k) orow[c] = acc[i][c8];
    }
  }
}

}  // namespace

extern "C" int flex_window_bwd_gA(const float* g, const float* B,
                                  const int32_t* win_step,
                                  const int32_t* out_panel, float* gA, int S,
                                  int TM, int G, int W, int n, int k, int nblk,
                                  void* stream) {
  if (S == 0 || G == 0 || TM == 0) return 0;
  const dim3 grid(S * G, (TM + BM - 1) / BM, (W + BN - 1) / BN);
  window_bwd_gA_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      g, B, win_step, out_panel, gA, TM, G, W, n, k, nblk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flex_window_bwd_gB(const float* A, const float* g,
                                  const int32_t* slot_s, const int32_t* slot_g,
                                  const int32_t* slot_ptr,
                                  const int32_t* out_panel, float* out,
                                  int n_blk_used, int TM, int G, int W, int k,
                                  void* stream) {
  if (n_blk_used == 0 || k == 0) return 0;
  const dim3 grid(n_blk_used, (W + BM - 1) / BM, (k + BN - 1) / BN);
  window_bwd_gB_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      A, g, slot_s, slot_g, slot_ptr, out_panel, out, TM, G, W, k);
  return static_cast<int>(cudaGetLastError());
}
