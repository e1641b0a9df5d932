// Band SpMM for Hopper (sm_90a), plain C interface: two kernels, one per
// band format of flex_tpu/ops/pallas_band.py.
//
//  flex_band_spmm_v2 replaces _band_spmm_pallas2 (kernel body
//  _make_kernel_v2).  The band of row panel p is split at format time into
//  a left and a right half, each (TM, W) f32, that meet two W-aligned,
//  contiguous row ranges of B:
//
//    out[p*TM : (p+1)*TM, :] = A_left[p]  . B[ iW[p]     *W : +W, :]
//                            + A_right[p] . B[(iW[p] + 1)*W : +W, :]
//
//  flex_band_spmm_v1 replaces BandPlan._call_pallas_v1 (kernel body
//  _band_kernel_v1).  The band of panel p is one (TM, W) f32 tile whose
//  128-column chunk j meets the 128-row block ws[p] + j of B:
//
//    out[p*TM : (p+1)*TM, :] = sum over j < W/128 of
//                      band[p][:, 128*j : +128] . B[(ws[p] + j)*128 : +128, :]
//
// Neither gathers: every B range is contiguous.  The TPU v2 grid ran one
// step per panel; its v1 grid ran (P, W/128) steps and revisited the
// panel's output block over j.  CUDA blocks run in no order and carry
// nothing, so in both kernels one block owns one (panel, BM-row tile,
// BN-column tile) of the output, does all of the tile's products itself
// (the two halves; the loop over j) and writes it once: no atomics, no
// zero-init.  Rows of B >= n read as zero, so B needs no padded copy (the
// TPU code pads B by up to two windows), and rows of a panel >= TM are
// masked, so TM is any positive number.  The two kernels share the tile
// product below; each has its own entry point.
//
// Bound: a block does 2*TM*W*k operations per TM*W*4 bytes of band, k/2
// flop per byte: 64 at k = 128, above the FP32 ridge of an H100
// (67 TFLOP/s over 3.35 TB/s = 20 flop/byte), so the FP32 CUDA cores bound
// both.  The design is a shared-memory-tiled SGEMM, 8 rows x BN/16 columns
// per thread, BN = 32, 64 or 128 picked from k so that a narrow k does
// less work.  Exact f32 FMA: no TF32, no split precision.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;  // output rows per block
constexpr int BK = 16;   // contraction depth per shared-memory stage
constexpr int RM = 8;    // rows per thread
constexpr int TC = 16;   // thread columns; a thread owns columns tc + TC*j
constexpr int NT = (BM / RM) * TC;  // 256 threads

// acc += a[0:BM, 0:depth] . B[b_row0 : b_row0 + depth, col0 : col0 + BN],
// a row-major with leading dimension lda (lda % 4 == 0, 16-byte aligned),
// rows >= rows_valid of a, rows >= n of B and columns >= k of B as zero.
// depth % BK == 0.  Every thread of the block calls it with the same
// arguments.
template <int BN>
__device__ __forceinline__ void tile_product(
    const float* __restrict__ a, int rows_valid, int lda,
    const float* __restrict__ B, int64_t b_row0, int depth, int n, int k,
    int col0, float (&acc)[RM][BN / TC], float (&As)[BK][BM],
    float (&Bs)[BK][BN]) {
  constexpr int RN = BN / TC;
  const int tid = threadIdx.x;
  const int tr = tid / TC;
  const int tc = tid % TC;
  for (int kk = 0; kk < depth; kk += BK) {
    // A tile: BM rows x BK columns, two float4 per thread, stored transposed
#pragma unroll
    for (int t = 0; t < (BM * BK) / (4 * NT); ++t) {
      const int i = tid + t * NT;
      const int r = i / (BK / 4);
      const int c = (i % (BK / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows_valid)
        v = *reinterpret_cast<const float4*>(a + (int64_t)r * lda + kk + c);
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
      const float av[RM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[RN];
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = Bs[q][tc + TC * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <int BN>
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           int64_t out_row0, int rows_valid,
                                           int k, int col0,
                                           const float (&acc)[RM][BN / TC]) {
  const int tr = threadIdx.x / TC;
  const int tc = threadIdx.x % TC;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = tr * RM + i;
    if (r >= rows_valid) continue;
    float* orow = out + (out_row0 + r) * k;
#pragma unroll
    for (int j = 0; j < BN / TC; ++j) {
      const int c = col0 + tc + TC * j;
      if (c < k) orow[c] = acc[i][j];
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(NT)
band_v2_kernel(const float* __restrict__ a_left,
               const float* __restrict__ a_right,
               const int32_t* __restrict__ iW, const float* __restrict__ B,
               float* __restrict__ out, int TM, int W, int n, int k) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int panel = blockIdx.x;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.z * BN;
  float acc[RM][BN / TC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < BN / TC; ++j) acc[i][j] = 0.f;
  const int64_t tile = ((int64_t)panel * TM + row0) * W;
  const int64_t b_row0 = (int64_t)iW[panel] * W;
  tile_product<BN>(a_left + tile, TM - row0, W, B, b_row0, W, n, k, col0,
                   acc, As, Bs);
  tile_product<BN>(a_right + tile, TM - row0, W, B, b_row0 + W, W, n, k, col0,
                   acc, As, Bs);
  store_tile<BN>(out, (int64_t)panel * TM + row0, TM - row0, k, col0, acc);
}

template <int BN>
__global__ void __launch_bounds__(NT)
band_v1_kernel(const float* __restrict__ band, const int32_t* __restrict__ ws,
               const float* __restrict__ B, float* __restrict__ out, int TM,
               int W, int n, int k) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int panel = blockIdx.x;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.z * BN;
  float acc[RM][BN / TC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < BN / TC; ++j) acc[i][j] = 0.f;
  const float* tile = band + ((int64_t)panel * TM + row0) * W;
  const int64_t blk0 = ws[panel];
  for (int j = 0; j < W / 128; ++j)  // the TPU grid's second axis
    tile_product<BN>(tile + j * 128, TM - row0, W, B, (blk0 + j) * 128, 128,
                     n, k, col0, acc, As, Bs);
  store_tile<BN>(out, (int64_t)panel * TM + row0, TM - row0, k, col0, acc);
}

}  // namespace

#define FLEX_BAND_DISPATCH(KERNEL, ...)                                     \
  do {                                                                      \
    if (k <= 32) {                                                          \
      const dim3 grid(P, (TM + BM - 1) / BM, (k + 31) / 32);                \
      KERNEL<32><<<grid, NT, 0, st>>>(__VA_ARGS__);                         \
    } else if (k <= 64) {                                                   \
      const dim3 grid(P, (TM + BM - 1) / BM, (k + 63) / 64);                \
      KERNEL<64><<<grid, NT, 0, st>>>(__VA_ARGS__);                         \
    } else {                                                                \
      const dim3 grid(P, (TM + BM - 1) / BM, (k + 127) / 128);              \
      KERNEL<128><<<grid, NT, 0, st>>>(__VA_ARGS__);                        \
    }                                                                       \
  } while (0)

// Both need W % 128 == 0 and 16-byte aligned band arrays (the wrappers
// check).  out is (P*TM, k).  Each returns its launch's cudaError_t.
extern "C" int flex_band_spmm_v2(const float* a_left, const float* a_right,
                                 const int32_t* iW, const float* B, float* out,
                                 int P, int TM, int W, int n, int k,
                                 void* stream) {
  if (P == 0 || TM == 0 || k == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLEX_BAND_DISPATCH(band_v2_kernel, a_left, a_right, iW, B, out, TM, W, n, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flex_band_spmm_v1(const float* band, const int32_t* ws,
                                 const float* B, float* out, int P, int TM,
                                 int W, int n, int k, void* stream) {
  if (P == 0 || TM == 0 || k == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLEX_BAND_DISPATCH(band_v1_kernel, band, ws, B, out, TM, W, n, k);
  return static_cast<int>(cudaGetLastError());
}
