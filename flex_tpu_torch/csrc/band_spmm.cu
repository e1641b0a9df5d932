// Band SpMM for Hopper (sm_90a), plain C interface: two entry points, one
// per band format of flex_tpu/ops/pallas_band.py, on one kernel body.
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
// Neither gathers, and both are one product against one contiguous range
// of B: the two halves of v2 meet B[iW*W : iW*W + 2W], so the split band
// is a product of depth 2W; the chunks of v1 meet B[ws*128 : ws*128 + W],
// a product of depth W.  Depth d is column d of the band (of A_left below
// W, of A_right from W on) against B row b0 + d, b0 = iW*W or ws*128.  The
// TPU v2 grid ran one step per panel; its v1 grid ran (P, W/128) steps and
// revisited the panel's output block over j.  CUDA blocks run in no order
// and carry nothing, so one block owns one (panel, 128-row tile, column
// tile) of the output, does all of the tile's products itself and writes it
// once: no atomics, no zero-init.  Rows of B >= n read as zero, so B needs
// no padded copy (the TPU code pads B by up to two windows), and rows of a
// panel >= TM are masked, so TM is any positive number.
//
// Bound: a block does 2*TM*depth*k operations per TM*depth*4 bytes of
// band, k/2 flop per byte: 64 at k = 128, above the FP32 ridge of an H100
// (67 TFLOP/s over 3.35 TB/s = 20 flop/byte), so the FP32 CUDA cores bound
// both.  Exact f32 FMA: no TF32, no split precision.
//
// The kernel is built so as not to do the FMAs of zeros: the nonzeros of a
// 128-row tile of a band lie in one depth range [lo, hi); on
// banded_graph(262144, 256, 64) with W = 768, at most 640 of the split
// band's 1536 columns, and about 640 of the unsplit band's 768.  The host
// finds each tile's range once per plan (ops/pallas_band.py:
// band_depth_ranges, multiples of the 16-deep stage) and the block loops
// over that range alone.  The loop is the three-stage cp.async ring of
// csrc/window_tile.cuh (A row-major by 16-byte copies, B rows by 16- or
// 4-byte copies, zero fill by source size 0), with the forward window
// kernel's register tile: 4 rows x 2*RN columns a thread, a column tile of
// 32, 48, 64 or 128 picked from k.  An all-zero tile has an empty range and
// writes zeros.  The 128-column tile with 16-byte rows of B (k > 64,
// k % 4 == 0) holds 128 registers and spills 12 bytes; on an H100 that
// variant ran as fast as one that spilled 20, so the spill is left.

#include "window_tile.cuh"

namespace {

namespace fw = flex_window;

// ranges[(panel * gridDim.y + tile) * 2 + {0, 1}] = [lo, hi), the depth
// range of [A_left | A_right] (2W columns; v1: of the band, W columns, and
// a_right is not read) that holds the tile's nonzeros; lo and hi are
// multiples of BK.  Depth d meets B row table[panel] * b_unit + d.
template <int RN, bool VEC16>
__global__ void __launch_bounds__(fw::NT, 2)
band_kernel(const float* __restrict__ a_left,
            const float* __restrict__ a_right,
            const int32_t* __restrict__ table, int b_unit,
            const int32_t* __restrict__ ranges,
            const float* __restrict__ B, float* __restrict__ out, int TM,
            int W, int n, int k) {
  constexpr int BN = RN * fw::TC;
  constexpr int A_FLOATS = fw::BM * (fw::BK + fw::APAD);
  constexpr int STAGE_FLOATS = A_FLOATS + fw::BK * BN;
  extern __shared__ __align__(16) float smem[];

  const int panel = blockIdx.x;
  const int row0 = blockIdx.y * fw::BM;
  const int col0 = blockIdx.z * BN;
  const int tid = threadIdx.x;
  const int tr = tid / fw::FTC;  // 0..31
  const int tc = tid % fw::FTC;  // 0..7
  const int64_t range = ((int64_t)panel * gridDim.y + blockIdx.y) * 2;
  const int lo = ranges[range];
  const int hi = ranges[range + 1];
  const int T = hi > lo ? (hi - lo) / fw::BK : 0;

  float acc[fw::FR][2 * RN];
#pragma unroll
  for (int i = 0; i < fw::FR; ++i)
#pragma unroll
    for (int j = 0; j < 2 * RN; ++j) acc[i][j] = 0.f;

  // depth d is column d of a_l below W and column d of a_r from W on; it
  // meets row d of b_rows (rows >= b_limit read as zero)
  const int64_t tile = ((int64_t)panel * TM + row0) * W;
  const float* a_l = a_left + tile;
  const float* a_r = a_right + tile - W;
  const int64_t b_row0 = (int64_t)table[panel] * b_unit;
  const float* b_rows = B + b_row0 * k;
  const int64_t b_limit = n - b_row0;
  int d = lo;
  auto load_stage = [&](int buf) {
    float* As = smem + buf * STAGE_FLOATS;
    fw::load_a_rowmajor(As, (d < W ? a_l : a_r) + d, W, TM - row0, tid);
    fw::load_rows<BN, VEC16>(As + A_FLOATS, b_rows, d, b_limit, k, col0, tid);
    d += fw::BK;
  };

  for (int st = 0; st < fw::STAGES - 1; ++st) {
    if (st < T) load_stage(st);
    fw::cp_async_commit();
  }
  for (int t = 0; t < T; ++t) {
    fw::cp_async_wait<fw::STAGES - 2>();  // stage t has landed (my part)
    __syncthreads();                      // ... and everyone's; t - 1 is free
    if (t + fw::STAGES - 1 < T) load_stage((t + fw::STAGES - 1) % fw::STAGES);
    fw::cp_async_commit();
    const float* As = smem + (t % fw::STAGES) * STAGE_FLOATS;
    fw::fma_stage_rowmajor<RN>(As, As + A_FLOATS, tr, tc, acc);
  }

  // every element of the tile is written exactly once
  fw::store_tile<fw::FR, 2 * RN, fw::FTC, true, VEC16>(
      out + ((int64_t)panel * TM + row0) * k, TM - row0, k, col0, tr, tc, acc);
}

template <int RN, bool VEC16>
int launch_rn(const float* a_left, const float* a_right, const int32_t* table,
              int b_unit, const int32_t* ranges, const float* B, float* out,
              int P, int TM, int W, int n, int k, cudaStream_t st) {
  constexpr int BN = RN * fw::TC;
  constexpr int SMEM =
      fw::STAGES * (fw::BM * (fw::BK + fw::APAD) + fw::BK * BN) * 4;
  const int err = fw::allow_smem(band_kernel<RN, VEC16>, SMEM);
  if (err) return err;
  const dim3 grid(P, (TM + fw::BM - 1) / fw::BM, (k + BN - 1) / BN);
  band_kernel<RN, VEC16><<<grid, fw::NT, SMEM, st>>>(
      a_left, a_right, table, b_unit, ranges, B, out, TM, W, n, k);
  return static_cast<int>(cudaGetLastError());
}

// the column tile from k, the copy width from k and B's alignment
int launch(const float* a_left, const float* a_right, const int32_t* table,
           int b_unit, const int32_t* ranges, const float* B, float* out,
           int P, int TM, int W, int n, int k, void* stream) {
  if (P == 0 || TM == 0 || k == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
#define FLEX_RN(RN)                                                          \
  (vec ? launch_rn<RN, true>(a_left, a_right, table, b_unit, ranges, B, out, \
                             P, TM, W, n, k, st)                             \
       : launch_rn<RN, false>(a_left, a_right, table, b_unit, ranges, B,     \
                              out, P, TM, W, n, k, st))
  if (k <= 32) return FLEX_RN(2);
  if (k <= 48) return FLEX_RN(3);
  if (k <= 64) return FLEX_RN(4);
  return FLEX_RN(8);
#undef FLEX_RN
}

}  // namespace

// Both need W % 128 == 0 and 16-byte aligned band arrays (the wrappers
// check).  out is (P*TM, k).  ranges is int32[P][ceil(TM/128)][2]
// (ops/pallas_band.py:band_depth_ranges).  Each returns its launch's
// cudaError_t.
extern "C" int flex_band_spmm_v2(const float* a_left, const float* a_right,
                                 const int32_t* iW, const int32_t* ranges,
                                 const float* B, float* out, int P, int TM,
                                 int W, int n, int k, void* stream) {
  return launch(a_left, a_right, iW, W, ranges, B, out, P, TM, W, n, k,
                stream);
}

extern "C" int flex_band_spmm_v1(const float* band, const int32_t* ws,
                                 const int32_t* ranges, const float* B,
                                 float* out, int P, int TM, int W, int n,
                                 int k, void* stream) {
  return launch(band, band, ws, 128, ranges, B, out, P, TM, W, n, k, stream);
}
