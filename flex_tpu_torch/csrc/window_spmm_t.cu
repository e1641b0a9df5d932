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
// order and carry nothing, and panels differ widely in length (6 / 98 / 191
// steps at p50 / p99 / max on the reddit_posts main path), so as in
// window_spmm.cu the host cuts every panel's step range into units of a few
// steps (ops/window_spmm.py:work_units, the plan's panel_units) and one block
// owns one (unit, BR panel rows, KC rows of k) tile.  A panel with one unit
// writes its tile of outT; the units of a longer panel write partial (k, TM)
// tiles into scratch, and flex_window_spmm_t_reduce adds a panel's partials
// in unit order and writes its tile of outT once (k rows of TM floats,
// n_panels*TM apart): a fixed order, no atomics, no zero-init pass, the same
// bits on every launch.  A panel without steps has one empty unit and gets
// zeros.  Sentinel windows (id nblk) are skipped by the load cursor and BT
// columns >= n read as zero, so BT needs no padded copy.
//
// Bound: the block reads TM*W*4 bytes of AT per window for 2*TM*W*k
// operations, k/2 flop per byte: at k = 41 that is 20.5, about the FP32
// ridge of an H100 (67 TFLOP/s over 3.35 TB/s = 20 flop/byte), and at
// k = 32 below it.  So the work scales with k: the tile over k is KC = 32,
// 48 or 64 rows, picked from k (k = 41 runs one 48-row tile, k = 32 one
// 32-row tile, k > 64 several 64-row tiles); with k <= 64 every byte of AT
// is read exactly once.  A block is 256 threads over BR = 256 panel rows
// (128 when TM <= 128, and for the 64-row tile, whose 8 x 8 sums a thread
// did not hold in 128 registers without spilling), a thread 8 panel rows
// by KC / 8 or KC / 16 rows of k.
//
// Shared memory: the three-stage cp.async ring of csrc/window_tile.cuh, 16
// deep a stage, so the next two stages' loads are in flight under the FMAs
// with one barrier a stage.  AT[s] rows are TM-contiguous, and TM is the
// output's contiguous axis, so the AT stage goes in as it lies, [w][r], 16
// bytes a copy (TM % 4 == 0 and a 16-byte aligned base).  BT rows are
// n-contiguous, the contraction axis, and n is any number, so the BT stage
// takes the 4-byte copies; cp.async cannot transpose, so it too lies as it
// is, [c][w], rows padded to 20 floats, and a thread reads it along w,
// four contraction steps a load.  A warp holds one row group tk of k
// (BR = 256) or two, one per half-warp (BR = 128), so its reads of BT are
// broadcasts.  Exact f32 FMA throughout: no TF32, no split precision.

#include "window_tile.cuh"

namespace {

namespace fw = flex_window;

constexpr int RR = 8;            // panel rows per thread: two runs of 4, BR/2 apart
constexpr int LDB = fw::BK + 4;  // BT stage row stride: float4 reads stay aligned

// acc[i][j] += sum over the stage's depth q of Bs[tk*RK + i][q] * As[q][r_j]
template <int RK, int BR>
__device__ __forceinline__ void fma_stage_t(const float* __restrict__ As,
                                            const float* __restrict__ Bs,
                                            int tr, int tk,
                                            float (&acc)[RK][RR]) {
#pragma unroll
  for (int q0 = 0; q0 < fw::BK; q0 += 4) {
    float b[RK][4];  // four contraction steps per read of BT
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const float4 v =
          *reinterpret_cast<const float4*>(Bs + (tk * RK + i) * LDB + q0);
      b[i][0] = v.x, b[i][1] = v.y, b[i][2] = v.z, b[i][3] = v.w;
    }
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const float* arow = As + (q0 + qq) * BR;
      const float4 a0 = *reinterpret_cast<const float4*>(arow + tr * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(arow + BR / 2 + tr * 4);
      const float a[RR] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < RR; ++j) acc[i][j] = fmaf(b[i][qq], a[j], acc[i][j]);
    }
  }
}

// units[u] = (panel, s_lo, s_hi, part): steps s_lo .. s_hi - 1 of `panel`;
// part < 0 writes the panel's tile of outT, else partial tile `part` of
// scratch, (k, TM) contiguous.  256 threads: BR / RR thread columns along
// the panel rows, TK thread rows along k, RK = KC / TK rows of k each.
template <int KC, int BR>
__global__ void __launch_bounds__(fw::NT, 2)
window_spmm_t_kernel(const float* __restrict__ AT, const float* __restrict__ BT,
                     const int32_t* __restrict__ win_step,
                     const int32_t* __restrict__ units,
                     float* __restrict__ outT, float* __restrict__ scratch,
                     int TM, int G, int W, int n, int k, int nblk,
                     int64_t ldc) {
  constexpr int NT = fw::NT;
  constexpr int TK = NT / (BR / RR);  // 8 at BR = 256, 16 at BR = 128
  constexpr int RK = KC / TK;         // rows of k per thread
  constexpr int A_FLOATS = fw::BK * BR;
  constexpr int STAGE_FLOATS = A_FLOATS + KC * LDB;
  static_assert(KC % TK == 0 && (A_FLOATS * 4) % 16 == 0, "tile shape");
  extern __shared__ __align__(16) float smem[];

  const int row0 = blockIdx.y * BR;
  const int c0 = blockIdx.z * KC;
  const int tid = threadIdx.x;
  const int tr = tid % (BR / RR);  // panel rows tr*4 .. +3 and BR/2 + tr*4 .. +3
  const int tk = tid / (BR / RR);  // rows of k: tk*RK .. tk*RK + RK-1
  const int64_t GW = (int64_t)G * W;
  const int slot_lo = units[4 * blockIdx.x + 1] * G;
  const int slot_hi = units[4 * blockIdx.x + 2] * G;

  float acc[RK][RR];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < RR; ++j) acc[i][j] = 0.f;

  // the unit's real windows, W / BK stages each
  int n_real = 0;
  for (int base = slot_lo; base < slot_hi; base += NT) {
    const int sl = base + tid;
    n_real += __syncthreads_count(sl < slot_hi && win_step[sl] < nblk);
  }
  const int T = n_real * (W / fw::BK);

  // the loads run STAGES - 1 stages ahead of the FMAs; every thread keeps
  // the same cursor (window slot, depth within the window)
  const float* bt_rows = BT + (int64_t)c0 * n;
  int cur = slot_lo;
  while (cur < slot_hi && win_step[cur] >= nblk) ++cur;
  int cur_kk = 0;
  auto load_stage = [&](int buf) {
    float* As = smem + buf * STAGE_FLOATS;
    const int s = cur / G;
    const int g = cur % G;
    // 64-bit: S*GW*TM ~ 1.6e9 floats on the main path
    fw::load_a_depthmajor<BR, NT>(
        As, AT + ((int64_t)s * GW + g * W + cur_kk) * TM + row0, TM, fw::BK,
        TM - row0, tid);
    const int64_t col = (int64_t)win_step[cur] * W + cur_kk;
    fw::load_rows4<KC, fw::BK, LDB, NT>(As + A_FLOATS, bt_rows + col, n,
                                        k - c0, n - col, tid);
    cur_kk += fw::BK;
    if (cur_kk == W) {
      cur_kk = 0;
      ++cur;
      while (cur < slot_hi && win_step[cur] >= nblk) ++cur;
    }
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
    fma_stage_t<RK, BR>(As, As + A_FLOATS, tr, tk, acc);
  }

  // every element of the tile is written exactly once, float4 along the
  // panel rows (TM % 4 == 0 keeps them aligned)
  const int panel = units[4 * blockIdx.x];
  const int part = units[4 * blockIdx.x + 3];
  float* tile = part < 0 ? outT + (int64_t)panel * TM
                         : scratch + (int64_t)part * k * TM;
  const int64_t ld = part < 0 ? ldc : TM;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int c = c0 + tk * RK + i;
    if (c >= k) continue;
    float* orow = tile + c * ld;
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
           const int32_t* units, float* outT, float* scratch, int n_units,
           int n_panels, int TM, int G, int W, int n, int k, int nblk,
           cudaStream_t stream) {
  constexpr int SMEM = fw::STAGES * (fw::BK * BR + KC * LDB) * 4;
  const int err = fw::allow_smem(window_spmm_t_kernel<KC, BR>, SMEM);
  if (err) return err;
  const dim3 grid(n_units, (TM + BR - 1) / BR, (k + KC - 1) / KC);
  window_spmm_t_kernel<KC, BR><<<grid, fw::NT, SMEM, stream>>>(
      AT, BT, win_step, units, outT, scratch, TM, G, W, n, k, nblk,
      (int64_t)n_panels * TM);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Needs W % 16 == 0, TM % 4 == 0 and 16-byte aligned AT, outT and scratch
// (the wrapper checks).  units is int32[n_units][4]; scratch holds the
// partial tiles, (k, TM) each.  Returns the launch's cudaError_t.
extern "C" int flex_window_spmm_t_fwd(const float* AT, const float* BT,
                                      const int32_t* win_step,
                                      const int32_t* units, float* outT,
                                      float* scratch, int n_units,
                                      int n_panels, int TM, int G, int W,
                                      int n, int k, int nblk, void* stream) {
  if (n_units == 0 || k == 0 || TM == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLEX_T_LAUNCH(KC)                                                   \
  return TM > 128 ? launch<KC, 256>(AT, BT, win_step, units, outT, scratch, \
                                    n_units, n_panels, TM, G, W, n, k,      \
                                    nblk, st)                               \
                  : launch<KC, 128>(AT, BT, win_step, units, outT, scratch, \
                                    n_units, n_panels, TM, G, W, n, k,      \
                                    nblk, st)
  if (k <= 32) { FLEX_T_LAUNCH(32); }
  if (k <= 48) { FLEX_T_LAUNCH(48); }
#undef FLEX_T_LAUNCH
  // 64 rows of k a tile: 128 panel rows, so a thread holds 4 x 8 sums
  return launch<64, 128>(AT, BT, win_step, units, outT, scratch, n_units,
                         n_panels, TM, G, W, n, k, nblk, st);
}

// the tile of outT of panel splits[i][0] (k rows of TM floats, n_panels*TM
// apart) = scratch tiles splits[i][1] .. splits[i][2] - 1 added in that
// order; a scratch tile is k*TM floats.
extern "C" int flex_window_spmm_t_reduce(const float* scratch, float* outT,
                                         const int32_t* splits, int n_splits,
                                         int n_panels, int TM, int k,
                                         void* stream) {
  return fw::launch_reduce_partials_strided(
      scratch, outT, splits, n_splits, TM, k, (int64_t)n_panels * TM,
      static_cast<cudaStream_t>(stream));
}
