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
// A panel's steps are consecutive.  The TPU grid ran step after step and
// carried the panel sum in its output block; CUDA blocks run in no order and
// carry nothing.  Panels differ widely in length (on the reddit_posts main
// path 6 / 98 / 191 steps at p50 / p99 / max over 911 panels), so a block
// that owned a whole panel left the card idle behind the longest one.  Here
// the host cuts every panel's step range into units of a few steps
// (ops/window_spmm.py:work_units), and one block owns one (unit, 128-row
// tile, column tile).  A panel with one unit writes its output tile; the
// units of a longer panel write partial tiles into scratch, and
// flex_window_spmm_reduce adds a panel's partials in unit order and writes
// the output once: a fixed order, no atomics, no zero-init pass, the same
// bits on every launch.  A panel without steps has one empty unit and gets
// zeros.  Windows whose id is the sentinel nblk are skipped, and B rows >= n
// read as zero, so no padded copy of B is made.
//
// Bound: at the main-path shapes (TM=256, G=4, W=128, k=128, 47,238 real
// windows) a block does 2*TM*W*k operations per window against TM*W*4 bytes
// of A, i.e. 64 flop/byte: above the FP32 ridge of an H100 (67 TFLOP/s over
// 3.35 TB/s = 20 flop/byte), so the FP32 CUDA cores bound it.  What the
// design does about it (csrc/window_tile.cuh): equal units keep every SM
// busy; the column tile follows k (32, 48, 64 or 128 columns), so k = 41
// does the FMAs of 48 columns, not of 128; a three-stage cp.async ring keeps
// the next loads in flight under the FMAs with one barrier per 16-deep
// stage; the A tile enters shared memory as it lies (row-major, 16 bytes a
// copy) and a thread (4 rows x up to 16 columns) reads it four contraction
// steps at a time.  Exact f32 FMA throughout: no TF32, no split precision
// (a 3 x TF32 tensor-core product was tried and not adopted, see
// csrc/window_tile.cuh).

#include "window_tile.cuh"

namespace {

using namespace flex_window;

// units[u] = (panel, s_lo, s_hi, part): steps s_lo .. s_hi - 1 of `panel`;
// part < 0 writes the tile of `out`, else tile `part` of `scratch`.
template <int RN, bool VEC16>
__global__ void __launch_bounds__(NT, 2)
window_spmm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   const int32_t* __restrict__ win_step,
                   const int32_t* __restrict__ units, float* __restrict__ out,
                   float* __restrict__ scratch, int TM, int G, int W, int n,
                   int k, int nblk) {
  constexpr int BN = RN * TC;
  constexpr int A_FLOATS = BM * (BK + APAD);
  constexpr int STAGE_FLOATS = A_FLOATS + BK * BN;
  extern __shared__ __align__(16) float smem[];

  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.z * BN;
  const int tid = threadIdx.x;
  const int tr = tid / FTC;  // 0..31
  const int tc = tid % FTC;  // 0..7
  const int GW = G * W;
  const int slot_lo = units[4 * blockIdx.x + 1] * G;
  const int slot_hi = units[4 * blockIdx.x + 2] * G;

  float acc[FR][2 * RN];
#pragma unroll
  for (int i = 0; i < FR; ++i)
#pragma unroll
    for (int j = 0; j < 2 * RN; ++j) acc[i][j] = 0.f;

  // the unit's real windows, W / BK stages each
  int n_real = 0;
  for (int base = slot_lo; base < slot_hi; base += NT) {
    const int sl = base + tid;
    n_real += __syncthreads_count(sl < slot_hi && win_step[sl] < nblk);
  }
  const int T = n_real * (W / BK);

  // the loads run STAGES - 1 stages ahead of the FMAs; every thread keeps
  // the same cursor (window slot, depth within the window)
  int cur = slot_lo;
  while (cur < slot_hi && win_step[cur] >= nblk) ++cur;
  int cur_kk = 0;
  auto load_stage = [&](int buf) {
    float* As = smem + buf * STAGE_FLOATS;
    const int s = cur / G;
    const int g = cur % G;
    // 64-bit: S*TM*GW ~ 1.6e9 floats on the main path
    load_a_rowmajor(As,
                    A + ((int64_t)s * TM + row0) * GW + g * W + cur_kk, GW,
                    TM - row0, tid);
    load_rows<BN, VEC16>(As + A_FLOATS, B,
                         (int64_t)win_step[cur] * W + cur_kk, n, k, col0, tid);
    cur_kk += BK;
    if (cur_kk == W) {
      cur_kk = 0;
      ++cur;
      while (cur < slot_hi && win_step[cur] >= nblk) ++cur;
    }
  };

  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < T) load_stage(st);
    cp_async_commit();
  }
  for (int t = 0; t < T; ++t) {
    cp_async_wait<STAGES - 2>();  // stage t has landed (this thread's part)
    __syncthreads();              // ... and everyone's; stage t - 1 is free
    if (t + STAGES - 1 < T) load_stage((t + STAGES - 1) % STAGES);
    cp_async_commit();
    const float* As = smem + (t % STAGES) * STAGE_FLOATS;
    fma_stage_rowmajor<RN>(As, As + A_FLOATS, tr, tc, acc);
  }

  // every element of the tile is written exactly once
  const int panel = units[4 * blockIdx.x];
  const int part = units[4 * blockIdx.x + 3];
  float* tile = part < 0 ? out + ((int64_t)panel * TM + row0) * k
                         : scratch + ((int64_t)part * TM + row0) * k;
  store_tile<FR, 2 * RN, FTC, true, VEC16>(tile, TM - row0, k, col0, tr, tc,
                                         acc);
}

template <int RN, bool VEC16>
int launch(const float* A, const float* B, const int32_t* win_step,
           const int32_t* units, float* out, float* scratch, int n_units,
           int TM, int G, int W, int n, int k, int nblk, cudaStream_t st) {
  constexpr int BN = RN * TC;
  constexpr int SMEM = STAGES * (BM * (BK + APAD) + BK * BN) * 4;
  const int err = allow_smem(window_spmm_kernel<RN, VEC16>, SMEM);
  if (err) return err;
  const dim3 grid(n_units, (TM + BM - 1) / BM, (k + BN - 1) / BN);
  window_spmm_kernel<RN, VEC16><<<grid, NT, SMEM, st>>>(
      A, B, win_step, units, out, scratch, TM, G, W, n, k, nblk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A 16-byte aligned, W % 16 == 0 (the wrapper checks).  units is
// int32[n_units][4]; scratch holds the partial tiles, (TM, k) each.
extern "C" int flex_window_spmm_fwd(const float* A, const float* B,
                                    const int32_t* win_step,
                                    const int32_t* units, float* out,
                                    float* scratch, int n_units, int TM, int G,
                                    int W, int n, int k, int nblk,
                                    void* stream) {
  if (n_units == 0 || k == 0 || TM == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
#define FLEX_FWD(RN)                                                        \
  (vec ? launch<RN, true>(A, B, win_step, units, out, scratch, n_units, TM, \
                          G, W, n, k, nblk, st)                             \
       : launch<RN, false>(A, B, win_step, units, out, scratch, n_units,    \
                           TM, G, W, n, k, nblk, st))
  if (k <= 32) return FLEX_FWD(2);
  if (k <= 48) return FLEX_FWD(3);
  if (k <= 64) return FLEX_FWD(4);
  return FLEX_FWD(8);
#undef FLEX_FWD
}

// out tile of panel splits[i][0] = scratch tiles splits[i][1] ..
// splits[i][2] - 1 added in that order; a tile is TM*k floats.
extern "C" int flex_window_spmm_reduce(const float* scratch, float* out,
                                       const int32_t* splits, int n_splits,
                                       int tile_elems, void* stream) {
  return launch_reduce_partials(scratch, out, splits, n_splits, tile_elems,
                                static_cast<cudaStream_t>(stream));
}
