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
// real slots by block id, so the slots of one block of B (one rank) are
// consecutive.  A block of B met by many panels makes a long chain of slots
// (on the reddit_posts main path 11 / 223 / 414 slots at p50 / p99 / max
// over 47,238), and a CUDA block that owned a whole chain left the card idle
// behind the longest.  So the host cuts every rank's slot range into units
// of a few slots (ops/window_spmm.py:work_units), and one block owns one
// (unit, 128-row tile of W, column tile).  A rank with one unit writes its
// output tile; the units of a longer chain write partial tiles into scratch,
// and flex_window_bwd_gB_reduce adds a rank's partials in unit order and
// writes the output once: a fixed order, no atomics, no zero-init pass, the
// same bits on every launch.  The contraction runs over TM; a row of the A
// tile is already W-contiguous, so the stage enters shared memory as it lies
// (16 bytes a copy).  The result is rank-indexed ([n_blk_used*W, k]); the
// caller scatters it to B's rows.
//
// Bound: each window does 2*TM*W*k FMA-operations against TM*W*4 bytes of A
// read (g_B) or written (g_A): 64 flop/byte at k=128, above the FP32 ridge of
// an H100 (67 TFLOP/s over 3.35 TB/s = 20 flop/byte), so the FP32 CUDA cores
// bound both.  g_A is a shared-memory-tiled SGEMM with an 8x8 register tile
// per thread.  g_B shares the forward's pieces (csrc/window_tile.cuh): equal
// units keep every SM busy, the column tile follows k (32, 48, 64 or 128
// columns, so k = 41 does the FMAs of 48), and a three-stage cp.async ring
// keeps the next loads in flight under the FMAs with one barrier per
// 16-deep stage.  Exact f32 FMA throughout: no TF32, no split precision.

#include "window_tile.cuh"

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

namespace fw = flex_window;

// units[u] = (rank, t_lo, t_hi, part): sorted slots t_lo .. t_hi - 1 of block
// rank `rank`; part < 0 writes the tile of `out`, else tile `part` of
// `scratch`.
template <int CN, bool VEC16>
__global__ void __launch_bounds__(fw::NT, 2)
window_bwd_gB_kernel(const float* __restrict__ A, const float* __restrict__ g,
                     const int32_t* __restrict__ slot_s,
                     const int32_t* __restrict__ slot_g,
                     const int32_t* __restrict__ units,
                     const int32_t* __restrict__ out_panel,
                     float* __restrict__ out, float* __restrict__ scratch,
                     int TM, int G, int W, int k) {
  constexpr int TN = CN * fw::TC;                // output columns per block
  constexpr int A_FLOATS = fw::BK * fw::BM;      // A tile rows, [tm][w]
  constexpr int STAGE_FLOATS = A_FLOATS + fw::BK * TN;  // + cotangent [tm][k]
  extern __shared__ __align__(16) float smem[];

  const int row0 = blockIdx.y * fw::BM;  // within W
  const int col0 = blockIdx.z * TN;      // within k
  const int tid = threadIdx.x;
  const int tr = tid / fw::TC;
  const int tc = tid % fw::TC;
  const int GW = G * W;
  const int t_lo = units[4 * blockIdx.x + 1];
  const int t_hi = units[4 * blockIdx.x + 2];

  float acc[fw::RM][CN];
#pragma unroll
  for (int i = 0; i < fw::RM; ++i)
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[i][c] = 0.f;

  const int per_slot = (TM + fw::BK - 1) / fw::BK;
  const int T = (t_hi - t_lo) * per_slot;

  // the loads run STAGES - 1 stages ahead of the FMAs; every thread keeps
  // the same cursor (slot, depth within TM)
  int cur = t_lo;
  int cur_q0 = 0;
  auto load_stage = [&](int buf) {
    float* As = smem + buf * STAGE_FLOATS;
    const int s = slot_s[cur];
    // 64-bit: S*TM*GW ~ 1.6e9 floats on the main path
    fw::load_a_depthmajor(
        As,
        A + ((int64_t)s * TM + cur_q0) * GW + slot_g[cur] * W + row0, GW,
        TM - cur_q0, W - row0, tid);
    fw::load_rows<TN, VEC16>(As + A_FLOATS,
                             g + (int64_t)out_panel[s] * TM * k, cur_q0, TM, k,
                             col0, tid);
    cur_q0 += fw::BK;
    if (cur_q0 >= TM) {
      cur_q0 = 0;
      ++cur;
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
    fw::fma_stage_depthmajor<CN>(As, As + A_FLOATS, tr, tc, acc);
  }

  // every element of the tile is written exactly once
  const int rank = units[4 * blockIdx.x];
  const int part = units[4 * blockIdx.x + 3];
  float* tile = part < 0 ? out + ((int64_t)rank * W + row0) * k
                         : scratch + ((int64_t)part * W + row0) * k;
  fw::store_tile<fw::RM, CN, fw::TC, false, VEC16>(tile, W - row0, k, col0, tr,
                                                   tc, acc);
}

template <int CN, bool VEC16>
int launch_gB(const float* A, const float* g, const int32_t* slot_s,
              const int32_t* slot_g, const int32_t* units,
              const int32_t* out_panel, float* out, float* scratch,
              int n_units, int TM, int G, int W, int k, cudaStream_t st) {
  constexpr int TN = CN * fw::TC;
  constexpr int SMEM = fw::STAGES * (fw::BK * fw::BM + fw::BK * TN) * 4;
  const int err = fw::allow_smem(window_bwd_gB_kernel<CN, VEC16>, SMEM);
  if (err) return err;
  const dim3 grid(n_units, (W + fw::BM - 1) / fw::BM, (k + TN - 1) / TN);
  window_bwd_gB_kernel<CN, VEC16><<<grid, fw::NT, SMEM, st>>>(
      A, g, slot_s, slot_g, units, out_panel, out, scratch, TM, G, W, k);
  return static_cast<int>(cudaGetLastError());
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

// A 16-byte aligned, W % 16 == 0 (the wrapper checks).  units is
// int32[n_units][4]; scratch holds the partial tiles, (W, k) each.
extern "C" int flex_window_bwd_gB(const float* A, const float* g,
                                  const int32_t* slot_s, const int32_t* slot_g,
                                  const int32_t* units,
                                  const int32_t* out_panel, float* out,
                                  float* scratch, int n_units, int TM, int G,
                                  int W, int k, void* stream) {
  if (n_units == 0 || k == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
#define FLEX_GB(RN)                                                          \
  (vec ? launch_gB<RN, true>(A, g, slot_s, slot_g, units, out_panel, out,    \
                             scratch, n_units, TM, G, W, k, st)              \
       : launch_gB<RN, false>(A, g, slot_s, slot_g, units, out_panel, out,   \
                              scratch, n_units, TM, G, W, k, st))
  if (k <= 32) return FLEX_GB(2);
  if (k <= 48) return FLEX_GB(3);
  if (k <= 64) return FLEX_GB(4);
  return FLEX_GB(8);
#undef FLEX_GB
}

// out tile of rank splits[i][0] = scratch tiles splits[i][1] ..
// splits[i][2] - 1 added in that order; a tile is W*k floats.
extern "C" int flex_window_bwd_gB_reduce(const float* scratch, float* out,
                                         const int32_t* splits, int n_splits,
                                         int tile_elems, void* stream) {
  return fw::launch_reduce_partials(scratch, out, splits, n_splits, tile_elems,
                                    static_cast<cudaStream_t>(stream));
}
