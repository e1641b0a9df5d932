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
// g_A: every (step, window) tile is independent and is written exactly once;
// there is no sum across steps, so no second pass.  One block owns one work
// unit of consecutive steps of one panel (the forward's plan.panel_units,
// ops/window_spmm.py:work_units; a table of one-step units gives the step
// grain) and 256 rows of TM.  All G windows of a step, and all steps of a
// unit, meet the same rows of the cotangent, so that tile is loaded once
// per block into shared memory and stays resident; a k beyond its cap (128)
// walks the depth in chunks of the cap, reloading the tile per chunk.  The
// W-row block of B that window j meets streams through two shared stages of
// 128 rows x 16 depths, fetched one stage ahead into registers by 16-byte
// reads and stored transposed after the FMAs, without a pause between the
// windows of the unit.  Both operands lie depth-major, so a thread's 8 x 16
// register tile takes an outer product per depth (2 + 4 float4 reads per
// 128 FMAs).  A sentinel window (id nblk) gets its zeros up front, without
// loads or FMAs; B rows >= n and depths >= k read as zero, so no padded
// copy of B is made.  The output is written once by float4 streaming
// stores (st.global.cs), so it does not evict g and B from L2; offsets are
// 64-bit (S*TM*G*W ~ 1.6e9 on the main path).  Each element sums over k in
// ascending order: the same bits on every launch and for every unit table.
//
// What was learned on an NVIDIA H100 80GB HBM3 at 700 W on the main path's
// tables: B staged by cp.async as it lies (k-contiguous rows, read four
// depths a float4) starved the register file, so nothing was prefetched;
// B transposed by 4-byte cp.async copies cost about a quarter of the
// kernel (the copies pass through L1, four lines a warp request); through
// registers it costs little.  An 8 x 16 tile at one block an SM beat 8 x 8
// at two (which spilled); a 32-deep stage spilled; the plan's units beat
// one step a block (a block's start costs some microseconds).  PERF.md has
// the times.
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
// bound both; at k=41 g_A's stores weigh as much as its FMAs.  g_B shares the
// forward's pieces (csrc/window_tile.cuh): equal units keep every SM busy,
// the column tile follows k (32, 48, 64 or 128 columns, so k = 41 does the
// FMAs of 48), and a three-stage cp.async ring keeps the next loads in
// flight under the FMAs with one barrier per 16-deep stage.  g_A's depth is
// k itself, in stages of 16 (k = 41 does the FMAs of 48).  Exact f32 FMA
// throughout: no TF32, no split precision.

#include "window_tile.cuh"

namespace {

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


// ---- g_A ------------------------------------------------------------------

constexpr int GA_RM = 8;                // rows a thread
constexpr int GA_RN = 16;               // columns a thread, four runs of 4
constexpr int GA_TC = 8;                // thread columns
constexpr int GA_TR = fw::NT / GA_TC;   // thread rows
constexpr int GA_BM = GA_TR * GA_RM;    // rows of TM a block: 256
constexpr int GA_BN = GA_TC * GA_RN;    // columns of a window a tile: 128
constexpr int GA_KC = 128;              // resident depth of the cotangent tile
constexpr int GA_LDA = GA_BM + 4;       // row strides of the depth-major
constexpr int GA_LDB = GA_BN + 4;       // resident tile and of a B stage
constexpr int GA_STAGE = fw::BK * GA_LDB;
constexpr int GA_SMEM = (GA_KC * GA_LDA + 2 * GA_STAGE) * 4;
static_assert(GA_BN == 128 && fw::NT == 256,
              "a B stage is 16 rows of 16 depths a warp");

// depth of the resident cotangent tile: k up to the cap, in whole stages
__device__ __forceinline__ int ga_depth(int k) {
  const int d = (k + fw::BK - 1) / fw::BK * fw::BK;
  return d < fw::BK ? fw::BK : (d > GA_KC ? GA_KC : d);
}

// A B stage (128 rows x 16 depths) passes through registers on its way to
// shared memory, where it lies depth-major.  Thread (warp w, lane l) holds
// row c = 16 w + l % 16 at depths q0 .. q0 + 3 and q0 + 8 .. q0 + 11,
// q0 = 4 (l / 16): a warp's reads are 16 rows x 32 bytes (whole sectors),
// its transposed stores 32 banks at once.  VEC16: k % 4 == 0 and the rows
// 16-byte aligned, two 16-byte reads; else eight 4-byte reads.
template <bool VEC16>
__device__ __forceinline__ void ga_fetch(float (&rb)[8],
                                         const float* __restrict__ rows_b,
                                         int rows, int kk, int k, int tid) {
  const int c = tid / 32 * 16 + tid % 16;
  const int q0 = kk + 4 * (tid % 32 / 16);
  const float* src = rows_b + (int64_t)c * k + q0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q0 + 8 * h;
    if constexpr (VEC16) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < rows && q < k)
        v = __ldcg(reinterpret_cast<const float4*>(src + 8 * h));
      rb[4 * h] = v.x, rb[4 * h + 1] = v.y, rb[4 * h + 2] = v.z,
             rb[4 * h + 3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rb[4 * h + e] = c < rows && q + e < k ? __ldcg(src + 8 * h + e) : 0.f;
    }
  }
}

// ... and its transposed store: dst[q * LD + c] (LD % 32 == 4)
template <int LD>
__device__ __forceinline__ void ga_put(float* dst, const float (&rb)[8],
                                       int tid) {
  const int c = tid / 32 * 16 + tid % 16;
  const int q0 = 4 * (tid % 32 / 16);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dst[(q0 + 8 * h + e) * LD + c] = rb[4 * h + e];
}

// units[u] = (panel, s_lo, s_hi, part): steps s_lo .. s_hi - 1; block b
// owns unit b / n_rt and row tile b % n_rt of TM (the row tiles of a unit
// run side by side and share its B rows in L2; part is not read: g_A has no
// sum across steps).  Every (window, column tile) of the unit is one output
// tile, written once.
template <bool VEC16>
__global__ void __launch_bounds__(fw::NT, 1)
window_bwd_gA_kernel(const float* __restrict__ g, const float* __restrict__ B,
                     const int32_t* __restrict__ win_step,
                     const int32_t* __restrict__ out_panel,
                     const int32_t* __restrict__ units,
                     float* __restrict__ gA, int TM, int G, int W, int n,
                     int k, int nblk) {
  extern __shared__ __align__(16) float smem[];
  const int depth = ga_depth(k);
  float* Gs = smem;                        // resident tile [depth][row]
  float* Bs = smem + GA_KC * GA_LDA;       // two B stages [depth][col]

  const int n_rt = (TM + GA_BM - 1) / GA_BM;
  const int unit = blockIdx.x / n_rt;
  const int row0 = blockIdx.x % n_rt * GA_BM;  // within TM
  const int rows_valid = TM - row0 < GA_BM ? TM - row0 : GA_BM;
  const int tid = threadIdx.x;
  const int tr = tid / GA_TC;
  const int tc = tid % GA_TC;
  const int GW = G * W;
  const int slot_lo = units[4 * unit + 1] * G;
  const int slot_hi = units[4 * unit + 2] * G;
  const int n_ct = (W + GA_BN - 1) / GA_BN;  // column tiles of a window
  // stages of a tile's depth (one of zeros when k == 0)
  const int n_ks = k > 0 ? (k + fw::BK - 1) / fw::BK : 1;

  // a sentinel window's tile is written as zeros, without loads or FMAs
  int n_real = 0;
  for (int sl = slot_lo; sl < slot_hi; ++sl) {
    if (win_step[sl] < nblk) {
      ++n_real;
      continue;
    }
    float4* tile = reinterpret_cast<float4*>(
        gA + ((int64_t)(sl / G) * TM + row0) * GW + (sl % G) * W);
    const int w4 = W / 4;
    for (int e = tid; e < rows_valid * w4; e += fw::NT)
      __stcs(tile + (int64_t)(e / w4) * (GW / 4) + e % w4,
             make_float4(0.f, 0.f, 0.f, 0.f));
  }
  const int T = n_real * n_ct * n_ks;
  if (T == 0) return;
  auto next_real = [&](int sl) {
    while (sl < slot_hi && win_step[sl] >= nblk) ++sl;
    return sl;
  };

  // the fetches run one stage ahead of the FMAs, over the same sequence of
  // (real window, column tile, depth) stages; the B rows of the fetches'
  // tile are found once per tile
  int ld_slot = next_real(slot_lo), ld_ct = 0, ld_kk = 0;
  const float* ld_rows_b = B;  // the first B row of the fetches' tile
  int ld_rows = 0;
  auto ld_tile = [&]() {
    const int c0 = ld_ct * GA_BN;
    const int64_t b0 = (int64_t)win_step[ld_slot] * W + c0;
    ld_rows_b = B + b0 * k;
    // rows of B that exist: within the window and below n
    const int64_t lim = n - b0 < W - c0 ? n - b0 : W - c0;
    ld_rows = lim > 0 ? (int)lim : 0;
  };
  float rb[8];
  auto fetch = [&]() {
    ga_fetch<VEC16>(rb, ld_rows_b, ld_rows, ld_kk, k, tid);
    ld_kk += fw::BK;
    if (ld_kk >= k) {
      ld_kk = 0;
      if (++ld_ct == n_ct) {
        ld_ct = 0;
        ld_slot = next_real(ld_slot + 1);
      }
      if (ld_slot < slot_hi) ld_tile();
    }
  };
  // the resident tile holds rows row0.. of panel g_panel, depth g_k0..
  int g_panel = out_panel[ld_slot / G];
  int g_k0 = 0;
  auto load_g = [&]() {
    fw::load_transposed<GA_BM, GA_LDA>(Gs, g, (int64_t)g_panel * TM + row0,
                                       rows_valid, g_k0, depth, k, tid);
    fw::cp_async_commit();
    fw::cp_async_wait<0>();
  };

  // the first resident tile: with 16-byte reads it comes through registers
  // as the B stages do, four (128-row, 16-depth) pieces in flight (the sums
  // are not live yet); 4-byte reads go faster by cp.async
  if constexpr (VEC16) {
    const float* rows_g = g + ((int64_t)g_panel * TM + row0) * k;
    const int pieces = GA_BM / 128 * (depth / fw::BK);
    for (int p0 = 0; p0 < pieces; p0 += 4) {
      float pc[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (p0 + u < pieces) {
          const int half = (p0 + u) % (GA_BM / 128);
          ga_fetch<VEC16>(pc[u], rows_g + (int64_t)half * 128 * k,
                          rows_valid - 128 * half,
                          (p0 + u) / (GA_BM / 128) * fw::BK, k, tid);
        }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (p0 + u < pieces)
          ga_put<GA_LDA>(Gs + (p0 + u) / (GA_BM / 128) * fw::BK * GA_LDA +
                             (p0 + u) % (GA_BM / 128) * 128,
                         pc[u], tid);
    }
  } else {
    load_g();
  }
  ld_tile();
  fetch();
  ga_put<GA_LDB>(Bs, rb, tid);  // stage 0
  if (T > 1) fetch();           // stage 1, in registers

  float acc[GA_RM][GA_RN];
#pragma unroll
  for (int i = 0; i < GA_RM; ++i)
#pragma unroll
    for (int j = 0; j < GA_RN; ++j) acc[i][j] = 0.f;

  int t = 0;  // stages taken; stage t lies in Bs + (t & 1) * GA_STAGE
  for (int sl = next_real(slot_lo); sl < slot_hi; sl = next_real(sl + 1)) {
    const int p = out_panel[sl / G];
    for (int ct = 0; ct < n_ct; ++ct) {
      for (int kk = 0; kk < n_ks * fw::BK; kk += fw::BK, ++t) {
        if (kk % GA_KC == 0 && (p != g_panel || kk != g_k0)) {
          // another panel (a unit across panels) or the next depth chunk
          // of a k beyond the cap: the tile reloads
          __syncthreads();  // every thread is done with the tile it held
          g_panel = p;
          g_k0 = kk;
          load_g();
        }
        __syncthreads();  // stage t stored (and the tile), t - 1 read
        fw::fma_stage_depthmajor_ld<GA_RM, GA_RN, GA_TC, GA_LDA, GA_LDB>(
            Gs + (kk - g_k0) * GA_LDA, Bs + (t & 1) * GA_STAGE, tr, tc, acc);
        if (t + 1 < T) {
          ga_put<GA_LDB>(Bs + ((t + 1) & 1) * GA_STAGE, rb, tid);  // t + 1
          if (t + 2 < T) fetch();  // stage t + 2, under the next FMAs
        }
      }

      // the tile is done: store it; every element once, streaming past L2
      using M = fw::ColMap<GA_RN, GA_TC>;
      const int c0 = ct * GA_BN;
      float* tile = gA + ((int64_t)(sl / G) * TM + row0) * GW +
                    (sl % G) * W + c0;
#pragma unroll
      for (int i = 0; i < GA_RM; ++i) {
        const int r = tr * GA_RM + i;
#pragma unroll
        for (int run = 0; run < M::RUNS; ++run) {
          const int c = M::col(tc, 4 * run);
          // W % 16 == 0: a run of 4 lies wholly inside the window or not
          if (r < rows_valid && c0 + c < W)
            __stcs(reinterpret_cast<float4*>(tile + (int64_t)r * GW + c),
                   make_float4(acc[i][4 * run], acc[i][4 * run + 1],
                               acc[i][4 * run + 2], acc[i][4 * run + 3]));
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][4 * run + e] = 0.f;
        }
      }
    }
  }
}

template <bool VEC16>
int launch_gA(const float* g, const float* B, const int32_t* win_step,
              const int32_t* out_panel, const int32_t* units, float* gA,
              int n_units, int TM, int G, int W, int n, int k, int nblk,
              cudaStream_t st) {
  const int err = fw::allow_smem(window_bwd_gA_kernel<VEC16>, GA_SMEM);
  if (err) return err;
  const int blocks = n_units * ((TM + GA_BM - 1) / GA_BM);
  window_bwd_gA_kernel<VEC16><<<blocks, fw::NT, GA_SMEM, st>>>(
      g, B, win_step, out_panel, units, gA, TM, G, W, n, k, nblk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// W % 16 == 0 (the wrapper checks).  units is int32[n_units][4] and covers
// every step once; gA [S, TM, G*W] is written whole.  g and B move 16
// bytes a read when k % 4 == 0 and both are 16-byte aligned, else 4.
extern "C" int flex_window_bwd_gA(const float* g, const float* B,
                                  const int32_t* win_step,
                                  const int32_t* out_panel,
                                  const int32_t* units, float* gA,
                                  int n_units, int TM, int G, int W, int n,
                                  int k, int nblk, void* stream) {
  if (n_units == 0 || G == 0 || TM == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  return vec ? launch_gA<true>(g, B, win_step, out_panel, units, gA, n_units,
                               TM, G, W, n, k, nblk, st)
             : launch_gA<false>(g, B, win_step, out_panel, units, gA, n_units,
                                TM, G, W, n, k, nblk, st);
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
