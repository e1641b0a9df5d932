// Kernel 12: the window step of kernel 1 at the TPU's DEFAULT precision, on
// Hopper's tensor cores (sm_90a), plain C interface.
//
// Replaces the Pallas kernel of experiments/micro_winstep.py:run at
// precision "default" (body `kernel`, its pallas_call): one bf16 pass with
// f32 accumulation.  On kernel 1's step tables (csrc/window_spmm.cu) it
// computes, for every used row panel p,
//
//   out[p*TM : (p+1)*TM, :] = sum over the panel's steps s, windows g of
//       bf16(A[s][:, g*W : (g+1)*W]) . bf16(B[win_step[s*G+g]*W : +W, :])
//
// with A and B f32 in memory, each element rounded to bf16 (nearest even),
// products exact and sums in f32.  The wrapper casts B once per call into a
// bf16 buffer with 16-byte rows (ops/gespmm.to_bf16_padded, the same
// rounding); A is read in f32 and rounded in registers.
//
// Bound: bytes.  The f32 A must be read once (3.67 GB on E7, 1.10 ms at
// 3.35 TB/s; with B and C 4.02 GB, 1.20 ms); the products are 0.24 ms at
// the bf16 tensor rate.  The bf16 torch.bmm yardstick can run below this
// bound: it reads a bf16 A made beforehand, half of A's bytes.
//
// Work is cut as in kernel 1: the host cuts every panel's step range into
// units (ops/units.py:work_units) and one block owns one (unit, 256-row
// tile, 128-column tile), so every B window reaches an SM once per unit and
// column tile.  A panel with one unit writes its output tile; the units of
// a longer panel write partial tiles into scratch, which kernel 1's
// flex_window_spmm_reduce adds in unit order: no atomics, the same bits on
// every launch.  Sentinel windows (id >= nblk) are skipped; B rows >= n, A
// rows >= TM and columns >= k read as zero (the tensor maps' bounds).
//
// Past A, what the kernel reads again is B: each slot fetches its window
// (0.92 GB of bf16 on E7 at G = 4) from a 60 MB copy that A's stream
// sweeps out of the 50 MB L2.  B's loads therefore mark half of its lines
// evict-last (on an H100 any fraction from 1/4 to 7/8 ran E7 alike, and
// faster than none); A keeps the default policy and the 256-byte L2
// promotion, whose second 128 bytes the next stage reads (evict-first or
// no promotion on A ran slower).  Also tried and dropped, slower on E7: a
// persistent grid of one block an SM walking the tiles, so that an
// epilogue overlaps the next tile's loads.
//
// A block is three warpgroups.  Warp 8 (the producer) walks the unit's
// window slots 32 at a time (one coalesced load and a ballot of the real
// ones), and for each stage of BK = 32 contraction rows (16 when
// W % 32 != 0) waits for a free slot of a ring of shared-memory stages and
// issues TMA loads into it: A as a 3-D map [S, TM, G*W] (a 2-D view would
// read the next step's rows past TM), one box of BK floats x 256 rows,
// swizzled 128 B (64 B at BK = 16); B as a 2-D map on the bf16 copy, two
// boxes of BK rows x 64 columns, swizzled 128 B.  The stage's mbarrier
// counts the boxes' bytes (zero fill included).  The ring holds 5 stages of
// 40 KB (8 of 20 KB at BK = 16), so that 160-200 KB of loads are in flight
// on each SM.  Each consumer warp counts the unit's real windows with the
// producer's predicate, so the consumers wait for exactly the stages the
// producer issues; a unit with none writes zeros.
//
// Warps 0-7 are two consumer warpgroups, one a 128-row half of the tile.
// Each runs wgmma.mma_async m64n128k16 bf16 -> f32 with A from registers:
// a thread reads its fragment's f32 pairs from the swizzled stage (8-byte
// loads) and rounds them with cvt.rn.bf16x2.f32.  Fragment row r of a
// warp's 16 rows reads stage row sigma(r) = 2 (r % 4) + r / 4 (and 8 +
// sigma(r)), so the 16 lanes of each half-warp read 4 rows whose 128-byte
// swizzle phases differ and the loads are free of bank conflicts (rows are
// independent: the epilogue writes row sigma(r)).  B comes from shared
// memory by descriptor, MN-major (transposed), which bf16 allows: each
// 64-column box is one swizzle atom wide (LBO = the box, SBO = 8 rows of
// 128 B).  After each stage's wgmma.wait_group 0 every consumer warp
// arrives on the stage's empty barrier (a warpgroup whose rows all lie
// past TM leaves at once, and the barrier counts the other's four); the
// producer refills it.  setmaxnreg gives the producer warpgroup 40
// registers and the consumers 232 (two 64-row accumulator tiles, 128
// floats a thread).
//
// The tensor maps are encoded per call on the host by cuTensorMapEncodeTiled
// (reached through cudaGetDriverEntryPoint: no -lcuda) and passed as
// __grid_constant__ parameters.

#include <cstdint>
#include <cstring>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 256;        // output rows of a block: two warpgroups
constexpr int BN = 128;        // output columns of a block: two B boxes
constexpr int BOX_N = 64;      // columns of a B box: 128 bytes of bf16
constexpr int NT = 384;        // 2 consumer warpgroups + the producer's
constexpr unsigned FULL = 0xffffffffu;

template <int BK>
struct Cfg {
  static constexpr int A_BYTES = BM * BK * 4;         // f32 A of a stage
  static constexpr int B_BOX = BK * BOX_N * 2;         // one bf16 B box
  static constexpr int STAGE = A_BYTES + 2 * B_BOX;
  static constexpr int STAGES = BK == 32 ? 5 : 8;
  static constexpr int SMEM = STAGES * STAGE + 1024;   // + alignment slack
  static constexpr uint32_t A_SWZ = BK == 32 ? 7 : 3;  // 128 B / 64 B swizzle
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// with an L2 policy (createpolicy)
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1,
                                       uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "l"(policy)
      : "memory");
}

// bf16 pair, lo in the low half: the fragment's lower contraction index
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// A[row][col] and A[row][col + 1] of an f32 stage of BK-float rows, read
// where the TMA's swizzle put them, rounded to a bf16 pair
template <int BK>
__device__ __forceinline__ uint32_t a_pair(const char* stage, int row,
                                           int col) {
  uint32_t off = static_cast<uint32_t>(row * BK * 4 + col * 4);
  off ^= (off >> 3) & (Cfg<BK>::A_SWZ << 4);
  const float2 v = *reinterpret_cast<const float2*>(stage + off);
  return bf16x2(v.x, v.y);
}

// shared-memory descriptor of an MN-major B operand, 128-byte swizzle
// (LBO: the next 64-column box; SBO: the next 8 rows of 128 B)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, uint32_t lbo) {
  constexpr uint64_t SBO = 1024;
  return uint64_t((addr & 0x3FFFF) >> 4) | uint64_t(lbo >> 4) << 16 |
         (SBO >> 4) << 32 | uint64_t(1) << 62;
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 rows x 128 cols] += a (registers) . B (descriptor), bf16 -> f32
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// the real windows (id < nblk) among slots [lo, hi), counted by one warp
__device__ __forceinline__ int count_real(const int32_t* __restrict__ win_step,
                                          int lo, int hi, int nblk, int lane) {
  int n = 0;
  for (int base = lo; base < hi; base += 32) {
    const int sl = base + lane;
    n += __popc(__ballot_sync(FULL, sl < hi && win_step[sl] < nblk));
  }
  return n;
}

// units[u] = (panel, s_lo, s_hi, part): steps s_lo .. s_hi - 1 of `panel`;
// part < 0 writes the tile of `out`, else tile `part` of `scratch`.
template <int BK>
__global__ void __launch_bounds__(NT, 1)
winstep_wgmma_kernel(const __grid_constant__ CUtensorMap tmA,
                     const __grid_constant__ CUtensorMap tmB,
                     const int32_t* __restrict__ win_step,
                     const int32_t* __restrict__ units,
                     float* __restrict__ out, float* __restrict__ scratch,
                     int TM, int G, int W, int k, int nblk) {
  using C = Cfg<BK>;
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full[C::STAGES], empty[C::STAGES];
  char* ring = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.z * BN;
  const int slot_lo = units[4 * blockIdx.x + 1] * G;
  const int slot_hi = units[4 * blockIdx.x + 2] * G;
  const int n_wg = TM - row0 > 128 ? 2 : 1;  // warpgroups with rows < TM
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * n_wg);  // every consumer warp, every stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != 8) return;
    const bool two = col0 + BOX_N < k;  // the second B box has columns
    const uint32_t bytes = C::A_BYTES + (two ? 2 : 1) * C::B_BOX;
    // half of B's lines evict last: other units read its windows again
    uint64_t keep_b;
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 0.5;\n"
                 : "=l"(keep_b));
    int stage = 0;
    uint32_t phase = 0;
    for (int base = slot_lo; base < slot_hi; base += 32) {
      const int sl = base + lane;
      const int b = sl < slot_hi ? win_step[sl] : nblk;
      unsigned real = __ballot_sync(FULL, b < nblk);
      while (real) {
        const int j = __ffs(real) - 1;
        real &= real - 1;
        const int bj = __shfl_sync(FULL, b, j);
        const int s = (base + j) / G;
        const int g = base + j - s * G;
        for (int kk = 0; kk < W; kk += BK) {
          if (lane == 0) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], bytes);
            char* st = ring + stage * C::STAGE;
            tma_3d(st, &tmA, &full[stage], g * W + kk, row0, s);
            tma_2d(st + C::A_BYTES, &tmB, &full[stage], col0, bj * W + kk,
                   keep_b);
            if (two)
              tma_2d(st + C::A_BYTES + C::B_BOX, &tmB, &full[stage],
                     col0 + BOX_N, bj * W + kk, keep_b);
          }
          __syncwarp();
          if (++stage == C::STAGES) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp / 4;
    if (wg >= n_wg) return;
    const int gid = lane / 4, tig = lane % 4;
    const int sig = 2 * (gid % 4) + gid / 4;  // stage row of fragment row
    const int rbase = wg * 128 + (warp % 4) * 16 + sig;
    const int T = count_real(win_step, slot_lo, slot_hi, nblk, lane) *
                  (W / BK);
    float acc[2][64];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[m][i] = 0.f;

    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < T; ++t) {
      mbar_wait(&full[stage], phase);
      const char* st = ring + stage * C::STAGE;
      uint32_t a[BK / 16][2][4];
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int r = rbase + m * 64, c = ks * 16 + 2 * tig;
          a[ks][m][0] = a_pair<BK>(st, r, c);
          a[ks][m][1] = a_pair<BK>(st, r + 8, c);
          a[ks][m][2] = a_pair<BK>(st, r, c + 8);
          a[ks][m][3] = a_pair<BK>(st, r + 8, c + 8);
        }
      const uint32_t bs = smem_u32(st + C::A_BYTES);
#pragma unroll
      for (int m = 0; m < 2; ++m) fence_acc(acc[m]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
        for (int m = 0; m < 2; ++m)
          wgmma_rs(acc[m], a[ks][m], b_desc(bs + ks * 16 * 128, C::B_BOX));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int m = 0; m < 2; ++m) fence_acc(acc[m]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == C::STAGES) stage = 0, phase ^= 1;
    }

    // every element of the tile is written exactly once
    const int panel = units[4 * blockIdx.x];
    const int part = units[4 * blockIdx.x + 3];
    float* tile =
        (part < 0 ? out + static_cast<int64_t>(panel) * TM * k
                  : scratch + static_cast<int64_t>(part) * TM * k) +
        static_cast<int64_t>(row0) * k;
    const int rows = TM - row0;
    const bool pairs = k % 2 == 0;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rbase + m * 64 + 8 * h;
          const int c = col0 + 8 * j + 2 * tig;
          if (r >= rows || c >= k) continue;
          float* p = tile + static_cast<int64_t>(r) * k + c;
          const float x = acc[m][4 * j + 2 * h];
          const float y = acc[m][4 * j + 2 * h + 1];
          if (pairs) {
            *reinterpret_cast<float2*>(p) = make_float2(x, y);
          } else {
            p[0] = x;
            if (c + 1 < k) p[1] = y;
          }
        }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
    else
      cudaGetLastError();
  }
  return fn;
}

// the dynamic shared memory of kernel BK's instance, allowed once a device
template <int BK>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(winstep_wgmma_kernel<BK>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Cfg<BK>::SMEM);
  if (e != cudaSuccess) return cudaGetLastError(), e;
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
}

template <int BK>
int launch(const float* A, const __nv_bfloat16* Bb, const int32_t* win_step,
           const int32_t* units, float* out, float* scratch, int n_units,
           int TM, int G, int W, int n, int k, int nblk, int S, int ldb,
           cudaStream_t st) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cudaError_t e = allow_smem<BK>();
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tmA, tmB;
  std::memset(&tmA, 0, sizeof tmA);  // S == 0: no unit has a window
  if (S > 0) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(G) * W,
                                static_cast<cuuint64_t>(TM),
                                static_cast<cuuint64_t>(S)};
    const cuuint64_t strides[2] = {dims[0] * 4, dims[0] * 4 * TM};
    const cuuint32_t box[3] = {BK, BM, 1};
    const cuuint32_t one[3] = {1, 1, 1};
    if (encode(&tmA, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
               const_cast<float*>(A), dims, strides, box, one,
               CU_TENSOR_MAP_INTERLEAVE_NONE,
               BK == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_64B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(n)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldb) * 2};
    const cuuint32_t box[2] = {BOX_N, BK};
    const cuuint32_t one[2] = {1, 1};
    if (encode(&tmB, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
               const_cast<__nv_bfloat16*>(Bb), dims, strides, box, one,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_units, (TM + BM - 1) / BM, (k + BN - 1) / BN);
  winstep_wgmma_kernel<BK><<<grid, NT, Cfg<BK>::SMEM, st>>>(
      tmA, tmB, win_step, units, out, scratch, TM, G, W, k, nblk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A f32 [S, TM, G*W], 16-byte aligned, W % 16 == 0; Bb the bf16 copy of B
// [n, k] with rows ldb elements apart (ldb % 8 == 0, 16-byte aligned,
// n >= 1); units is int32[n_units][4]; scratch holds the partial tiles,
// (TM, k) each; kernel 1's flex_window_spmm_reduce adds them.
extern "C" int flex_winstep_bf16(const float* A, const __nv_bfloat16* Bb,
                                 const int32_t* win_step, const int32_t* units,
                                 float* out, float* scratch, int n_units,
                                 int TM, int G, int W, int n, int k, int nblk,
                                 int S, int ldb, void* stream) {
  if (n_units == 0 || k == 0 || TM == 0) return 0;
  if (W % 16 || n < 1 || ldb % 8 || ldb < k ||
      reinterpret_cast<uintptr_t>(A) % 16 || reinterpret_cast<uintptr_t>(Bb) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return W % 32 == 0
             ? launch<32>(A, Bb, win_step, units, out, scratch, n_units, TM, G,
                          W, n, k, nblk, S, ldb, st)
             : launch<16>(A, Bb, win_step, units, out, scratch, n_units, TM, G,
                          W, n, k, nblk, S, ldb, st);
}

// the contraction rows a stage, the ring's stages and the dynamic shared
// memory a block at window width W
extern "C" int flex_winstep_bf16_layout(int W, int* bk, int* stages,
                                        int* smem_bytes) {
  if (W <= 0 || W % 16) return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = W % 32 == 0;
  *bk = wide ? 32 : 16;
  *stages = wide ? Cfg<32>::STAGES : Cfg<16>::STAGES;
  *smem_bytes = wide ? Cfg<32>::SMEM : Cfg<16>::SMEM;
  return 0;
}
