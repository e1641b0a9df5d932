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
// with A and B f32 in memory, each element rounded to bf16 (nearest even)
// as it is staged into shared memory, products exact and sums in f32.  No
// bf16 copy of A is made, so what is timed is the TPU kernel's own work:
// read f32 A once, multiply on the tensor cores.
//
// Work is cut as in kernel 1: the host cuts every panel's step range into
// units (ops/units.py:work_units) and one block owns one (unit, 128-row
// tile, 128-column tile).  A panel with one unit writes its output tile; the
// units of a longer panel write partial tiles into scratch, which kernel 1's
// flex_window_spmm_reduce adds in unit order: no atomics, the same bits on
// every launch.  Sentinel windows (id >= nblk) are skipped; B rows >= n,
// A rows >= TM and columns >= k read as zero.
//
// A block is 8 warps over a 128 x 128 output tile, a warp 64 rows x 32
// columns: 4 x 4 tiles of mma.sync.m16n8k16 (bf16 in, f32 accumulate), 64
// accumulators a thread.  The contraction advances BK = 32 (or 16 when
// W % 32 != 0) a stage.  Each stage is read from global memory into
// registers one stage ahead (16-byte loads of A; of B when k % 4 == 0 and B
// is 16-byte aligned, else 4-byte loads), rounded to bf16 pairs and stored
// into the other of two shared buffers, A row-major and B transposed, so
// that every fragment register is one 32-bit shared load (row pitch BK + 8
// halves: no bank conflicts across a warp's fragment loads).  One barrier
// a stage.  wgmma and TMA are not used.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;       // output rows of a block
constexpr int BN = 128;       // output columns of a block
constexpr int NT = 256;       // 8 warps: 2 (rows) x 4 (columns)
constexpr int WM = 64;        // rows of a warp's tile
constexpr int WN = 32;        // columns of a warp's tile
constexpr int MT = WM / 16;   // m16 tiles a warp
constexpr int NTL = WN / 8;   // n8 tiles a warp

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BK, bool VEC16>
struct Stage {
  static constexpr int PITCH = BK + 8;                // halves a shared row
  static constexpr int A_F4 = BM * BK / 4 / NT;       // A float4s a thread
  static constexpr int B_PAIRS = BK / 2 * BN / 4 / NT;  // (2 rows x 4 cols)
  float4 a[A_F4];
  float4 b[B_PAIRS][2];

  // A rows row0 .. of step s, window g, depth kk .. kk + BK
  __device__ __forceinline__ void load(const float* __restrict__ A,
                                       const float* __restrict__ B, int64_t s,
                                       int g, int kk, int64_t brow, int TM,
                                       int GW, int W, int row0, int n, int k,
                                       int col0, int tid) {
#pragma unroll
    for (int j = 0; j < A_F4; ++j) {
      const int i = tid + j * NT;
      const int r = i / (BK / 4);
      const int c = (i % (BK / 4)) * 4;
      a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < TM)
        a[j] = __ldg(reinterpret_cast<const float4*>(
            A + (s * TM + row0 + r) * GW + g * W + kk + c));
    }
#pragma unroll
    for (int j = 0; j < B_PAIRS; ++j) {
      const int i = tid + j * NT;
      const int rp = i / (BN / 4);            // row pair
      const int c = col0 + (i % (BN / 4)) * 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = brow + kk + 2 * rp + h;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < n) {
          const float* p = B + row * k + c;
          if constexpr (VEC16) {
            if (c < k) v = __ldg(reinterpret_cast<const float4*>(p));
          } else {
            if (c < k) v.x = __ldg(p);
            if (c + 1 < k) v.y = __ldg(p + 1);
            if (c + 2 < k) v.z = __ldg(p + 2);
            if (c + 3 < k) v.w = __ldg(p + 3);
          }
        }
        b[j][h] = v;
      }
    }
  }

  // rounded to bf16: A row-major [BM][PITCH], B transposed [BN][PITCH]
  __device__ __forceinline__ void store(__nv_bfloat16* As, __nv_bfloat16* Bs,
                                        int tid) const {
#pragma unroll
    for (int j = 0; j < A_F4; ++j) {
      const int i = tid + j * NT;
      const int r = i / (BK / 4);
      const int c = (i % (BK / 4)) * 4;
      const uint2 v = make_uint2(pack_bf16(a[j].x, a[j].y),
                                 pack_bf16(a[j].z, a[j].w));
      *reinterpret_cast<uint2*>(As + r * PITCH + c) = v;
    }
#pragma unroll
    for (int j = 0; j < B_PAIRS; ++j) {
      const int i = tid + j * NT;
      const int rp = i / (BN / 4);
      const int c = (i % (BN / 4)) * 4;
      const float4 lo = b[j][0], hi = b[j][1];
      uint32_t* col = reinterpret_cast<uint32_t*>(Bs + c * PITCH + 2 * rp);
      col[0] = pack_bf16(lo.x, hi.x);
      col[PITCH / 2] = pack_bf16(lo.y, hi.y);
      col[PITCH] = pack_bf16(lo.z, hi.z);
      col[3 * PITCH / 2] = pack_bf16(lo.w, hi.w);
    }
  }
};

// units[u] = (panel, s_lo, s_hi, part): steps s_lo .. s_hi - 1 of `panel`;
// part < 0 writes the tile of `out`, else tile `part` of `scratch`.
template <int BK, bool VEC16>
__global__ void __launch_bounds__(NT, 2)
winstep_bf16_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    const int32_t* __restrict__ win_step,
                    const int32_t* __restrict__ units, float* __restrict__ out,
                    float* __restrict__ scratch, int TM, int G, int W, int n,
                    int k, int nblk) {
  using St = Stage<BK, VEC16>;
  constexpr int PITCH = St::PITCH;
  __shared__ __align__(16) __nv_bfloat16 As[2][BM * PITCH];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][BN * PITCH];

  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.z * BN;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wr = (warp / 4) * WM;   // warp's first row in the tile
  const int wc = (warp % 4) * WN;   // warp's first column
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int GW = G * W;
  const int slot_lo = units[4 * blockIdx.x + 1] * G;
  const int slot_hi = units[4 * blockIdx.x + 2] * G;

  float acc[MT][NTL][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // the unit's real windows, W / BK stages each
  int n_real = 0;
  for (int base = slot_lo; base < slot_hi; base += NT) {
    const int sl = base + tid;
    n_real += __syncthreads_count(sl < slot_hi && win_step[sl] < nblk);
  }
  const int T = n_real * (W / BK);

  // every thread walks the same cursor (window slot, depth in the window)
  int cur = slot_lo;
  while (cur < slot_hi && win_step[cur] >= nblk) ++cur;
  int cur_kk = 0;
  St regs;
  auto fetch = [&]() {
    regs.load(A, B, cur / G, cur % G, cur_kk, (int64_t)win_step[cur] * W, TM,
              GW, W, row0, n, k, col0, tid);
    cur_kk += BK;
    if (cur_kk == W) {
      cur_kk = 0;
      ++cur;
      while (cur < slot_hi && win_step[cur] >= nblk) ++cur;
    }
  };

  if (T > 0) {
    fetch();
    regs.store(As[0], Bs[0], tid);
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) fetch();  // the next stage's loads fly under the MMAs
    const __nv_bfloat16* as = As[t % 2];
    const __nv_bfloat16* bs = Bs[t % 2];
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const __nv_bfloat16* p = as + (wr + i * 16 + gid) * PITCH + k0 +
                                 2 * tig;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * PITCH);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * PITCH + 8);
      }
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        const __nv_bfloat16* p = bs + (wc + j * 8 + gid) * PITCH + k0 +
                                 2 * tig;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], af[i], b0, b1);
      }
    }
    if (t + 1 < T) regs.store(As[(t + 1) % 2], Bs[(t + 1) % 2], tid);
    __syncthreads();
  }

  // every element of the tile is written exactly once
  const int panel = units[4 * blockIdx.x];
  const int part = units[4 * blockIdx.x + 3];
  float* tile = part < 0 ? out + ((int64_t)panel * TM + row0) * k
                         : scratch + ((int64_t)part * TM + row0) * k;
  const int rows = TM - row0;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wr + i * 16 + gid + (e / 2) * 8;
        const int c = col0 + wc + j * 8 + 2 * tig + e % 2;
        if (r < rows && c < k) tile[(int64_t)r * k + c] = acc[i][j][e];
      }
}

template <int BK, bool VEC16>
int launch(const float* A, const float* B, const int32_t* win_step,
           const int32_t* units, float* out, float* scratch, int n_units,
           int TM, int G, int W, int n, int k, int nblk, cudaStream_t st) {
  const dim3 grid(n_units, (TM + BM - 1) / BM, (k + BN - 1) / BN);
  winstep_bf16_kernel<BK, VEC16><<<grid, NT, 0, st>>>(
      A, B, win_step, units, out, scratch, TM, G, W, n, k, nblk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A 16-byte aligned, W % 16 == 0 (the wrapper checks).  units is
// int32[n_units][4]; scratch holds the partial tiles, (TM, k) each; kernel
// 1's flex_window_spmm_reduce adds them.
extern "C" int flex_winstep_bf16(const float* A, const float* B,
                                 const int32_t* win_step, const int32_t* units,
                                 float* out, float* scratch, int n_units,
                                 int TM, int G, int W, int n, int k, int nblk,
                                 void* stream) {
  if (n_units == 0 || k == 0 || TM == 0) return 0;
  if (W % 16) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
  if (W % 32 == 0)
    return vec ? launch<32, true>(A, B, win_step, units, out, scratch, n_units,
                                  TM, G, W, n, k, nblk, st)
               : launch<32, false>(A, B, win_step, units, out, scratch,
                                   n_units, TM, G, W, n, k, nblk, st);
  return vec ? launch<16, true>(A, B, win_step, units, out, scratch, n_units,
                                TM, G, W, n, k, nblk, st)
             : launch<16, false>(A, B, win_step, units, out, scratch, n_units,
                                 TM, G, W, n, k, nblk, st);
}
