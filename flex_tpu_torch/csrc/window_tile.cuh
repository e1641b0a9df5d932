// Shared pieces of the window kernels that are cut into work units
// (csrc/window_spmm.cu: the forward; csrc/window_spmm_bwd.cu: g_A and g_B;
// csrc/window_spmm_t.cu: the transposed forward) and of the ranged split
// band kernel (csrc/band_spmm.cu): the cp.async ring, the tile loaders, the
// register-tile products, the tile store and the passes that add partial
// tiles in unit order (into contiguous or strided output tiles).
//
// Tile: BM = 128 output rows x BN output columns per block of 256 threads,
// BN = 16 * RN with RN = 2, 3, 4 or 8 picked from k, so a narrow k does less
// work; every thread holds 8 * RN accumulators (8 rows x RN columns in g_B,
// 4 rows x 2 * RN columns in the forward, whose A stage is row-major).  The
// contraction advances BK = 16 deep per stage; STAGES stages live in dynamic
// shared memory and are filled by cp.async, so the loads of the next two
// stages are in flight while the FMAs of this one run, with one barrier a
// stage.  Out-of-range rows and columns are filled with zeros by cp.async's
// source size 0, so no operand is padded.  Operand rows that are 16-byte
// aligned (k % 4 == 0) move 16 bytes a copy; any other k takes the 4-byte
// copies of the same ring.
//
// What was measured on an NVIDIA H100 80GB HBM3 at 700 W with these pieces:
// on random step tables of the main path's size a ring of 2, 3 or 4 stages
// and a stage depth of 16 or 32 made no difference worth keeping, so the
// FP32 FMA rate bounds both kernels, not the loads.  A
// split-precision tensor-core product (3 x TF32 through mma.sync.m16n8k8,
// the three products of 8 contraction steps summed from zero in the tensor
// core and added to the accumulators by an f32 add) kept res_check's
// err_frac at 0 on the reddit_posts main path and its errors at the FMA
// product's level, but was only 10-18 % faster at k = 128 and spilled
// registers; summed inside the tensor core alone it was 18-30 % faster and
// lost a digit (the tensor core's accumulate truncates).  It was not
// adopted; PERF.md has the numbers.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace flex_window {

constexpr int BM = 128;    // output rows per block
constexpr int BK = 16;     // contraction depth per stage
constexpr int RM = 8;      // rows per thread
constexpr int TC = 16;     // thread columns
constexpr int NT = (BM / RM) * TC;  // 256 threads
constexpr int STAGES = 3;  // ring depth
constexpr int APAD = 4;    // row-major A stage: row stride BK + APAD floats,
                           // so the two rows a warp reads lie in other banks

// ---- cp.async ------------------------------------------------------------

// 16 bytes global -> shared, past L1; zeros when !pred (nothing is read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

// 4 bytes global -> shared; zeros when !pred
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- column mapping ------------------------------------------------------

// A thread's CN columns of the tile, on a grid of TCOLS thread columns: runs
// of VEC neighbours, TCOLS*VEC apart, so a stage row is read by float4 /
// float2 / float without bank conflicts (16 thread columns: CN = 8 is two
// runs of 4, CN = 3 the columns tc, tc + 16, tc + 32).
template <int CN, int TCOLS>
struct ColMap {
  static constexpr int VEC = CN % 4 == 0 ? 4 : (CN % 2 == 0 ? 2 : 1);
  static constexpr int RUNS = CN / VEC;
  __device__ __forceinline__ static int col(int tc, int j) {
    return (j / VEC) * (TCOLS * VEC) + tc * VEC + j % VEC;
  }
};

template <int CN, int TCOLS>
__device__ __forceinline__ void load_cols(const float* __restrict__ row,
                                          int tc, float (&b)[CN]) {
  using M = ColMap<CN, TCOLS>;
#pragma unroll
  for (int r = 0; r < M::RUNS; ++r) {
    const float* p = row + r * (TCOLS * M::VEC) + tc * M::VEC;
    if constexpr (M::VEC == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      b[4 * r] = v.x, b[4 * r + 1] = v.y, b[4 * r + 2] = v.z, b[4 * r + 3] = v.w;
    } else if constexpr (M::VEC == 2) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      b[2 * r] = v.x, b[2 * r + 1] = v.y;
    } else {
      b[r] = *p;
    }
  }
}

// ---- stage loaders -------------------------------------------------------

// dst[r][c] (BK x BN) <- rows[(row0 + r) * k + col0 + c], zero where
// row0 + r >= row_limit or col0 + c >= k.  VEC16 needs k % 4 == 0 and a
// 16-byte aligned `rows`.
template <int BN, bool VEC16>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ rows,
                                          int64_t row0, int64_t row_limit,
                                          int k, int col0, int tid) {
  constexpr int V = VEC16 ? 4 : 1;  // floats per copy
  constexpr int CPR = BN / V;       // copies per row
  if constexpr (NT % CPR == 0) {
    // a thread keeps one column and walks down the rows: one column mask
    // and one base address per stage
    constexpr int STEP = NT / CPR;
    const int c = (tid % CPR) * V;
    const bool col_ok = col0 + c < k;
    const float* p = rows + (row0 + tid / CPR) * k + col0 + c;
#pragma unroll
    for (int t = 0; t < (BK + STEP - 1) / STEP; ++t) {
      const int r = tid / CPR + t * STEP;
      if (BK % STEP != 0 && r >= BK) break;
      const bool ok = col_ok && row0 + r < row_limit;
      const float* src = ok ? p + (int64_t)t * STEP * k : rows;
      if constexpr (VEC16) cp_async16(dst + r * BN + c, src, ok);
      else cp_async4(dst + r * BN + c, src, ok);
    }
  } else {
#pragma unroll
    for (int t = 0; t < (BK * CPR + NT - 1) / NT; ++t) {
      const int i = tid + t * NT;
      if ((BK * CPR) % NT != 0 && i >= BK * CPR) break;
      const int r = i / CPR;
      const int c = (i % CPR) * V;
      const bool ok = row0 + r < row_limit && col0 + c < k;
      const float* src = ok ? rows + (row0 + r) * k + col0 + c : rows;
      if constexpr (VEC16) cp_async16(dst + r * BN + c, src, ok);
      else cp_async4(dst + r * BN + c, src, ok);
    }
  }
}

// Row-major A stage: dst[r][q] (BM x BK, row stride BK + APAD) <-
// a[r * lda + q], zero for r >= rows_valid.  a 16-byte aligned, lda % 4 == 0.
__device__ __forceinline__ void load_a_rowmajor(float* dst,
                                                const float* __restrict__ a,
                                                int lda, int rows_valid,
                                                int tid) {
#pragma unroll
  for (int t = 0; t < (BM * BK) / (4 * NT); ++t) {
    const int i = tid + t * NT;
    const int r = i / (BK / 4);
    const int c = (i % (BK / 4)) * 4;
    const bool ok = r < rows_valid;
    cp_async16(dst + r * (BK + APAD) + c, ok ? a + (int64_t)r * lda + c : a,
               ok);
  }
}

// Depth-major A stage: dst[q][w] (BK x COLS) <- a[q * lda + w], zero for
// q >= depth_valid or w >= cols_valid (cols_valid % 4 == 0); THREADS
// threads share the copies.
template <int COLS = BM, int THREADS = NT>
__device__ __forceinline__ void load_a_depthmajor(float* dst,
                                                  const float* __restrict__ a,
                                                  int lda, int depth_valid,
                                                  int cols_valid, int tid) {
#pragma unroll
  for (int t = 0; t < (BK * COLS) / (4 * THREADS); ++t) {
    const int i = tid + t * THREADS;
    const int q = i / (COLS / 4);
    const int w = (i % (COLS / 4)) * 4;
    const bool ok = q < depth_valid && w < cols_valid;
    cp_async16(dst + q * COLS + w, ok ? a + (int64_t)q * lda + w : a, ok);
  }
}

// dst[r * LDD + c] (ROWS x COLS) <- src[r * ld + c] by 4-byte copies (any
// alignment), zero where r >= rows_valid or c >= cols_valid.  A thread
// keeps one column and walks down the rows: one mask and one base address.
template <int ROWS, int COLS, int LDD, int THREADS>
__device__ __forceinline__ void load_rows4(float* dst,
                                           const float* __restrict__ src,
                                           int64_t ld, int rows_valid,
                                           int64_t cols_valid, int tid) {
  static_assert(THREADS % COLS == 0 && (ROWS * COLS) % THREADS == 0,
                "copies must divide evenly");
  constexpr int STEP = THREADS / COLS;
  const int c = tid % COLS;
  const bool col_ok = c < cols_valid;
  const float* p = src + (tid / COLS) * ld + c;
#pragma unroll
  for (int t = 0; t < ROWS / STEP; ++t) {
    const int r = tid / COLS + t * STEP;
    const bool ok = col_ok && r < rows_valid;
    cp_async4(dst + r * LDD + c, ok ? p + t * STEP * ld : src, ok);
  }
}

// ---- register-tile products of one stage ---------------------------------

// Row-major A stage (the forward): the threads form a 32 x 8 grid, thread
// row i is tile row tr + 32 * i (FR = 4 rows) and a thread owns 2 * RN
// columns.  A is read along the depth, four steps of the contraction per
// float4, so a step costs one read of A and 2 * RN / 4 of B per 8 * RN FMAs.
constexpr int FR = 4;          // rows per thread
constexpr int FTR = BM / FR;   // 32 thread rows
constexpr int FTC = NT / FTR;  // 8 thread columns

template <int RN>
__device__ __forceinline__ void fma_stage_rowmajor(
    const float* __restrict__ As, const float* __restrict__ Bs, int tr, int tc,
    float (&acc)[FR][2 * RN]) {
  constexpr int BN = RN * TC;
#pragma unroll
  for (int q4 = 0; q4 < BK; q4 += 4) {
    float a[FR][4];
#pragma unroll
    for (int i = 0; i < FR; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(
          As + (tr + FTR * i) * (BK + APAD) + q4);
      a[i][0] = v.x, a[i][1] = v.y, a[i][2] = v.z, a[i][3] = v.w;
    }
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      float b[2 * RN];
      load_cols<2 * RN, FTC>(Bs + (q4 + qq) * BN, tc, b);
#pragma unroll
      for (int i = 0; i < FR; ++i)
#pragma unroll
        for (int j = 0; j < 2 * RN; ++j)
          acc[i][j] = fmaf(a[i][qq], b[j], acc[i][j]);
    }
  }
}

// Depth-major A stage: thread row i is tile row tr * 8 + i, read by float4
// along the rows.
template <int RN>
__device__ __forceinline__ void fma_stage_depthmajor(
    const float* __restrict__ As, const float* __restrict__ Bs, int tr, int tc,
    float (&acc)[RM][RN]) {
  constexpr int BN = RN * TC;
#pragma unroll
  for (int q = 0; q < BK; ++q) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + q * BM + tr * RM);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + q * BM + tr * RM + 4);
    const float a[RM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float b[RN];
    load_cols<RN, TC>(Bs + q * BN, tc, b);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// ---- depth-major stages of k-contiguous operands ------------------------
//
// The g_A kernel multiplies a cotangent tile (rows x depth) by a B block
// (output columns x depth): both are rows of k floats, contiguous along the
// contraction.  A thread's outer product wants, at each depth, a run of its
// rows and a run of its columns side by side, so both operands lie in
// shared memory transposed, depth-major: the resident cotangent tile enters
// by the 4-byte cp.async copies below (once a block), the B stages through
// registers (csrc/window_spmm_bwd.cu).

// dst[q * LD + r] (ROWS rows x `depth`, depth % 8 == 0) <-
// src[(row0 + r) * k + k0 + q], zero where r >= rows_valid or
// k0 + q >= k.  A warp copies 4 rows x 8 depths at a time: four whole
// 32-byte sectors of global memory, and (LD % 32 == 4) the 32 banks of
// shared memory once each.
template <int ROWS, int LD>
__device__ __forceinline__ void load_transposed(float* dst,
                                                const float* __restrict__ src,
                                                int64_t row0, int rows_valid,
                                                int k0, int depth, int k,
                                                int tid) {
  static_assert(LD % 32 == 4 && ROWS % 4 == 0, "LD % 32 == 4");
  const int lane = tid % 32;
  const int dq = depth / 8;  // depth groups of 8
  for (int w = tid / 32; w < (ROWS / 4) * dq; w += NT / 32) {
    const int r = (w / dq) * 4 + lane / 8;
    const int q = (w % dq) * 8 + lane % 8;
    const bool ok = r < rows_valid && k0 + q < k;
    cp_async4(dst + q * LD + r, ok ? src + (row0 + r) * k + k0 + q : src, ok);
  }
}

// Depth-major product with padded strides: acc[i][j] += sum over the BK
// depths q, in ascending order, of As[q * LDA + tr * RMT + i] *
// Bs[q * LDB + col(tc, j)], columns by ColMap<RN, TCOLS> (runs of 4, read by
// float4), rows a run of RMT read by float4.
template <int RMT, int RN, int TCOLS, int LDA, int LDB>
__device__ __forceinline__ void fma_stage_depthmajor_ld(
    const float* __restrict__ As, const float* __restrict__ Bs, int tr,
    int tc, float (&acc)[RMT][RN]) {
  static_assert(RMT % 4 == 0, "rows by float4");
#pragma unroll
  for (int q = 0; q < BK; ++q) {
    float a[RMT];
#pragma unroll
    for (int i = 0; i < RMT; i += 4) {
      const float4 v =
          *reinterpret_cast<const float4*>(As + q * LDA + tr * RMT + i);
      a[i] = v.x, a[i + 1] = v.y, a[i + 2] = v.z, a[i + 3] = v.w;
    }
    float b[RN];
    load_cols<RN, TCOLS>(Bs + q * LDB, tc, b);
#pragma unroll
    for (int i = 0; i < RMT; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// ---- tile store ----------------------------------------------------------

// tile[r * k + col0 + c] = acc, rows < rows_valid and columns < k only.  A
// thread owns NR rows and CN columns (ColMap<CN, TCOLS>).  STRIDED_ROWS:
// thread row i is tile row tr + (BM / NR) * i, else tr * NR + i.  VEC16
// (k % 4 == 0, tile 16-byte aligned) stores runs of 4 as float4.
template <int NR, int CN, int TCOLS, bool STRIDED_ROWS, bool VEC16>
__device__ __forceinline__ void store_tile(float* __restrict__ tile,
                                           int rows_valid, int k, int col0,
                                           int tr, int tc,
                                           const float (&acc)[NR][CN]) {
  using M = ColMap<CN, TCOLS>;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = STRIDED_ROWS ? tr + (BM / NR) * i : tr * NR + i;
    if (r >= rows_valid) continue;
    float* orow = tile + (int64_t)r * k + col0;
    if constexpr (VEC16 && M::VEC == 4) {
#pragma unroll
      for (int run = 0; run < M::RUNS; ++run) {
        const int c = M::col(tc, 4 * run);
        if (col0 + c < k)
          *reinterpret_cast<float4*>(orow + c) =
              make_float4(acc[i][4 * run], acc[i][4 * run + 1],
                          acc[i][4 * run + 2], acc[i][4 * run + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int c = M::col(tc, j);
        if (col0 + c < k) orow[c] = acc[i][j];
      }
    }
  }
}

// ---- partial tiles -> output ---------------------------------------------

__device__ __forceinline__ float add_elems(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add_elems(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// splits[i] = (owner, part_lo, part_hi): output tile `owner` (tile_elems
// contiguous T's) = scratch tiles part_lo .. part_hi - 1 added in that
// order, written once.  A fixed order: two launches give the same bits.
template <typename T>
__global__ void __launch_bounds__(NT)
reduce_partials_kernel(const T* __restrict__ scratch, T* __restrict__ out,
                       const int32_t* __restrict__ splits, int tile_elems) {
  const int owner = splits[3 * blockIdx.x];
  const int p_lo = splits[3 * blockIdx.x + 1];
  const int p_hi = splits[3 * blockIdx.x + 2];
  for (int e = blockIdx.y * NT + threadIdx.x; e < tile_elems;
       e += gridDim.y * NT) {
    T s = scratch[(int64_t)p_lo * tile_elems + e];
    for (int p = p_lo + 1; p < p_hi; ++p)
      s = add_elems(s, scratch[(int64_t)p * tile_elems + e]);
    out[(int64_t)owner * tile_elems + e] = s;
  }
}

// tile_elems floats per tile; both arrays 16-byte aligned
inline int launch_reduce_partials(const float* scratch, float* out,
                                  const int32_t* splits, int n_splits,
                                  int tile_elems, cudaStream_t st) {
  if (n_splits == 0 || tile_elems == 0) return 0;
  if (tile_elems % 4 == 0) {
    const int e4 = tile_elems / 4;
    const dim3 grid(n_splits, (e4 + NT - 1) / NT < 64 ? (e4 + NT - 1) / NT : 64);
    reduce_partials_kernel<float4><<<grid, NT, 0, st>>>(
        reinterpret_cast<const float4*>(scratch),
        reinterpret_cast<float4*>(out), splits, e4);
  } else {
    const dim3 grid(n_splits,
                    (tile_elems + NT - 1) / NT < 64 ? (tile_elems + NT - 1) / NT
                                                    : 64);
    reduce_partials_kernel<float><<<grid, NT, 0, st>>>(scratch, out, splits,
                                                       tile_elems);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same for output tiles that are strided: the tile of `owner` is `rows`
// rows of `row_len` T's at out + owner * row_len, `ldc` apart (a panel's
// columns of C^T); a partial tile is rows * row_len contiguous T's.
template <typename T>
__global__ void __launch_bounds__(NT)
reduce_partials_strided_kernel(const T* __restrict__ scratch,
                               T* __restrict__ out,
                               const int32_t* __restrict__ splits,
                               int row_len, int rows, int64_t ldc) {
  const int owner = splits[3 * blockIdx.x];
  const int p_lo = splits[3 * blockIdx.x + 1];
  const int p_hi = splits[3 * blockIdx.x + 2];
  const int tile_elems = rows * row_len;
  for (int e = blockIdx.y * NT + threadIdx.x; e < tile_elems;
       e += gridDim.y * NT) {
    T s = scratch[(int64_t)p_lo * tile_elems + e];
    for (int p = p_lo + 1; p < p_hi; ++p)
      s = add_elems(s, scratch[(int64_t)p * tile_elems + e]);
    out[(int64_t)owner * row_len + (e / row_len) * ldc + e % row_len] = s;
  }
}

// both arrays 16-byte aligned
inline int launch_reduce_partials_strided(const float* scratch, float* out,
                                          const int32_t* splits, int n_splits,
                                          int row_len, int rows, int64_t ldc,
                                          cudaStream_t st) {
  if (n_splits == 0 || row_len == 0 || rows == 0) return 0;
  const int vec = row_len % 4 == 0 && ldc % 4 == 0 ? 4 : 1;
  const int blocks = (rows * row_len / vec + NT - 1) / NT;
  const dim3 grid(n_splits, blocks < 64 ? blocks : 64);
  if (vec == 4)
    reduce_partials_strided_kernel<float4><<<grid, NT, 0, st>>>(
        reinterpret_cast<const float4*>(scratch),
        reinterpret_cast<float4*>(out), splits, row_len / 4, rows, ldc / 4);
  else
    reduce_partials_strided_kernel<float><<<grid, NT, 0, st>>>(
        scratch, out, splits, row_len, rows, ldc);
  return static_cast<int>(cudaGetLastError());
}

// dynamic shared memory above 48 KB must be asked for; all of the SM's
// shared memory, so that two blocks stay resident
template <typename K>
inline int allow_smem(K kernel, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(e);
}

}  // namespace flex_window
