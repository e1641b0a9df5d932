// GAT's per-edge attention for Hopper (sm_90a), plain C interface: one
// head's edge scores and their row-wise softmax, forward and backward
// (ops/edge_softmax.py), over the CSR pattern of the dynamic-value SpMM:
//
//   z[e] = s_src[i] + s_dst[j],  a[e] = z > 0 ? z : slope z   (e = (i, j))
//   alpha[e] = exp(a[e] - max_i) / (sum over row i of exp(a - max_i))
//
// and, from g = dL/dalpha,
//
//   t_i = sum over row i of alpha g,
//   dz[e] = alpha (g - t_i) (z > 0 ? 1 : slope),
//   d_src[i] = sum over row i of dz,  d_dst[j] = sum over column j of dz.
//
// It replaces no TPU kernel: the JAX package computes the softmax in XLA
// (flex_tpu/models/gat.py:edge_softmax, jax.ops.segment_max and
// segment_sum).  The port's plain version (ops/edge_softmax.py:
// edge_attention_plain) takes a scatter max with float atomics, gathers the
// maxima and the row sums back to the edges and reads the row lengths on the
// host, and autograd adds index adds and a segment-reduce backward: about
// six nnz-long float temporaries written and read back a head.
//
// Bound: a few operations an edge against 8 bytes forward and 12 backward
// that the data needs once (spmm_bench/arith_edge_softmax.py): far below
// the card's ridge, so memory.  The design keeps the intermediates out of
// device memory: a row's owner computes its scores from the two m-vectors
// (which stay in L2) and reduces the row's maximum and sums with shuffles.
// The backward writes dz, the one nnz-long temporary, then a second kernel
// sums each column's dz in the transposed order (perm, the dynamic plan's
// stable sort of the edges by column; col_ptr its column runs): one read of
// dz a transposed edge, scattered, which is what this pass costs above the
// bound.  No atomics.
//
// Owners.  A thread holds R = 8 edges.  A row of at most warp_edges (256,
// ops/edge_softmax.py:WARP_EDGES) edges is a warp's (8 rows a block, row =
// 8 b' + warp in the blocks after the long ones): read once, kept in
// registers, reduced by shuffles.  A longer row (the plan lists them,
// long_rows) is a whole block's, in the first blocks of the grid, so that
// it starts first: 256 threads hold 2048 edges, so a row of up to 2048
// edges is read once; a longer one is walked in chunks of 2048, once for
// each pass (maximum, sum, write), its column ids and s_dst read mostly
// from L1 and L2 the second and third time.  The column pass is split the
// same way (long_cols).  On an H100 80GB HBM3 at 700 W, on reddit-gat's
// graph (rbdeg; 56 % of the edges in rows over 256, the longest 19,346),
// a warp a row at any length took 0.35 ms forward and 0.57 backward a
// head: the longest row, one warp walking 76 chunks three times, was the
// critical path (0.22 ms forward alone).  This design takes 0.22 and 0.47
// ms against bytes bounds of 0.057 and 0.085.
//
// Order.  Thread t of a row's T owners (T = 32 or 256) holds edges
// c0 + T r + t (r < R) of each chunk c0 = 0, 8 T, ...: its maximum, sum of
// exp, sum of alpha g and sum of dz run over the chunks in order and over r
// within each; a warp's 32 values are combined by an xor butterfly (offsets
// 16, 8, 4, 2, 1), which gives every lane the same bits, and a block's 8
// warp values in warp order by every thread.  The column pass sums its run
// in the same layout.  Every order is fixed by the pattern, so two launches
// give the same bits.  expf and IEEE division, float32 throughout.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int WARPS = 8;          // warps per block
constexpr int BLOCK = 32 * WARPS;
constexpr int R = 8;              // edges a thread holds
constexpr unsigned FULL = 0xffffffffu;

struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Sum {
  __device__ float operator()(float a, float b) const { return a + b; }
};

// op over the row's T owners; every owner gets the same bits.  T = BLOCK
// combines the warps' values through red (WARPS floats, one array per
// reduction of a kernel, so no reduction waits for another's readers)
template <int T, class Op>
__device__ __forceinline__ float reduce(float v, Op op, float* red) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) v = op(v, __shfl_xor_sync(FULL, v, s));
  if constexpr (T == BLOCK) {
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
    __syncthreads();
    v = red[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v = op(v, red[w]);
  }
  return v;
}

__device__ __forceinline__ float leaky(float z, float slope) {
  return z > 0.f ? z : z * slope;
}

// a[r] = the score of edge c0 + T r + t of the row, -inf past its end (so
// it adds nothing to the maximum, and exp of it adds 0 to the sum)
template <int T>
__device__ __forceinline__ void load_scores(float (&a)[R],
                                            const int32_t* __restrict__ rc,
                                            const float* __restrict__ s_dst,
                                            float si, float slope, int c0,
                                            int len, int t) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = c0 + T * r + t;
    a[r] = j < len ? leaky(si + s_dst[rc[j]], slope) : -CUDART_INF_F;
  }
}

// row i's alpha by its T owners (thread t of them)
template <int T>
__device__ __forceinline__ void fwd_row(
    int i, int t, const int32_t* __restrict__ row_ptr,
    const int32_t* __restrict__ cols, const float* __restrict__ s_src,
    const float* __restrict__ s_dst, float* __restrict__ alpha, float slope,
    float (*red)[WARPS]) {
  const int lo = row_ptr[i];
  const int len = row_ptr[i + 1] - lo;
  const int32_t* rc = cols + lo;
  float* ra = alpha + lo;
  const float si = s_src[i];
  constexpr int CH = T * R;
  const bool once = len <= CH;
  float a[R];
  if (once) load_scores<T>(a, rc, s_dst, si, slope, 0, len, t);

  float mx = -CUDART_INF_F;
  for (int c0 = 0; c0 < len; c0 += CH) {
    if (!once) load_scores<T>(a, rc, s_dst, si, slope, c0, len, t);
#pragma unroll
    for (int r = 0; r < R; ++r) mx = fmaxf(mx, a[r]);
  }
  mx = reduce<T>(mx, Max(), red[0]);
  float sum = 0.f;
  for (int c0 = 0; c0 < len; c0 += CH) {
    if (!once) load_scores<T>(a, rc, s_dst, si, slope, c0, len, t);
#pragma unroll
    for (int r = 0; r < R; ++r) sum += expf(a[r] - mx);
  }
  sum = reduce<T>(sum, Sum(), red[1]);
  for (int c0 = 0; c0 < len; c0 += CH) {
    if (!once) load_scores<T>(a, rc, s_dst, si, slope, c0, len, t);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = c0 + T * r + t;
      if (j < len) ra[j] = expf(a[r] - mx) / sum;
    }
  }
}

// the block's long row, or its warps' short rows (those of at most
// warp_edges edges; a longer one is its own block's)
__global__ void __launch_bounds__(BLOCK)
softmax_fwd_kernel(const int32_t* __restrict__ row_ptr,
                   const int32_t* __restrict__ cols,
                   const int32_t* __restrict__ long_rows, int n_long,
                   int warp_edges,
                   const float* __restrict__ s_src,
                   const float* __restrict__ s_dst,
                   float* __restrict__ alpha, int m, float slope) {
  __shared__ float red[2][WARPS];
  if (static_cast<int>(blockIdx.x) < n_long) {
    fwd_row<BLOCK>(long_rows[blockIdx.x], threadIdx.x, row_ptr, cols, s_src,
                   s_dst, alpha, slope, red);
    return;
  }
  const int i = (blockIdx.x - n_long) * WARPS + threadIdx.x / 32;
  if (i >= m || row_ptr[i + 1] - row_ptr[i] > warp_edges) return;  // warp
  fwd_row<32>(i, threadIdx.x % 32, row_ptr, cols, s_src, s_dst, alpha, slope,
              red);
}

// al[r], gl[r] = alpha and g of edge c0 + T r + t of the row, 0 past its
// end
template <int T>
__device__ __forceinline__ void load_pairs(float (&al)[R], float (&gl)[R],
                                           const float* __restrict__ ra,
                                           const float* __restrict__ rg,
                                           int c0, int len, int t) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = c0 + T * r + t;
    al[r] = j < len ? ra[j] : 0.f;
    gl[r] = j < len ? rg[j] : 0.f;
  }
}

// row i's dz and d_src[i] by its T owners
template <int T>
__device__ __forceinline__ void bwd_row(
    int i, int t, const int32_t* __restrict__ row_ptr,
    const int32_t* __restrict__ cols, const float* __restrict__ alpha,
    const float* __restrict__ g, const float* __restrict__ s_src,
    const float* __restrict__ s_dst, float* __restrict__ dz,
    float* __restrict__ d_src, float slope, float (*red)[WARPS]) {
  const int lo = row_ptr[i];
  const int len = row_ptr[i + 1] - lo;
  const int32_t* rc = cols + lo;
  const float* ra = alpha + lo;
  const float* rg = g + lo;
  float* rz = dz + lo;
  const float si = s_src[i];
  constexpr int CH = T * R;
  const bool once = len <= CH;
  float al[R], gl[R];
  if (once) load_pairs<T>(al, gl, ra, rg, 0, len, t);

  float tt = 0.f;
  for (int c0 = 0; c0 < len; c0 += CH) {
    if (!once) load_pairs<T>(al, gl, ra, rg, c0, len, t);
#pragma unroll
    for (int r = 0; r < R; ++r) tt = fmaf(al[r], gl[r], tt);
  }
  tt = reduce<T>(tt, Sum(), red[0]);
  float acc = 0.f;
  for (int c0 = 0; c0 < len; c0 += CH) {
    if (!once) load_pairs<T>(al, gl, ra, rg, c0, len, t);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = c0 + T * r + t;
      if (j < len) {
        const float z = si + s_dst[rc[j]];
        const float de = al[r] * (gl[r] - tt);
        const float d = z > 0.f ? de : de * slope;
        rz[j] = d;
        acc += d;
      }
    }
  }
  acc = reduce<T>(acc, Sum(), red[1]);
  if (t == 0) d_src[i] = acc;  // 0 for a row with no edges
}

__global__ void __launch_bounds__(BLOCK)
softmax_bwd_rows_kernel(const int32_t* __restrict__ row_ptr,
                        const int32_t* __restrict__ cols,
                        const int32_t* __restrict__ long_rows, int n_long,
                        int warp_edges, const float* __restrict__ alpha,
                        const float* __restrict__ g,
                        const float* __restrict__ s_src,
                        const float* __restrict__ s_dst,
                        float* __restrict__ dz, float* __restrict__ d_src,
                        int m, float slope) {
  __shared__ float red[2][WARPS];
  if (static_cast<int>(blockIdx.x) < n_long) {
    bwd_row<BLOCK>(long_rows[blockIdx.x], threadIdx.x, row_ptr, cols, alpha,
                   g, s_src, s_dst, dz, d_src, slope, red);
    return;
  }
  const int i = (blockIdx.x - n_long) * WARPS + threadIdx.x / 32;
  if (i >= m || row_ptr[i + 1] - row_ptr[i] > warp_edges) return;
  bwd_row<32>(i, threadIdx.x % 32, row_ptr, cols, alpha, g, s_src, s_dst, dz,
              d_src, slope, red);
}

// column c's d_dst by its T owners
template <int T>
__device__ __forceinline__ void bwd_col(int c, int t,
                                        const int32_t* __restrict__ col_ptr,
                                        const int64_t* __restrict__ perm,
                                        const float* __restrict__ dz,
                                        float* __restrict__ d_dst,
                                        float* red) {
  const int lo = col_ptr[c];
  const int len = col_ptr[c + 1] - lo;
  const int64_t* pc = perm + lo;
  float acc = 0.f;
  for (int c0 = 0; c0 < len; c0 += T * R) {
    float v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = c0 + T * r + t;
      v[r] = j < len ? dz[pc[j]] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) acc += v[r];
  }
  acc = reduce<T>(acc, Sum(), red);
  if (t == 0) d_dst[c] = acc;
}

__global__ void __launch_bounds__(BLOCK)
softmax_bwd_cols_kernel(const int32_t* __restrict__ col_ptr,
                        const int32_t* __restrict__ long_cols, int n_long,
                        int warp_edges, const int64_t* __restrict__ perm,
                        const float* __restrict__ dz,
                        float* __restrict__ d_dst, int n) {
  __shared__ float red[WARPS];
  if (static_cast<int>(blockIdx.x) < n_long) {
    bwd_col<BLOCK>(long_cols[blockIdx.x], threadIdx.x, col_ptr, perm, dz,
                   d_dst, red);
    return;
  }
  const int c = (blockIdx.x - n_long) * WARPS + threadIdx.x / 32;
  if (c >= n || col_ptr[c + 1] - col_ptr[c] > warp_edges) return;
  bwd_col<32>(c, threadIdx.x % 32, col_ptr, perm, dz, d_dst, red);
}

// the long rows' blocks, then a block for every WARPS rows
inline dim3 grid_of(int rows, int n_long) {
  return dim3(n_long + (rows + WARPS - 1) / WARPS);
}

}  // namespace

// row_ptr: int32[m + 1] (row i is entries row_ptr[i] .. row_ptr[i + 1]);
// cols: int32[nnz]; long_rows: int32[n_long], each row of more than
// warp_edges edges once (a warp owns every other row); s_src: f32[m];
// s_dst: f32[n]; alpha: f32[nnz], written at every entry.  Returns the
// launch's cudaError_t.
extern "C" int flex_edge_softmax_fwd(const int32_t* row_ptr,
                                     const int32_t* cols,
                                     const int32_t* long_rows, int n_long,
                                     int warp_edges, const float* s_src,
                                     const float* s_dst, float* alpha, int m,
                                     float slope, void* stream) {
  if (m < 0 || n_long < 0 || n_long > m || warp_edges < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  softmax_fwd_kernel<<<grid_of(m, n_long), BLOCK, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      row_ptr, cols, long_rows, n_long, warp_edges, s_src, s_dst, alpha, m,
      slope);
  return static_cast<int>(cudaGetLastError());
}

// The backward's two launches on one stream: the rows (dz: f32[nnz]
// scratch, written at every entry; d_src: f32[m]), then the columns
// (col_ptr: int32[n + 1] over the transposed order; long_cols:
// int32[n_long_cols], each column of more than warp_edges edges; perm:
// int64[nnz], the CSR entry of each transposed entry; d_dst: f32[n]).
// alpha and g: f32[nnz] in CSR order.  Returns the first failing launch's
// cudaError_t.
extern "C" int flex_edge_softmax_bwd(
    const int32_t* row_ptr, const int32_t* cols, const int32_t* long_rows,
    int n_long, const int32_t* col_ptr, const int32_t* long_cols,
    int n_long_cols, int warp_edges, const int64_t* perm, const float* alpha,
    const float* g, const float* s_src, const float* s_dst, float* dz,
    float* d_src, float* d_dst, int m, int n, float slope, void* stream) {
  if (m < 0 || n < 0 || n_long < 0 || n_long > m || n_long_cols < 0 ||
      n_long_cols > n || warp_edges < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m > 0) {
    softmax_bwd_rows_kernel<<<grid_of(m, n_long), BLOCK, 0, st>>>(
        row_ptr, cols, long_rows, n_long, warp_edges, alpha, g, s_src, s_dst,
        dz, d_src, m, slope);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n > 0)
    softmax_bwd_cols_kernel<<<grid_of(n, n_long_cols), BLOCK, 0, st>>>(
        col_ptr, long_cols, n_long_cols, warp_edges, perm, dz, d_dst, n);
  return static_cast<int>(cudaGetLastError());
}
