// The card-side probes of experiments/ for Hopper (sm_90a), plain C
// interface: four kernels that measure the ceilings kernel 7 (gespmm.cu)
// runs against: gathering single rows by index, gathering rows from a slab
// held on the chip, streaming a multiply-reduce over gathered rows, and the
// largest shared-memory scratch a block can hold.
//
// Kernel 8, row_gather_sum: out[s, :] = sum over i of B[idx[s, i], :].
//   Replaces experiments/micro_dma_u16.py:m3_final (its `kernel`, a 16-deep
//   ring of one-row async copies) and experiments/micro_tpu.py:m3_row_dma
//   (`kernel2`, the same ring 8 deep): a sequential grid step per s, its
//   1024 rows copied HBM -> VMEM one 512-byte DMA at a time.  Here one block
//   runs a step.  Warp w of the block takes the step's rows w, w + 8, ...;
//   a lane owns one float4 column of a row (k <= 128, k % 4 == 0) and
//   copies it with cp.async into the warp's ring of `depth` row stages in
//   shared memory, `depth` rows in flight, the counterpart of the TPU's DMA
//   semaphores.  Each lane reads back only the 16 bytes it copied, so the
//   ring needs no barrier.  The warp's rows are summed in order, then warp
//   0 adds the eight warps' sums in warp order: the plain version sums in
//   that order, so the two agree bit for bit.  Indices come 32 at a time,
//   one coalesced load a lane, two batches ahead of the copies.
//   Bound: bytes, the rows read (once each) and the sums written; each
//   gathered row is 512 B of one random 512-byte read, which HBM serves at
//   a fraction of its streaming rate.
//
// Kernel 9, smem_probe: copies x [8, 128] into the last 4 KB of a dynamic
//   shared-memory scratch of `nbytes` and back out.  Replaces
//   experiments/micro_tpu.py:m6_vmem_probe, which sizes VMEM the same way.
//   The kernel's shared-memory cap is raised once per process and device,
//   to the card's opt-in limit a block (cudaDevAttrMaxSharedMemoryPerBlock-
//   Optin, less static shared memory: allow_optin_smem, which kernels 8 and
//   10 share), so a size above it is refused by the launch itself and that
//   refusal is returned as the launch's error.  Its bytes bound (8 KB) is
//   nothing beside a launch, so the floor it runs against is the same
//   launch of an empty kernel (flex_empty_probe), timed on the card alone
//   by chip_smoke.py.  Each of 256 threads copies one float4: one round
//   trip to memory, where a loop of four scalar copies a thread made four
//   in a row.  On an H100 that leaves it about 0.2 us above the empty
//   launch of its shape and within 0.1 us of x.clone() (PERF.md, section
//   6): below clone at 48 KB, above it by 0.06 us at 227 KB, where the
//   empty launch itself cost 0.17 us more than at 48 KB in one of two runs.
//
// Kernel 10, slab_gather: out[r, :] = slab[idx[r], :] (optionally
//   bf16(slab) widened back to f32) for every flat index r.  Replaces
//   experiments/micro_vmem_gather.py:make (bodies k_take, k_dynslice and
//   k_onehot): the TPU holds the 2 MiB slab [4096, 128] in VMEM and gathers
//   8192 rows a grid step.  One block's 227 KB cannot hold the slab, so two
//   placements:
//     (a) flex_slab_gather_l2: warps gather rows straight from global
//         memory, where the slab stays in the 50 MB L2 after first touch;
//     (b) flex_slab_gather_cluster: a cluster of 16 blocks holds the slab,
//         ceil(U / 16) rows (128 KB at U = 4096, k = 128) in each block's
//         shared memory.  Each block fills its share once, the cluster
//         syncs, and row r is read from rank r / rows_per_block through
//         distributed shared memory (cluster.map_shared_rank).  The grid is
//         as many clusters as cudaOccupancyMaxActiveClusters grants (7 of
//         16 SMs each on an H100 SXM: the 16-block clusters need a whole
//         GPC); the clusters stride over the output rows.
//   A copy: both placements give the plain version's bits.  Bound: bytes,
//   the rows written (the slab and idx read once are small beside them).
//
// Kernel 11, ell_reduce: out[c, :] = sum over j of v[c, j] * Bg[c, j, :],
//   exact f32 (fmaf, j in order).  Replaces
//   experiments/micro_ellreduce.py:pallas_reduce (VPU body `kernel`) and
//   :pallas_reduce_mxu (`mxu_kernel`, the same function as a batched dot at
//   HIGHEST).  A dot of one output row (M = 1) has nothing for a tensor
//   core to share, and the port keeps products exact f32, so there is no
//   tensor-core form.  One warp a row c; a lane owns float4 columns of each
//   128-column slice and streams Bg in 16-byte loads marked evict-first
//   (each byte is read once); v[c, 32 j0 + lane] comes in one load and is
//   shuffled.  Bound: bytes, Bg + v read and out written once.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int GWARPS = 8;      // warps of a kernel 8 block: a step's rows
constexpr int SWARPS = 8;      // warps of a kernel 10 block
constexpr int SUNROLL = 4;     // rows in flight per warp in kernel 10
constexpr int CLUSTER = 16;    // blocks of a kernel 10 cluster
constexpr int RWARPS = 8;      // warps (rows c) of a kernel 11 block

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
}

// The dynamic shared memory `kern` may take, raised once per device (slot
// names the kernel) to the card's opt-in limit a block less the kernel's
// static shared memory; a launch that asks for more is then refused by the
// launch itself.
cudaError_t allow_optin_smem(const void* kern, int slot) {
  static bool done[8][64] = {};
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[slot][dev])) return e;
  cudaFuncAttributes fa;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(fa.sharedSizeBytes));
  if (e != cudaSuccess) return cudaGetLastError(), e;
  if (dev < 64) done[slot][dev] = true;
  return cudaSuccess;
}

// ---------------------------------------------------------------- kernel 8

// lane l of the warp: the index of the warp's row 32 * batch + l (0 past n)
__device__ __forceinline__ int32_t index_batch(const int32_t* my, int warp,
                                               int n, int batch, int lane) {
  const int t = batch * 32 + lane;
  return t < n ? my[warp + t * GWARPS] : 0;
}

template <int DEPTH>
__global__ void __launch_bounds__(GWARPS * 32)
gather_sum_kernel(const float* __restrict__ B, const int32_t* __restrict__ idx,
                  float* __restrict__ out, int rows, int k) {
  extern __shared__ float4 ring[];  // [GWARPS][DEPTH][k / 4]
  __shared__ float4 part[GWARPS][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = k / 4;
  const bool on = lane < q;
  const int32_t* my = idx + static_cast<int64_t>(blockIdx.x) * rows;
  const int n = warp < rows ? (rows - warp + GWARPS - 1) / GWARPS : 0;
  float4* stages = ring + warp * DEPTH * q;

  int32_t cur = index_batch(my, warp, n, 0, lane);
  int32_t nxt = index_batch(my, warp, n, 1, lane);
  // row t of this warp into stage t % DEPTH, one commit group a row (empty
  // past the end, so that wait_group counts stay uniform)
  auto issue = [&](int t) {
    const int32_t r = __shfl_sync(FULL, cur, t % 32);
    if (t < n && on)
      cp_async16(stages + (t % DEPTH) * q + lane,
                 B + static_cast<int64_t>(r) * k + lane * 4);
    cp_async_commit();
    if (t % 32 == 31) {
      cur = nxt;
      nxt = index_batch(my, warp, n, t / 32 + 2, lane);
    }
  };
  for (int t = 0; t < DEPTH; ++t) issue(t);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = 0; t < n; ++t) {
    cp_async_wait<DEPTH - 1>();  // row t has landed
    if (on) add4(acc, stages[(t % DEPTH) * q + lane]);
    issue(t + DEPTH);
  }
  cp_async_wait<0>();
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && on) {
    float4 s = part[0][lane];
#pragma unroll
    for (int w = 1; w < GWARPS; ++w) add4(s, part[w][lane]);
    reinterpret_cast<float4*>(out + static_cast<int64_t>(blockIdx.x) * k)[lane] =
        s;
  }
}

template <int DEPTH>
cudaError_t launch_gather_sum(const float* B, const int32_t* idx, float* out,
                              int n_steps, int rows, int k, cudaStream_t st) {
  const int smem = GWARPS * DEPTH * k * 4;
  const cudaError_t e = allow_optin_smem(
      reinterpret_cast<const void*>(gather_sum_kernel<DEPTH>), DEPTH / 8 - 1);
  if (e != cudaSuccess) return e;
  gather_sum_kernel<DEPTH><<<n_steps, GWARPS * 32, smem, st>>>(B, idx, out,
                                                               rows, k);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- kernel 9

// 256 threads, one float4 of x each: one round trip to memory a thread
__global__ void __launch_bounds__(256)
smem_probe_kernel(const float* __restrict__ x, float4* __restrict__ out,
                  int n_floats) {
  extern __shared__ float4 scratch[];
  float4* last = scratch + (n_floats / 4 - 256);  // the last aligned 4 KB
  const int i = threadIdx.x;
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0)
    last[i] = reinterpret_cast<const float4*>(x)[i];
  else
    last[i] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  __syncthreads();
  out[i] = last[i];
}

// kernel 9's launch with no work: the floor a launch of its shape costs
__global__ void empty_probe_kernel() {}

// --------------------------------------------------------------- kernel 10

template <bool BF16>
__device__ __forceinline__ float4 maybe_round(float4 v) {
  if (BF16) {
    v.x = __bfloat162float(__float2bfloat16_rn(v.x));
    v.y = __bfloat162float(__float2bfloat16_rn(v.y));
    v.z = __bfloat162float(__float2bfloat16_rn(v.z));
    v.w = __bfloat162float(__float2bfloat16_rn(v.w));
  }
  return v;
}

// placement (a): every row from global memory (the slab stays in L2)
template <bool BF16>
__global__ void __launch_bounds__(SWARPS * 32)
slab_gather_l2_kernel(const float4* __restrict__ slab,
                      const int32_t* __restrict__ idx,
                      float4* __restrict__ out, int64_t n_rows, int q) {
  const int lane = threadIdx.x % 32;
  const int64_t nw = static_cast<int64_t>(gridDim.x) * SWARPS;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * SWARPS + threadIdx.x / 32;
  for (int64_t r0 = w0; r0 < n_rows; r0 += nw * SUNROLL) {
    float4 v[SUNROLL];
#pragma unroll
    for (int u = 0; u < SUNROLL; ++u) {
      const int64_t r = r0 + u * nw;
      if (r < n_rows && lane < q)
        v[u] = maybe_round<BF16>(slab[static_cast<int64_t>(idx[r]) * q + lane]);
    }
#pragma unroll
    for (int u = 0; u < SUNROLL; ++u) {
      const int64_t r = r0 + u * nw;
      if (r < n_rows && lane < q) out[r * q + lane] = v[u];
    }
  }
}

// placement (b): the slab spread over a cluster's shared memory
template <bool BF16>
__global__ void __launch_bounds__(SWARPS * 32)
slab_gather_cluster_kernel(const float4* __restrict__ slab,
                           const int32_t* __restrict__ idx,
                           float4* __restrict__ out, int64_t n_rows, int q,
                           int U, int rpb) {
  extern __shared__ float4 share[];  // rows rank * rpb .. + rpb of the slab
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int lo = rank * rpb;
  const int cnt = max(0, min(U - lo, rpb));
  for (int i = threadIdx.x; i < cnt * q; i += blockDim.x)
    share[i] = maybe_round<BF16>(slab[static_cast<int64_t>(lo) * q + i]);
  cl.sync();

  const int lane = threadIdx.x % 32;
  const int64_t nw = static_cast<int64_t>(gridDim.x) * SWARPS;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * SWARPS + threadIdx.x / 32;
  for (int64_t r0 = w0; r0 < n_rows; r0 += nw * SUNROLL) {
    float4 v[SUNROLL];
#pragma unroll
    for (int u = 0; u < SUNROLL; ++u) {
      const int64_t r = r0 + u * nw;
      if (r < n_rows && lane < q) {
        const int s = idx[r];
        const float4* src = cl.map_shared_rank(share, s / rpb);
        v[u] = src[(s % rpb) * q + lane];
      }
    }
#pragma unroll
    for (int u = 0; u < SUNROLL; ++u) {
      const int64_t r = r0 + u * nw;
      if (r < n_rows && lane < q) out[r * q + lane] = v[u];
    }
  }
  cl.sync();  // every share stays alive until the cluster's last read
}

template <bool BF16>
cudaError_t cluster_config(int U, int k, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute* attr, int* n_clusters) {
  const int rpb = (U + CLUSTER - 1) / CLUSTER;
  const int smem = rpb * k * 4;
  auto kern = slab_gather_cluster_kernel<BF16>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = allow_optin_smem(reinterpret_cast<const void*>(kern), BF16 ? 3 : 2);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(SWARPS * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(n_clusters, kern, &cfg);
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

// --------------------------------------------------------------- kernel 11

__global__ void __launch_bounds__(RWARPS * 32)
ell_reduce_kernel(const float* __restrict__ v, const float* __restrict__ Bg,
                  float* __restrict__ out, int N, int w, int k) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * RWARPS + threadIdx.x / 32;
  if (c >= N) return;  // the whole warp leaves together
  const int lane = threadIdx.x % 32;
  const float* vc = v + c * w;
  const float* bc = Bg + c * w * k;
  for (int col0 = 0; col0 < k; col0 += 128) {
    const int col = col0 + lane * 4;
    const bool on = col < k;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 < w; j0 += 32) {
      const float vj = j0 + lane < w ? vc[j0 + lane] : 0.f;
      const int n = min(32, w - j0);
#pragma unroll 8
      for (int t = 0; t < n; ++t) {
        const float s = __shfl_sync(FULL, vj, t);
        if (on) {
          const float4 b = __ldcs(reinterpret_cast<const float4*>(
              bc + static_cast<int64_t>(j0 + t) * k + col));
          acc.x = fmaf(s, b.x, acc.x);
          acc.y = fmaf(s, b.y, acc.y);
          acc.z = fmaf(s, b.z, acc.z);
          acc.w = fmaf(s, b.w, acc.w);
        }
      }
    }
    if (on) *reinterpret_cast<float4*>(out + c * k + col) = acc;
  }
}

}  // namespace

// kernel 8: out [n_steps, k] = per step the sum of B's rows idx[s, 0..rows);
// depth 8 or 16, k % 4 == 0, 0 < k <= 128, 16-byte aligned
extern "C" int flex_row_gather_sum(const float* B, const int32_t* idx,
                                   float* out, int n_steps, int rows, int k,
                                   int depth, void* stream) {
  if (k <= 0 || k > 128 || k % 4 || rows < 0 || n_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_steps == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (depth) {
    case 8: return launch_gather_sum<8>(B, idx, out, n_steps, rows, k, st);
    case 16: return launch_gather_sum<16>(B, idx, out, n_steps, rows, k, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the card's opt-in shared-memory limit of one block, in bytes
extern "C" int flex_smem_optin(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  return static_cast<int>(e);
}

// kernel 9: out [1024] = x [1024] through a scratch of nbytes; out 16-byte
// aligned; a size the card refuses comes back as the launch's error
extern "C" int flex_smem_probe(const float* x, float* out, int nbytes,
                               void* stream) {
  if (nbytes < 4096 || nbytes % 4) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_optin_smem(
      reinterpret_cast<const void*>(smem_probe_kernel), 4);
  if (e != cudaSuccess) return static_cast<int>(e);
  smem_probe_kernel<<<1, 256, nbytes, static_cast<cudaStream_t>(stream)>>>(
      x, reinterpret_cast<float4*>(out), nbytes / 4);
  return static_cast<int>(cudaGetLastError());
}

// kernel 9's launch (one block of 256 threads, nbytes of dynamic shared
// memory) of a kernel that does nothing
extern "C" int flex_empty_probe(int nbytes, void* stream) {
  if (nbytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_optin_smem(
      reinterpret_cast<const void*>(empty_probe_kernel), 5);
  if (e != cudaSuccess) return static_cast<int>(e);
  empty_probe_kernel<<<1, 256, nbytes, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// kernel 10's clusters that fit on the card at once for a slab of U rows of
// k floats (cudaOccupancyMaxActiveClusters; 0 when none fits)
extern "C" int flex_slab_cluster_occupancy(int U, int k, int* n_clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  return static_cast<int>(cluster_config<false>(U, k, cfg, attr, n_clusters));
}

// kernel 10: out [n_rows, k] = slab [U, k] rows idx[0..n_rows), bf16-rounded
// when round_bf16; placement 0 reads through L2, 1 from a cluster's shared
// memory; k % 4 == 0, 0 < k <= 128, 16-byte aligned
extern "C" int flex_slab_gather(const float* slab, const int32_t* idx,
                                float* out, int64_t n_rows, int U, int k,
                                int placement, int round_bf16, void* stream) {
  if (k <= 0 || k > 128 || k % 4 || U <= 0 || n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int q = k / 4;
  const float4* s4 = reinterpret_cast<const float4*>(slab);
  float4* o4 = reinterpret_cast<float4*>(out);
  if (placement == 0) {
    const int64_t want = (n_rows + SWARPS * SUNROLL - 1) / (SWARPS * SUNROLL);
    const int grid = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
    if (round_bf16)
      slab_gather_l2_kernel<true><<<grid, SWARPS * 32, 0, st>>>(s4, idx, o4,
                                                                n_rows, q);
    else
      slab_gather_l2_kernel<false><<<grid, SWARPS * 32, 0, st>>>(s4, idx, o4,
                                                                 n_rows, q);
    return static_cast<int>(cudaGetLastError());
  }
  if (placement != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int n_clusters = 0;
  cudaError_t e = round_bf16 ? cluster_config<true>(U, k, cfg, attr, &n_clusters)
                             : cluster_config<false>(U, k, cfg, attr, &n_clusters);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  cfg.gridDim = dim3(CLUSTER * n_clusters);
  cfg.stream = st;
  const int rpb = (U + CLUSTER - 1) / CLUSTER;
  e = round_bf16 ? cudaLaunchKernelEx(&cfg, slab_gather_cluster_kernel<true>,
                                      s4, idx, o4, n_rows, q, U, rpb)
                 : cudaLaunchKernelEx(&cfg, slab_gather_cluster_kernel<false>,
                                      s4, idx, o4, n_rows, q, U, rpb);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// kernel 11: out [N, k] = per row c, sum over j < w of v[c, j] * Bg[c, j, :];
// k % 4 == 0, 16-byte aligned
extern "C" int flex_ell_reduce(const float* v, const float* Bg, float* out,
                               int N, int w, int k, void* stream) {
  if (N < 0 || w < 0 || k <= 0 || k % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  ell_reduce_kernel<<<(N + RWARPS - 1) / RWARPS, RWARPS * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(v, Bg, out, N, w, k);
  return static_cast<int>(cudaGetLastError());
}
