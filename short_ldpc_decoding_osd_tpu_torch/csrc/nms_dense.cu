// Dense-rung kernels of the port: K6 (decode) and K7 (fused Monte-Carlo).
//
// Replaces the TPU kernels
//   K6  nms_pallas.py _kernel    (entry decode_final_pallas): masked
//       normalized min-sum on a dense (m, n) parity matrix, final soft
//       output colsum + w_marg * llr, shape (B, n);
//   K7  mc_pallas.py _mc_kernel  (entries mc_fused / fused_counters): per
//       frame sample -> encode msg . G mod 2 -> the K6 body for T iterations
//       -> counters [frames, frame_err, bit_err, detected, undetected].
// Both take the parity matrix h (m, n) as a dense 0/1 float32 tensor on the
// card, as the TPU kernels take traced arrays: nothing is derived from it on
// the host.  K7 takes the generator matrix G by its encode tables (the
// kinds of its columns and its parity columns word-major,
// ops/nms_edge.encode_tables), the operand of K3/K4/K8 too.
//
// Semantics held exactly (nms_pallas.py:46-83): the duplicate-at-minimum
// rule (:71-78) and the zero-aware sign product (:61-69) of the shared edge
// body (nms_edge_body.cuh), with the TPU kernel's magnitude clamp kBig =
// 3.4e38 (the body's kClampBig: a row of degree 1 sends w_chk * kBig);
// (w_vc, w_chk, w_marg) from nms._weights: NMS-1/2/3 and ENMS; NMS-r (neural
// check update) is refused by the Python wrapper.  K7 runs the frame body
// of mc_frame_body.cuh (the hash sampler of mc_hash.cuh keyed on (seed,
// frame id), the encode, the edge body, the count), the one K3/K4/K8 run, so
// K7 and K4 decode the same frames with the same arithmetic for one seed.
// The TPU kernel drew from the TPU's on-core PRNG (and could harvest message
// bits from noise words, SLDPC_MSG_HARVEST); neither has a counterpart off
// the TPU.
//
// What bounds it on H100: the f32 edge arithmetic and shared-memory message
// exchange of the iterations, as K1 (K6) and K4 (K7): K6 moves only llr in
// and the soft output out, K7 only its counters.  The bound counts what the
// function needs (real edges), not the dense cells.
//
// Design: the TPU kernel keeps ~12 live (block, m, n) f32 temporaries in
// VMEM; a dense CCSDS frame is 32 KB per temporary, so that layout would fit
// at most 6 frames in a Hopper block.  Instead each block derives K1's slab
// tables from the dense mask once, at launch, into shared memory
// (build_slab: edge_col (dc, m) and var_edges (dv, n), -1 padded; at the
// split bucket also its lane map, build_split), and K7 copies G's encode
// tables there; then each group of lanes reads its share
// of the tables into registers and runs the shared bodies over real edges
// only (nms_edge_body.cuh: a frame on one warp or a group of warps, each
// check's messages in registers, frame-scoped barriers).  The block is
// persistent: its groups walk frames blockIdx.x * frames + group,
// + gridDim.x * frames, ... so the derivation is paid once per block.
//
// The largest degrees (dc, dv) pick the body's compile-time bucket and size
// the tables; the wrapper reads them from the mask (two reductions on the
// card and one copy of two integers to the host) and passes the launch
// plan.  K7's counters are int64 per block, summed by the wrapper.
//
// Built with -fmad=false and the accurate logf/sqrtf/cosf, so each step
// rounds like the plain PyTorch twins in ops/nms_dense.py and ops/mc_dense.py.

#include <cuda_runtime.h>

#include "mc_frame_body.cuh"
#include "nms_edge_body.cuh"

namespace {

constexpr int kLanes = 5;        // frames, frame_err, bit_err, detected, undetected
constexpr int kCountWords = 16;  // 8 unsigned long long block counters

// Derive the slab tables of the dense 0/1 mask h (m, n), whose row and
// column degrees are at most dc and dv, into shared memory at s: edge_col
// (dc, m): slot j of check c holds its j-th column in ascending order, -1
// past its degree; var_edges (dv, n): variable v's edges e = j*m + c in
// ascending check order, -1 past its degree.  Returns the words written.
// Every thread of the block must call it (it synchronises).
__device__ size_t build_slab(const float* __restrict__ h, int m, int n,
                             int dc, int dv, int* s) {
  int* edge_col = s;
  int* var_edges = edge_col + dc * m;
  for (int c = threadIdx.x; c < m; c += blockDim.x) {
    int j = 0;
    for (int v = 0; v < n && j < dc; ++v)
      if (h[static_cast<size_t>(c) * n + v] > 0.f) edge_col[j++ * m + c] = v;
    for (; j < dc; ++j) edge_col[j * m + c] = -1;
  }
  __syncthreads();
  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    int d = 0;
    for (int c = 0; c < m && d < dv; ++c) {
      if (h[static_cast<size_t>(c) * n + v] > 0.f) {
        int j = 0;
        while (j < dc - 1 && edge_col[j * m + c] != v) ++j;
        var_edges[d++ * n + v] = j * m + c;
      }
    }
    for (; d < dv; ++d) var_edges[d * n + v] = -1;
  }
  __syncthreads();
  return static_cast<size_t>(dc) * m + static_cast<size_t>(dv) * n;
}

// Words of the split bucket's lane map of an m-check code.
__host__ __device__ inline size_t split_words(int m) {
  return nms_edge::kMaxThreads + m;
}

// The split bucket (Bk::kSplit, slots DC a lane) only: the lane map of
// ops/nms_edge.py split_map, from the slab's edge_col (dc, m), at s: entry
// l < kMaxThreads 2 c + h for the lane owning segment h of check c, -1
// for a lane owning none, then entry kMaxThreads + c the first lane of
// check c; the checks of degree above DC first, two lanes each, then the
// others, each in check order.  Returns the words written (0 at another
// bucket).  Every thread of the block must call it (at the split bucket
// it synchronises).
template <class Bk>
__device__ size_t build_split(const int* edge_col, int m, int dc, int* s) {
  if constexpr (!Bk::kSplit) {
    return 0;
  } else {
    for (int l = threadIdx.x; l < nms_edge::kMaxThreads; l += blockDim.x)
      s[l] = -1;
    __syncthreads();
    if (threadIdx.x == 0) {
      int lane = 0;
      for (int pass = 0; pass < 2; ++pass)
        for (int c = 0; c < m; ++c) {
          // slot DC holds an edge exactly when the degree is above DC
          const bool wide = dc > Bk::DC && edge_col[Bk::DC * m + c] >= 0;
          const int span = wide ? 2 : 1;
          if (wide != (pass == 0) || lane + span > nms_edge::kMaxThreads)
            continue;
          s[nms_edge::kMaxThreads + c] = lane;
          s[lane++] = 2 * c;
          if (wide) s[lane++] = 2 * c + 1;
        }
    }
    __syncthreads();
    return split_words(m);
  }
}

template <class Bk>
__global__ void __launch_bounds__(nms_edge::kMaxThreads, 1)
    dense_decode_kernel(const float* __restrict__ h,
                                    const float* __restrict__ llr,
                                    float* __restrict__ out, int batch, int m,
                                    int n, int dc, int dv, int iters,
                                    int warps, int frames, float w_vc,
                                    float w_chk, float w_marg) {
  extern __shared__ __align__(16) int smem_i[];
  size_t table = build_slab(h, m, n, dc, dv, smem_i);
  const int* split = smem_i + table;
  table += build_split<Bk>(smem_i, m, dc, smem_i + table);
  const int T = 32 * warps;
  const int g = threadIdx.x / T;
  const int t = threadIdx.x - g * T;
  const size_t words = nms_edge::region_words<Bk>(T, 0);
  nms_edge::Lane<Bk> L;
  L.setup(4u * static_cast<unsigned>(table + g * words), smem_i,
          smem_i + dc * m, split, m, n, dc, dv, t, T, 1 + g);
  for (long long frame = static_cast<long long>(blockIdx.x) * frames + g;
       frame < batch; frame += static_cast<long long>(gridDim.x) * frames) {
    float x[Bk::VPL];
#pragma unroll
    for (int i = 0; i < Bk::VPL; ++i) {
      const int v = t + T * i;
      x[i] = v < n ? llr[frame * n + v] : 0.f;
    }
    L.reset();
    nms_edge::iterate<Bk, true>(
        L, x, iters, w_vc, w_chk, [&](int it, int i, float s) {
          const int v = t + T * i;
          if (v < n && it == iters) out[frame * n + v] = s + w_marg * x[i];
        });
  }
}

template <class Bk>
__global__ void __launch_bounds__(nms_edge::kMaxThreads, 1)
    dense_mc_kernel(const float* __restrict__ h,
                                const int* __restrict__ encode, int p,
                                long long* __restrict__ partials, int count,
                                int m, int n, int k, int dc, int dv, int iters,
                                int warps, int frames, unsigned seed,
                                float sigma, float mean, float w_vc,
                                float w_chk, float w_marg) {
  extern __shared__ __align__(16) unsigned long long smem_u64[];
  unsigned long long* s_count = smem_u64;
  if (threadIdx.x < kCountWords / 2) s_count[threadIdx.x] = 0;
  int* tables = reinterpret_cast<int*>(smem_u64) + kCountWords;
  size_t table = build_slab(h, m, n, dc, dv, tables);
  const int* split = tables + table;
  table += build_split<Bk>(tables, m, dc, tables + table);
  // G's encode tables (mc_frame::run)
  const int enc = n + (k + 31) / 32 * p;
  int* s_encode = tables + table;
  for (int i = threadIdx.x; i < enc; i += blockDim.x) s_encode[i] = encode[i];
  __syncthreads();
  const int T = 32 * warps;
  const int g = threadIdx.x / T;
  const int t = threadIdx.x - g * T;
  const size_t words = nms_edge::region_words<Bk>(T, mc_frame::extra_words(k));
  const unsigned region =
      4u * static_cast<unsigned>(kCountWords + table + enc + g * words);
  nms_edge::Lane<Bk> L;
  L.setup(region, tables, tables + dc * m, split, m, n, dc, dv, t, T, 1 + g);
  const unsigned extra =
      region + 4u * static_cast<unsigned>(nms_edge::region_words<Bk>(T, 0));
  for (long long slot = static_cast<long long>(blockIdx.x) * frames + g;
       slot < count; slot += static_cast<long long>(gridDim.x) * frames) {
    L.reset();
    const int2 r = mc_frame::run<Bk, true>(L, extra, s_encode, p,
                                           static_cast<int>(slot), n, k, iters,
                                           seed, sigma, mean, w_vc, w_chk,
                                           w_marg);
    if (t == 0) {
      const int be = r.x, unconv = r.y, fe = be > 0;
      atomicAdd(&s_count[0], 1ull);
      atomicAdd(&s_count[1], static_cast<unsigned long long>(fe));
      atomicAdd(&s_count[2], static_cast<unsigned long long>(be));
      atomicAdd(&s_count[3], static_cast<unsigned long long>(unconv));
      atomicAdd(&s_count[4], static_cast<unsigned long long>(fe && !unconv));
    }
  }
  __syncthreads();
  if (threadIdx.x < kLanes)
    partials[static_cast<size_t>(blockIdx.x) * kLanes + threadIdx.x] =
        static_cast<long long>(s_count[threadIdx.x]);
}

constexpr size_t kSmemLimit = 227 * 1024;

// Shared bytes of a K6 (k == 0) or K7 (k message bits, p parity columns of
// G) block.
size_t dense_smem(int bucket, int warps, int frames, int m, int n, int dc,
                  int dv, int k, int p) {
  size_t region = 0;
  nms_edge::with_bucket(bucket, [&](auto bk) {
    region = nms_edge::region_words<decltype(bk)>(
        32 * warps, k ? mc_frame::extra_words(k) : 0);
    return 0;
  });
  size_t words = static_cast<size_t>(dc) * m + static_cast<size_t>(dv) * n +
                 frames * region;
  if (bucket == nms_edge::kSplitBucket) words += split_words(m);
  if (k) words += kCountWords + n + static_cast<size_t>(p) * ((k + 31) / 32);
  return 4 * words;
}

bool dense_plan_holds(int bucket, int warps, int frames, int m, int n, int dc,
                      int dv, int lanes, int k, int p) {
  const bool ok = nms_edge::with_bucket(bucket, [&](auto bk) {
                    return static_cast<int>(nms_edge::plan_holds<decltype(bk)>(
                        warps, frames, m, n, dc, dv, lanes));
                  }) == 1;
  return ok && p >= 0 && p <= n &&
         dense_smem(bucket, warps, frames, m, n, dc, dv, k, p) <= kSmemLimit;
}

template <class Kernel>
int max_blocks(Kernel kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess ||
      per_sm < 1)
    return -1;
  return sms * per_sm;
}

}  // namespace

// Blocks a launch of K6 (k = 0) or K7 (k message bits, p parity columns
// of G) with the plan (bucket, warps a frame, frames a block; lanes: the
// lanes its checks take at the split bucket) on an (m, n) mask of largest
// degrees (dc, dv) runs at once on the current device: the grid of a full
// launch (the blocks are persistent).  -1 when the plan cannot launch.
extern "C" int dense_max_blocks(int bucket, int warps, int frames, int lanes,
                                int m, int n, int dc, int dv, int k, int p) {
  if (!dense_plan_holds(bucket, warps, frames, m, n, dc, dv, lanes, k, p))
    return -1;
  const int threads = 32 * warps * frames;
  const size_t smem = dense_smem(bucket, warps, frames, m, n, dc, dv, k, p);
  return nms_edge::with_bucket(bucket, [&](auto bk) {
    using B = decltype(bk);
    return k ? max_blocks(dense_mc_kernel<B>, threads, smem)
             : max_blocks(dense_decode_kernel<B>, threads, smem);
  });
}

// h: float32 (m, n) 0/1 of largest degrees (dc, dv); llr, out: float32
// (batch, n); blocks: from dense_max_blocks, at most enough for batch.
extern "C" int dense_decode(const void* h, const void* llr, void* out,
                            int batch, int m, int n, int dc, int dv, int iters,
                            int bucket, int warps, int frames, int lanes,
                            int blocks, float w_vc, float w_chk, float w_marg,
                            void* stream) {
  if (!dense_plan_holds(bucket, warps, frames, m, n, dc, dv, lanes, 0, 0) ||
      blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0 || batch == 0) return 0;
  const int threads = 32 * warps * frames;
  const size_t smem = dense_smem(bucket, warps, frames, m, n, dc, dv, 0, 0);
  return nms_edge::with_bucket(bucket, [&](auto bk) {
    using B = decltype(bk);
    cudaFuncSetAttribute(dense_decode_kernel<B>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    dense_decode_kernel<B><<<blocks, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(h), static_cast<const float*>(llr),
        static_cast<float*>(out), batch, m, n, dc, dv, iters, warps, frames,
        w_vc, w_chk, w_marg);
    return static_cast<int>(cudaGetLastError());
  });
}

// h: float32 (m, n) 0/1 of largest degrees (dc, dv); encode: int32 (n +
// ceil(k/32) p,), G's encode tables with p parity columns (mc_frame::run);
// partials: int64 (blocks, 5).
extern "C" int dense_mc(const void* h, const void* encode, int p,
                        void* partials, int count, int m, int n, int k,
                        int dc, int dv, int iters, int bucket, int warps,
                        int frames, int lanes, int blocks, unsigned seed,
                        float sigma, float mean, float w_vc, float w_chk,
                        float w_marg, void* stream) {
  if (k < 1 ||
      !dense_plan_holds(bucket, warps, frames, m, n, dc, dv, lanes, k, p) ||
      blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const int threads = 32 * warps * frames;
  const size_t smem = dense_smem(bucket, warps, frames, m, n, dc, dv, k, p);
  return nms_edge::with_bucket(bucket, [&](auto bk) {
    using B = decltype(bk);
    cudaFuncSetAttribute(dense_mc_kernel<B>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    dense_mc_kernel<B><<<blocks, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(h), static_cast<const int*>(encode), p,
        static_cast<long long*>(partials), count, m, n, k, dc, dv, iters,
        warps, frames, seed, sigma, mean, w_vc, w_chk, w_marg);
    return static_cast<int>(cudaGetLastError());
  });
}
