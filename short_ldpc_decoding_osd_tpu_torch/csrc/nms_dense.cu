// Dense-rung kernels of the port: K6 (decode) and K7 (fused Monte-Carlo).
//
// Replaces the TPU kernels
//   K6  nms_pallas.py _kernel    (entry decode_final_pallas): masked
//       normalized min-sum on a dense (m, n) parity matrix, final soft
//       output colsum + w_marg * llr, shape (B, n);
//   K7  mc_pallas.py _mc_kernel  (entries mc_fused / fused_counters): per
//       frame sample -> encode msg . G mod 2 -> the K6 body for T iterations
//       -> counters [frames, frame_err, bit_err, detected, undetected].
// Both take the parity matrix h (m, n) and, for K7, the generator matrix
// G (k, n) as dense 0/1 float32 tensors on the card, as the TPU kernels take
// traced arrays: nothing is derived from them on the host.
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
// What bounds it on H100: the f32 edge arithmetic of the iterations, as K1
// (K6) and K4 (K7): K6 moves only llr in and the soft output out, K7 only
// its counters.  The bound counts what the function needs (real edges), not
// the dense cells.
//
// Design: the TPU kernel keeps ~12 live (block, m, n) f32 temporaries in
// VMEM; a dense CCSDS frame is 32 KB per temporary, so that layout would fit
// at most 6 frames in a Hopper block.  Instead each block derives K1's slab
// tables from the dense mask once, at launch, into shared memory
// (build_slab: edge_col (dc, m) and var_edges (dv, n), -1 padded, dc and dv
// the largest degrees the block finds), and K7 also G's column bit masks;
// then it runs the shared bodies over real edges only, a frame's messages in
// shared memory for all T iterations.  The block is persistent: it walks
// groups of frames blockIdx.x, +gridDim.x, ... so the derivation is paid
// once per block, not once per frame.
//
// Shared memory is sized by the wrapper for the densest mask of the shape
// (dc = n, dv = m), so any (m, n) mask of that shape fits at least one
// frame; the block itself computes how many frames of the actual mask fit
// (at most kThreads / threads_per_frame) and holds them as K1 and K4 do:
// one group of threads_per_frame threads per frame.  K7's counters are int64
// per block, summed by the wrapper.
//
// Built with -fmad=false and the accurate logf/sqrtf/cosf, so each step
// rounds like the plain PyTorch twins in ops/nms_dense.py and ops/mc_dense.py.

#include <cuda_runtime.h>

#include "mc_frame_body.cuh"
#include "nms_edge_body.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kLanes = 5;   // frames, frame_err, bit_err, detected, undetected
constexpr int kCountWords = 16;  // 8 unsigned long long block counters

struct Slab {
  const int* edge_col;
  const int* var_edges;
  int dc;
  int dv;
  size_t words;  // 4-byte words the tables take, the two degrees included
};

// Derive the slab tables of the dense 0/1 mask h (m, n) into shared memory
// at s: s[0] = dc, s[1] = dv (the largest check and variable degrees), then
// edge_col (dc, m): slot j of check c holds its j-th column in ascending
// order, -1 past its degree; var_edges (dv, n): variable v's edges e = j*m+c
// in ascending check order, -1 past its degree.  Every thread of the block
// must call it (it synchronises).
__device__ Slab build_slab(const float* __restrict__ h, int m, int n, int* s) {
  if (threadIdx.x == 0) s[0] = s[1] = 0;
  __syncthreads();
  for (int c = threadIdx.x; c < m; c += blockDim.x) {
    int d = 0;
    for (int v = 0; v < n; ++v) d += h[static_cast<size_t>(c) * n + v] > 0.f;
    atomicMax(&s[0], d);
  }
  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    int d = 0;
    for (int c = 0; c < m; ++c) d += h[static_cast<size_t>(c) * n + v] > 0.f;
    atomicMax(&s[1], d);
  }
  __syncthreads();
  const int dc = s[0], dv = s[1];
  int* edge_col = s + 2;
  int* var_edges = edge_col + dc * m;
  for (int c = threadIdx.x; c < m; c += blockDim.x) {
    int j = 0;
    for (int v = 0; v < n; ++v)
      if (h[static_cast<size_t>(c) * n + v] > 0.f) edge_col[j++ * m + c] = v;
    for (; j < dc; ++j) edge_col[j * m + c] = -1;
  }
  __syncthreads();
  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    int d = 0;
    for (int c = 0; c < m; ++c) {
      if (h[static_cast<size_t>(c) * n + v] > 0.f) {
        int j = 0;
        while (edge_col[j * m + c] != v) ++j;
        var_edges[d++ * n + v] = j * m + c;
      }
    }
    for (; d < dv; ++d) var_edges[d * n + v] = -1;
  }
  __syncthreads();
  return Slab{edge_col, var_edges, dc, dv,
              2 + static_cast<size_t>(dc) * m + static_cast<size_t>(dv) * n};
}

// Frames a block holds: as many regions of `frame` words as fit the `free`
// words left, at most one per group of threads_per_frame threads (>= 1 by
// the wrapper's sizing).
__device__ __forceinline__ int frames_per_block(size_t free, size_t frame,
                                                int threads_per_frame) {
  const size_t fit = free / frame;
  const int groups = kThreads / threads_per_frame;
  return fit < static_cast<size_t>(groups) ? static_cast<int>(fit) : groups;
}

__global__ void __launch_bounds__(kThreads)
    dense_decode_kernel(const float* __restrict__ h,
                        const float* __restrict__ llr, float* __restrict__ out,
                        int batch, int m, int n, int iters, int smem_words,
                        int threads_per_frame, float w_vc, float w_chk,
                        float w_marg) {
  extern __shared__ int smem[];
  const Slab t = build_slab(h, m, n, smem);
  float* frames = reinterpret_cast<float*>(smem + t.words);
  const size_t stride = static_cast<size_t>(t.dc) * m + 2 * n;
  const int fpb = frames_per_block(smem_words - t.words, stride,
                                   threads_per_frame);
  const int f = threadIdx.x / threads_per_frame;
  const int lt = threadIdx.x - f * threads_per_frame;
  const bool in_block = f < fpb;
  float* cv = frames + static_cast<size_t>(in_block ? f : 0) * stride;
  float* total = cv + t.dc * m;
  float* x = total + n;  // this frame's channel llr
  const long long groups = (static_cast<long long>(batch) + fpb - 1) / fpb;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long frame = g * fpb + f;
    const bool active = in_block && frame < batch;
    if (in_block) {
      for (int e = lt; e < t.dc * m; e += threads_per_frame) cv[e] = 0.f;
      for (int v = lt; v < n; v += threads_per_frame)
        x[v] = active ? llr[frame * n + v] : 0.f;
    }
    __syncthreads();
    nms_edge::iterate<true>(
        cv, total, x, t.edge_col, t.var_edges, n, m, t.dc, t.dv, iters, lt,
        threads_per_frame, in_block, w_vc, w_chk, [&](int it, int v, float s) {
          if (active && it == iters) out[frame * n + v] = s + w_marg * x[v];
        });
    __syncthreads();  // the next group reuses the frame regions
  }
}

__global__ void __launch_bounds__(kThreads)
    dense_mc_kernel(const float* __restrict__ h, const float* __restrict__ g,
                    long long* __restrict__ partials, int count, int m, int n,
                    int k, int iters, int smem_words, int threads_per_frame,
                    unsigned seed, float sigma, float mean, float w_vc,
                    float w_chk, float w_marg) {
  extern __shared__ unsigned long long smem_u64[];
  unsigned long long* s_count = smem_u64;
  if (threadIdx.x < kCountWords / 2) s_count[threadIdx.x] = 0;
  const Slab t = build_slab(h, m, n, reinterpret_cast<int*>(smem_u64) +
                                         kCountWords);
  const int kw = (k + 31) / 32;
  // bit b of word w of column v = G[32 w + b, v]
  unsigned* gcols = reinterpret_cast<unsigned*>(smem_u64) + kCountWords + t.words;
  for (int i = threadIdx.x; i < n * kw; i += blockDim.x) {
    const int v = i / kw;
    const int w = i - v * kw;
    unsigned word = 0;
    for (int b = 0; b < 32; ++b) {
      const int j = 32 * w + b;
      if (j < k && g[static_cast<size_t>(j) * n + v] > 0.f) word |= 1u << b;
    }
    gcols[i] = word;
  }
  __syncthreads();
  float* frames = reinterpret_cast<float*>(gcols + n * kw);
  const size_t stride = mc_frame::frame_words(n, m, t.dc, k);
  const size_t used = kCountWords + t.words + static_cast<size_t>(n) * kw;
  const int fpb = frames_per_block(smem_words - used, stride, threads_per_frame);
  const int f = threadIdx.x / threads_per_frame;
  const int lt = threadIdx.x - f * threads_per_frame;
  const bool in_block = f < fpb;
  float* cv = frames + static_cast<size_t>(in_block ? f : 0) * stride;
  const long long groups = (static_cast<long long>(count) + fpb - 1) / fpb;
  for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long slot = grp * fpb + f;
    const int fid = in_block && slot < count ? static_cast<int>(slot) : -1;
    const int* flags = mc_frame::run<true>(
        cv, t.edge_col, t.var_edges, gcols, fid, in_block, lt,
        threads_per_frame, n, m, t.dc, t.dv, k, iters, seed, sigma, mean, w_vc,
        w_chk, w_marg);
    if (fid >= 0 && lt == 0) {
      const int be = flags[0];
      const int unconv = flags[1];
      const int fe = be > 0;
      atomicAdd(&s_count[0], 1ull);
      atomicAdd(&s_count[1], static_cast<unsigned long long>(fe));
      atomicAdd(&s_count[2], static_cast<unsigned long long>(be));
      atomicAdd(&s_count[3], static_cast<unsigned long long>(unconv));
      atomicAdd(&s_count[4], static_cast<unsigned long long>(fe && !unconv));
    }
    __syncthreads();  // the next group reuses the frame regions
  }
  if (threadIdx.x < kLanes)
    partials[static_cast<size_t>(blockIdx.x) * kLanes + threadIdx.x] =
        static_cast<long long>(s_count[threadIdx.x]);
}

constexpr size_t kSmemLimit = 227 * 1024;

// One thread per variable or check (the larger count, rounded up to a warp,
// at most a block), as K1's launch_shape.
int threads_per_frame(int m, int n) {
  const int t = ((n > m ? n : m) + 31) / 32 * 32;
  return t < kThreads ? t : kThreads;
}

}  // namespace

// Blocks a launch of K6 (mc = 0) or K7 (mc = 1) with `smem` bytes of shared
// memory runs at once on the current device: the grid of a full launch (the
// blocks are persistent).  -1 on an error.
extern "C" int dense_max_blocks(int smem, int mc) {
  if (smem < 0 || static_cast<size_t>(smem) > kSmemLimit) return -1;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  cudaError_t st;
  if (mc) {
    cudaFuncSetAttribute(dense_mc_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dense_mc_kernel,
                                                       kThreads, smem);
  } else {
    cudaFuncSetAttribute(dense_decode_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dense_decode_kernel, kThreads, smem);
  }
  if (st != cudaSuccess || per_sm < 1) return -1;
  return sms * per_sm;
}

// h: float32 (m, n) 0/1; llr, out: float32 (batch, n); smem: bytes, sized by
// the wrapper for the densest (m, n) mask.
extern "C" int dense_decode(const void* h, const void* llr, void* out,
                            int batch, int m, int n, int iters, int smem,
                            int blocks, float w_vc, float w_chk, float w_marg,
                            void* stream) {
  if (smem < 0 || static_cast<size_t>(smem) > kSmemLimit || blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0 || batch == 0) return 0;
  cudaFuncSetAttribute(dense_decode_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dense_decode_kernel<<<blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(llr),
      static_cast<float*>(out), batch, m, n, iters, smem / 4,
      threads_per_frame(m, n), w_vc, w_chk, w_marg);
  return static_cast<int>(cudaGetLastError());
}

// h: float32 (m, n) 0/1; g: float32 (k, n) 0/1; partials: int64 (blocks, 5).
extern "C" int dense_mc(const void* h, const void* g, void* partials,
                        int count, int m, int n, int k, int iters, int smem,
                        int blocks, unsigned seed, float sigma, float mean,
                        float w_vc, float w_chk, float w_marg, void* stream) {
  if (smem < 0 || static_cast<size_t>(smem) > kSmemLimit || blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  cudaFuncSetAttribute(dense_mc_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dense_mc_kernel<<<blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(g),
      static_cast<long long*>(partials), count, m, n, k, iters, smem / 4,
      threads_per_frame(m, n), seed, sigma, mean, w_vc, w_chk, w_marg);
  return static_cast<int>(cudaGetLastError());
}
