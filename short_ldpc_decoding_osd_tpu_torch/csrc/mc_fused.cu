// Fused Monte-Carlo frame kernels of the port: K3, K4 and K8.
//
// Replaces the TPU kernels
//   K4  nms_edge_pallas.py _mc_kernel           (entry fused_counters_edge):
//       sample -> encode -> T iterations -> counters;
//   K3  nms_edge_pallas.py _mc_schedule_kernel  (entry
//       fused_counters_edge_compact): the same with convergence compaction
//       per block_frames group and an overflow lane;
//   K8a mc_cascade.py _phase1_kernel, K8b mc_cascade.py _phase2_kernel
//       (entry cascade_counters): t1 iterations for every frame, then T
//       iterations for the flagged ids.
// All of them draw their frames from the counter-based murmur3 hash of
// mc_cascade.py (_mix, _stream_bits, _sample), keyed on (seed, frame id),
// so a frame is the same in every kernel: K4, K3 and K8 decode identical
// frames for one seed.  The TPU kernels of K3/K4 drew from the TPU's
// on-core PRNG instead, which has no counterpart off the TPU.
//
// Two kernels serve the four launches:
//   mc_frames_kernel<STAGE> takes `count` slots; slot i holds frame i, or
//     ids[i] when an id list is given (-1 = padding, counts nothing).  Per
//     frame: hash words -> message bits (one warp ballot per 32 bits) ->
//     codeword bit v = popcount(msg & column v of G) & 1 (exact) -> Box-Muller
//     normal (one per pair, cos only: streams k+1..k+n and k+1+n..k+2n) ->
//     llr = (1-2c)(mean + sigma z) -> `iters` iterations of the shared edge
//     body (nms_edge_body.cuh) -> hard decision soft < 0 -> bit errors and
//     syndrome.
//     COUNT (STAGE=false: K4, K8b, K3's last launch) adds every frame to
//     the counters [frames, frame_err, bit_err, detected, undetected].
//     STAGE (K8a, K3's stage launches) adds only the converged frames
//     (zero syndrome: detected 0, undetected = frame_err) and writes per
//     slot stat = 0 (converged or padding) or 1 | bit_errors << 1 (not
//     converged at this stage).
//   group_rank_kernel (K3 only): one block per block_frames group ranks the
//     group's unconverged slots by an exclusive block-wide scan, writes the
//     first rows_next of them in frame order to the next id list (-1
//     padded), and counts the rest as overflow judged at this stage
//     (frame_err 1, detected 1, lane 5).
// K3 is then: STAGE(t1 on all frames) -> rank -> [STAGE(c_s from scratch)
// -> rank]... -> COUNT(T from scratch on the last list).  Restarting a
// covered frame from scratch computes exactly what resuming its messages
// would (the decode is deterministic), and the hash regenerates its channel
// sample from (seed, frame id), so nothing but ids and stats crosses a
// launch.  A frame converged or overflowed at a stage keeps that stage's
// decision, as in the TPU kernel.
//
// Counters are int32 per block (a block holds a few frames), summed into
// int64 by the wrapper: exact and independent of block order.
//
// What bounds it on H100: no bytes move but the counters (and K3/K8's
// per-frame stats and ids), so every launch is bound by operations: the
// f32 edge arithmetic of the iterations (8 instructions per edge and
// iteration), with ~3n special-function calls per frame for sampling.
// The design keeps a frame's messages in shared memory for all its
// iterations (as K1) and launches only the iterations a frame needs: t1 for
// all, T for the ~1/3 not converged at t1.  Inside a block, a converged
// frame's threads still wait at the block-wide barriers of the body for the
// slowest frame; per-frame barriers are later work.
//
// Built with -fmad=false and the accurate logf/sqrtf/cosf (no fast-math
// intrinsics), so the sample and every step round like the plain PyTorch
// twins in ops/mc_hash.py and ops/nms_edge.py.

#include <cuda_runtime.h>
#include <math.h>

#include "nms_edge_body.cuh"

namespace {

constexpr unsigned kGold1 = 0x9E3779B9u;  // golden-ratio increment
constexpr unsigned kGold2 = 0xB4014E05u;  // odd stream constant (int32 -1274982907)
// counter lanes: frames, frame_err, bit_err, detected, undetected, overflow
constexpr int kLanes = 6;

__device__ __forceinline__ unsigned mix32(unsigned x) {  // murmur3 fmix32
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ unsigned stream_word(unsigned base, int stream) {
  return mix32(base ^ (static_cast<unsigned>(stream) * kGold2));
}

__device__ __forceinline__ float uniform01(unsigned w) {  // top 24 bits
  return static_cast<float>(w >> 8) * (1.0f / 16777216.0f) +
         (0.5f / 16777216.0f);
}

template <bool STAGE>
__global__ void mc_frames_kernel(const int* __restrict__ ids,
                                 int* __restrict__ stat,
                                 int* __restrict__ partials,
                                 const int* __restrict__ edge_col,
                                 const int* __restrict__ var_edges,
                                 const unsigned* __restrict__ gcols, int count,
                                 int n, int m, int dc, int dv, int k, int iters,
                                 int frames_per_block, int threads_per_frame,
                                 unsigned seed, float sigma, float mean,
                                 float w_vc, float w_chk, float w_marg) {
  extern __shared__ float smem[];
  const int num_edges = dc * m;
  const int kw = (k + 31) / 32;
  int* s_edge_col = reinterpret_cast<int*>(smem);  // (dc, m)
  int* s_var_edges = s_edge_col + num_edges;       // (dv, n)
  int* s_count = s_var_edges + dv * n;             // kLanes block counters
  float* s_frames = reinterpret_cast<float*>(s_count + 8);

  for (int i = threadIdx.x; i < num_edges; i += blockDim.x)
    s_edge_col[i] = edge_col[i];
  for (int i = threadIdx.x; i < dv * n; i += blockDim.x)
    s_var_edges[i] = var_edges[i];
  if (threadIdx.x < 8) s_count[threadIdx.x] = 0;

  const int f = threadIdx.x / threads_per_frame;
  const int lt = threadIdx.x - f * threads_per_frame;
  const bool in_block = f < frames_per_block;
  const long long slot = static_cast<long long>(blockIdx.x) * frames_per_block + f;
  int fid = -1;
  if (in_block && slot < count) fid = ids ? ids[slot] : static_cast<int>(slot);
  const bool active = fid >= 0;
  const size_t stride = static_cast<size_t>(num_edges) + 3 * n + kw + 2;
  float* cv = s_frames + static_cast<size_t>(in_block ? f : 0) * stride;
  float* total = cv + num_edges;
  float* x = total + n;                            // channel llr
  int* bits = reinterpret_cast<int*>(x + n);       // bit 0 codeword, bit 1 hard
  unsigned* msg = reinterpret_cast<unsigned*>(bits + n);
  int* flags = reinterpret_cast<int*>(msg + kw);   // bit errors, unconverged
  const unsigned base = mix32(static_cast<unsigned>(fid) * kGold1 + seed);

  if (in_block) {
    for (int e = lt; e < num_edges; e += threads_per_frame) cv[e] = 0.f;
    if (lt < 2) flags[lt] = 0;
    // message bit j is bit 0 of stream j + 1; a warp's ballot packs 32
    // (threads_per_frame is a multiple of 32, so the loop is warp-uniform)
    for (int j0 = 0; j0 < kw * 32; j0 += threads_per_frame) {
      const int j = j0 + lt;
      const bool bit = j < k && (stream_word(base, j + 1) & 1u);
      const unsigned word = __ballot_sync(0xffffffffu, bit);
      if ((lt & 31) == 0 && j < kw * 32) msg[j >> 5] = word;
    }
  }
  __syncthreads();

  if (in_block) {
    for (int v = lt; v < n; v += threads_per_frame) {
      unsigned par = 0;
      for (int w = 0; w < kw; ++w) par ^= __popc(msg[w] & gcols[v * kw + w]);
      const int c = static_cast<int>(par & 1u);
      const float u1 = uniform01(stream_word(base, k + 1 + v));
      const float u2 = uniform01(stream_word(base, k + 1 + n + v));
      const float z = sqrtf(-2.0f * logf(u1)) * cosf(6.283185307179586f * u2);
      const float received = mean + sigma * z;
      x[v] = active ? (1.0f - 2.0f * static_cast<float>(c)) * received : 0.f;
      bits[v] = c;
    }
  }
  __syncthreads();

  nms_edge::iterate(cv, total, x, s_edge_col, s_var_edges, n, m, dc, dv, iters,
                    lt, threads_per_frame, in_block, w_vc, w_chk,
                    [&](int it, int v, float s) {
                      if (it == iters && s + w_marg * x[v] < 0.f) bits[v] |= 2;
                    });
  __syncthreads();

  if (in_block) {
    int errs = 0, odd = 0;
    for (int v = lt; v < n; v += threads_per_frame) {
      const int b = bits[v];
      errs += (b ^ (b >> 1)) & 1;
    }
    for (int c = lt; c < m; c += threads_per_frame) {
      int par = 0;
      for (int j = 0; j < dc; ++j) {
        const int col = s_edge_col[j * m + c];
        if (col >= 0) par ^= bits[col] >> 1;
      }
      odd |= par & 1;
    }
    errs = __reduce_add_sync(0xffffffffu, errs);
    odd = __any_sync(0xffffffffu, odd);
    if ((lt & 31) == 0) {
      if (errs) atomicAdd(&flags[0], errs);
      if (odd) atomicOr(&flags[1], 1);
    }
  }
  __syncthreads();

  if (in_block && lt == 0 && slot < count) {
    const int be = flags[0];
    const int unconv = flags[1];
    const int fe = be > 0;
    if (STAGE) {
      stat[slot] = (active && unconv) ? (1 | (be << 1)) : 0;
      if (active && !unconv) {  // converged: judged here, never detected
        atomicAdd(&s_count[0], 1);
        atomicAdd(&s_count[1], fe);
        atomicAdd(&s_count[2], be);
        atomicAdd(&s_count[4], fe);
      }
    } else if (active) {
      atomicAdd(&s_count[0], 1);
      atomicAdd(&s_count[1], fe);
      atomicAdd(&s_count[2], be);
      atomicAdd(&s_count[3], unconv);
      atomicAdd(&s_count[4], fe && !unconv);
    }
  }
  __syncthreads();
  if (threadIdx.x < kLanes)
    partials[static_cast<size_t>(blockIdx.x) * kLanes + threadIdx.x] =
        s_count[threadIdx.x];
}

__global__ void group_rank_kernel(const int* __restrict__ stat,
                                  const int* __restrict__ ids_in,
                                  int* __restrict__ ids_out,
                                  int* __restrict__ partials, int group_size,
                                  int rows_next) {
  __shared__ int s_warp[32];
  __shared__ int s_count[8];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * group_size;
  // each thread owns a run of consecutive slots, so ranks follow frame order
  const int per = (group_size + blockDim.x - 1) / blockDim.x;
  const int lo = min(group_size, static_cast<int>(threadIdx.x) * per);
  const int hi = min(group_size, lo + per);
  int mine = 0;
  for (int i = lo; i < hi; ++i) mine += stat[base + i] != 0;

  // exclusive block-wide scan of `mine`: warp shuffles, then one warp over
  // the warp totals
  int incl = mine;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  if (threadIdx.x < 8) s_count[threadIdx.x] = 0;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? s_warp[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < nwarps) s_warp[lane] = w;
  }
  __syncthreads();
  int rank = incl - mine + (warp > 0 ? s_warp[warp - 1] : 0);
  const int unconverged = s_warp[nwarps - 1];

  int cnt[kLanes] = {0, 0, 0, 0, 0, 0};
  int* out = ids_out + static_cast<size_t>(blockIdx.x) * rows_next;
  for (int i = lo; i < hi; ++i) {
    const int s = stat[base + i];
    if (!s) continue;
    if (rank < rows_next) {
      out[rank] = ids_in ? ids_in[base + i] : static_cast<int>(base + i);
    } else {  // overflow: judged at this stage, where its syndrome is nonzero
      const int be = s >> 1;
      cnt[0] += 1;
      cnt[1] += be > 0;
      cnt[2] += be;
      cnt[3] += 1;
      cnt[5] += 1;
    }
    ++rank;
  }
  for (int r = unconverged + threadIdx.x; r < rows_next; r += blockDim.x)
    out[r] = -1;
  for (int q = 0; q < kLanes; ++q)
    if (cnt[q]) atomicAdd(&s_count[q], cnt[q]);
  __syncthreads();
  if (threadIdx.x < kLanes)
    partials[static_cast<size_t>(blockIdx.x) * kLanes + threadIdx.x] =
        s_count[threadIdx.x];
}

bool frames_shape(int n, int m, int dc, int dv, int k, int* tpf, int* fpb,
                  size_t* smem) {
  const size_t edges = static_cast<size_t>(dc) * m;
  return nms_edge::launch_shape(n, m, edges + static_cast<size_t>(dv) * n + 8,
                                edges + 3 * static_cast<size_t>(n) +
                                    (k + 31) / 32 + 2,
                                tpf, fpb, smem);
}

}  // namespace

// Frames one block of mc_frames holds (the wrapper sizes the per-block
// counters with it), or -1 when one frame does not fit shared memory.
extern "C" int mc_frames_per_block(int n, int m, int dc, int dv, int k) {
  int tpf, fpb;
  size_t smem;
  return frames_shape(n, m, dc, dv, k, &tpf, &fpb, &smem) ? fpb : -1;
}

// ids: int32 (count,) or NULL (slot i is frame i); stat: int32 (count,) for a
// STAGE launch, NULL for COUNT; partials: int32 (blocks, 6); gcols: uint32
// (n, ceil(k/32)), bit b of word w of column v = G[32w + b, v].
extern "C" int mc_frames(const void* ids, void* stat, void* partials,
                         const void* edge_col, const void* var_edges,
                         const void* gcols, int count, int n, int m, int dc,
                         int dv, int k, int iters, unsigned seed, float sigma,
                         float mean, float w_vc, float w_chk, float w_marg,
                         void* stream) {
  int tpf, fpb;
  size_t smem;
  if (!frames_shape(n, m, dc, dv, k, &tpf, &fpb, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (count + fpb - 1) / fpb;
  if (blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  int* st = static_cast<int*>(stat);
  int* part = static_cast<int*>(partials);
  const int* ec = static_cast<const int*>(edge_col);
  const int* ve = static_cast<const int*>(var_edges);
  const unsigned* gc = static_cast<const unsigned*>(gcols);
  if (st) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(mc_frames_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    mc_frames_kernel<true><<<blocks, fpb * tpf, smem, s>>>(
        id, st, part, ec, ve, gc, count, n, m, dc, dv, k, iters, fpb, tpf,
        seed, sigma, mean, w_vc, w_chk, w_marg);
  } else {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(mc_frames_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    mc_frames_kernel<false><<<blocks, fpb * tpf, smem, s>>>(
        id, st, part, ec, ve, gc, count, n, m, dc, dv, k, iters, fpb, tpf,
        seed, sigma, mean, w_vc, w_chk, w_marg);
  }
  return static_cast<int>(cudaGetLastError());
}

// stat: int32 (groups * group_size,) from a STAGE launch; ids_in: its id list
// or NULL (slot i is frame i); ids_out: int32 (groups, rows_next); partials:
// int32 (groups, 6).
extern "C" int mc_group_rank(const void* stat, const void* ids_in,
                             void* ids_out, void* partials, int groups,
                             int group_size, int rows_next, void* stream) {
  if (groups == 0) return 0;
  int threads = (group_size + 3) / 4;  // about four slots a thread
  threads = (threads + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  group_rank_kernel<<<groups, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(stat), static_cast<const int*>(ids_in),
      static_cast<int*>(ids_out), static_cast<int*>(partials), group_size,
      rows_next);
  return static_cast<int>(cudaGetLastError());
}
