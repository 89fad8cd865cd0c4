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
//     ids[i] when an id list is given (-1 = padding, counts nothing).  Each
//     frame runs the frame body of mc_frame_body.cuh (sample, encode, the
//     shared edge body of nms_edge_body.cuh, bit errors and syndrome), which
//     K7 (nms_dense.cu) shares.
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

#include "mc_frame_body.cuh"

namespace {

// counter lanes: frames, frame_err, bit_err, detected, undetected, overflow
constexpr int kLanes = 6;

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
  const size_t stride = mc_frame::frame_words(n, m, dc, k);
  const int* flags = mc_frame::run<false>(
      s_frames + static_cast<size_t>(in_block ? f : 0) * stride, s_edge_col,
      s_var_edges, gcols, fid, in_block, lt, threads_per_frame, n, m, dc, dv, k,
      iters, seed, sigma, mean, w_vc, w_chk, w_marg);

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
  return nms_edge::launch_shape(
      n, m, static_cast<size_t>(dc) * m + static_cast<size_t>(dv) * n + 8,
      mc_frame::frame_words(n, m, dc, k), tpf, fpb, smem);
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
