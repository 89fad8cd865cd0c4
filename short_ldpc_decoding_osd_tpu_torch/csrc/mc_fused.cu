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
//       iterations from scratch for the flagged ids.
// All of them draw their frames from the counter-based murmur3 hash of
// mc_cascade.py (_mix, _stream_bits, _sample), keyed on (seed, frame id),
// so a frame is the same in every kernel: K4, K3 and K8 decode identical
// frames for one seed.  The TPU kernels of K3/K4 drew from the TPU's
// on-core PRNG instead, which has no counterpart off the TPU.
//
// Two kernels serve the four launches:
//   mc_frames_kernel<Bucket, STAGE> takes `count` slots; slot i holds frame
//     i, or ids[i] when an id list is given (-1 = padding, skipped, counts
//     nothing).  Each frame runs the frame body of mc_frame_body.cuh
//     (sample, encode, the iteration body of nms_edge_body.cuh, bit errors
//     and syndrome), which K7 (nms_dense.cu) shares.  A slot starts from
//     zero messages, or, given msgs_in, from the messages saved for it at
//     row src[i] (a resumed frame: its channel values come again from the
//     hash, its decoder state from the row), and runs `iters` iterations.
//     COUNT (STAGE=false: K4, K8b, K3's last launch) adds every frame to
//     the counters [frames, frame_err, bit_err, detected, undetected].
//     STAGE (K8a, K3's stage launches) adds only the converged frames
//     (zero syndrome: detected 0, undetected = frame_err), writes per slot
//     stat = 0 (converged or padding) or 1 | bit_errors << 1 (not converged
//     at this stage) and, given msgs_out, the messages of every unconverged
//     frame to row i of msgs_out (dc*m f32, e = j*m + c).
//   group_rank_kernel (K3 only): one block per block_frames group ranks the
//     group's unconverged slots by an exclusive block-wide scan, writes the
//     first rows_next of them in frame order to the next id list together
//     with their source slot (-1 padded), and counts the rest as overflow
//     judged at this stage (frame_err 1, detected 1, lane 5).
// K3 is then: STAGE(t1 from scratch, saving) -> rank -> [STAGE(c_s more,
// resumed, saving) -> rank]... -> COUNT(the last iterations, resumed), as
// the TPU kernel carries its compacted rows' messages: each frame decodes
// each iteration once.  A frame converged or overflowed at a stage keeps
// that stage's decision, as in the TPU kernel.  K8b keeps its contract:
// flagged ids decoded from scratch, so any frame replays alone.
//
// What bounds it on the H100: no bytes move but the counters, K3/K8's
// per-slot stats and ids and K3's saved messages (2 KB for each CCSDS
// frame unconverged at a stage, written once and read once), so every
// launch is bound by operations: the iterations' f32 edge arithmetic and
// shared-memory message exchange (nms_edge_body.cuh), plus ~3n
// special-function calls per frame for sampling.  The design: a frame on
// one warp (a group of warps for a large code), its checks' messages and
// every table in registers, frame-scoped barriers only; the blocks are
// persistent (one wave of as many as fit the SMs, each group walking slots
// blockIdx.x * frames + group, + gridDim.x * frames, ...), so the tables
// are read into registers once per group, and a frame never waits for
// another.  The iterations a frame needs are all it runs: t1 for all, the
// rest only for the ~1/3 not converged at t1, resumed.  The encode reads G
// by its columns' kinds (mc_frame_body.cuh): the block copies G's encode
// tables (column kinds, word-major parity table) into its shared memory once,
// before its first frame, where they cost no resident block
// (mc_frames_occupancy decides; WiMAX: 4.2 + 19.7 KB beside a 29 KB frame),
// else its frames read them from global memory through the same pointers.
//
// Counters are 64-bit per block in shared memory, added into the (6,)
// int64 output by one atomic per lane and block: exact and independent of
// block order.
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
constexpr int kCountBytes = 8 * 8;  // 8 unsigned long long block counters

template <class Bk, bool STAGE>
__global__ void __launch_bounds__(nms_edge::kMaxThreads, 1)
    mc_frames_kernel(
    const int* __restrict__ ids, const int* __restrict__ src,
    const float* __restrict__ msgs_in, float* __restrict__ msgs_out,
    int* __restrict__ stat, unsigned long long* __restrict__ counters,
    const int* __restrict__ edge_col, const int* __restrict__ var_edges,
    const int* __restrict__ encode, int count, int n, int m, int dc, int dv,
    int k, int p, int iters,
    int warps, int frames, int table_shared, unsigned seed, float sigma,
    float mean, float w_vc, float w_chk, float w_marg,
    const int* __restrict__ split) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* s_count = reinterpret_cast<unsigned long long*>(smem);
  if (threadIdx.x < kLanes) s_count[threadIdx.x] = 0;
  const int T = 32 * warps;
  const size_t words =
      nms_edge::region_words<Bk>(T, mc_frame::extra_words(k));
  // G's encode tables, after the frames' regions (uniform over the block)
  const int* table = encode;
  if (table_shared) {
    int* s_table = reinterpret_cast<int*>(smem + kCountBytes +
                                          4 * frames * words);
    const int size = n + (k + 31) / 32 * p;
    for (int i = threadIdx.x; i < size; i += blockDim.x) s_table[i] = encode[i];
    table = s_table;
  }
  __syncthreads();

  const int g = threadIdx.x / T;
  const int t = threadIdx.x - g * T;
  const unsigned region = kCountBytes + 4u * static_cast<unsigned>(g * words);
  nms_edge::Lane<Bk> L;
  L.setup(region, edge_col, var_edges, split, m, n, dc, dv, t, T, 1 + g);
  const unsigned extra =
      region + 4u * static_cast<unsigned>(nms_edge::region_words<Bk>(T, 0));
  const size_t num_edges = static_cast<size_t>(dc) * m;

  for (long long slot = static_cast<long long>(blockIdx.x) * frames + g;
       slot < count; slot += static_cast<long long>(gridDim.x) * frames) {
    const int fid = ids ? ids[slot] : static_cast<int>(slot);
    if (fid < 0) {  // padding: counts nothing (uniform over the group)
      if (STAGE && t == 0) stat[slot] = 0;
      continue;
    }
    if (msgs_in)
      L.load(msgs_in + static_cast<size_t>(src[slot]) * num_edges, m, dc);
    else
      L.reset();
    const int2 r = mc_frame::run<Bk, false>(L, extra, table, p, fid, n, k,
                                            iters, seed, sigma, mean, w_vc,
                                            w_chk, w_marg);
    const int be = r.x, unconv = r.y, fe = be > 0;
    if (STAGE) {
      if (unconv && msgs_out)
        L.save(msgs_out + static_cast<size_t>(slot) * num_edges, m, dc);
      if (t == 0) {
        stat[slot] = unconv ? (1 | (be << 1)) : 0;
        if (!unconv) {  // converged: judged here, never detected
          atomicAdd(&s_count[0], 1ull);
          atomicAdd(&s_count[1], static_cast<unsigned long long>(fe));
          atomicAdd(&s_count[2], static_cast<unsigned long long>(be));
          atomicAdd(&s_count[4], static_cast<unsigned long long>(fe));
        }
      }
    } else if (t == 0) {
      atomicAdd(&s_count[0], 1ull);
      atomicAdd(&s_count[1], static_cast<unsigned long long>(fe));
      atomicAdd(&s_count[2], static_cast<unsigned long long>(be));
      atomicAdd(&s_count[3], static_cast<unsigned long long>(unconv));
      atomicAdd(&s_count[4], static_cast<unsigned long long>(fe && !unconv));
    }
  }
  __syncthreads();
  if (threadIdx.x < kLanes && s_count[threadIdx.x])
    atomicAdd(&counters[threadIdx.x], s_count[threadIdx.x]);
}

__global__ void group_rank_kernel(const int* __restrict__ stat,
                                  const int* __restrict__ ids_in,
                                  int* __restrict__ ids_out,
                                  int* __restrict__ src_out,
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
  int* from = src_out + static_cast<size_t>(blockIdx.x) * rows_next;
  for (int i = lo; i < hi; ++i) {
    const int s = stat[base + i];
    if (!s) continue;
    if (rank < rows_next) {
      out[rank] = ids_in ? ids_in[base + i] : static_cast<int>(base + i);
      from[rank] = static_cast<int>(base + i);
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
  for (int r = unconverged + threadIdx.x; r < rows_next; r += blockDim.x) {
    out[r] = -1;
    from[r] = -1;
  }
  for (int q = 0; q < kLanes; ++q)
    if (cnt[q]) atomicAdd(&s_count[q], cnt[q]);
  __syncthreads();
  if (threadIdx.x < kLanes)
    partials[static_cast<size_t>(blockIdx.x) * kLanes + threadIdx.x] =
        s_count[threadIdx.x];
}

size_t frames_smem(int bucket, int warps, int frames, int k) {
  size_t words = 0;
  nms_edge::with_bucket(bucket, [&](auto bk) {
    words = nms_edge::region_words<decltype(bk)>(32 * warps,
                                                 mc_frame::extra_words(k));
    return 0;
  });
  return kCountBytes + 4 * frames * words;
}

// Sets the kernel's shared-memory attribute and returns its resident blocks
// per SM (< 1 when it cannot launch), its registers per thread and its
// local-memory bytes per thread (spills).
template <class Bk, bool STAGE>
int occupancy(int threads, size_t smem, int* regs, int* local_bytes) {
  auto kernel = mc_frames_kernel<Bk, STAGE>;
  if (smem > 227 * 1024) return 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return 0;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return 0;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess)
    return 0;
  return per_sm;
}

bool plan_holds(int bucket, int warps, int frames, int m, int n, int dc,
                int dv, int lanes) {
  return nms_edge::with_bucket(bucket, [&](auto bk) {
           return static_cast<int>(nms_edge::plan_holds<decltype(bk)>(
               warps, frames, m, n, dc, dv, lanes));
         }) == 1;
}

}  // namespace

// The launch shape of mc_frames for (bucket, warps a frame, frames a
// block, k message bits, stage, table_words of G's encode tables): out =
// [resident blocks per SM, registers per thread, local bytes per thread,
// shared bytes per block, threads per block, SMs, tables in shared
// memory].  The tables go to shared memory where the block keeps as many
// resident blocks as without them.  Returns 0, or a cudaError_t code when
// the shape cannot launch.
extern "C" int mc_frames_occupancy(int bucket, int warps, int frames, int k,
                                   int stage, int table_words, int* out) {
  if (bucket < 0 || bucket >= nms_edge::kBuckets || warps < 1 ||
      warps > nms_edge::kMaxWarps || frames < 1 ||
      frames > nms_edge::kMaxFrames)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 32 * warps * frames;
  const size_t smem = frames_smem(bucket, warps, frames, k);
  const size_t with_table = smem + 4 * static_cast<size_t>(table_words);
  int regs = 0, local_bytes = 0, dev = 0, sms = 0;
  auto resident = [&](size_t bytes) {
    return nms_edge::with_bucket(bucket, [&](auto bk) {
      using B = decltype(bk);
      return stage ? occupancy<B, true>(threads, bytes, &regs, &local_bytes)
                   : occupancy<B, false>(threads, bytes, &regs, &local_bytes);
    });
  };
  const int per_sm = resident(smem);
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return static_cast<int>(cudaErrorInvalidValue);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool shared = resident(with_table) >= per_sm;
  out[0] = per_sm;
  out[1] = regs;
  out[2] = local_bytes;
  out[3] = static_cast<int>(shared ? with_table : smem);
  out[4] = threads;
  out[5] = sms;
  out[6] = shared;
  return 0;
}

// ids: int32 (count,) or NULL (slot i is frame i); src: int32 (count,) rows
// of msgs_in, with msgs_in f32 (rows, dc*m), or both NULL (from scratch);
// msgs_out: f32 (count, dc*m) or NULL (STAGE only); stat: int32 (count,)
// for a STAGE launch, NULL for COUNT; counters: int64 (6,), zeroed by the
// caller; split: int32 (512 + m,), the lane map of the split bucket
// (ops/nms_edge.py split_map), NULL at another bucket; encode: int32 (n +
// ceil(k/32) p,), G's encode tables with p parity columns (mc_frame::run).
// bucket, warps, frames: the launch plan, lanes: the lanes its checks take
// at the split bucket; grid: resident blocks and table_shared: where the
// tables go (both from mc_frames_occupancy); grid at most enough for
// `count`.
extern "C" int mc_frames(const void* ids, const void* src, const void* msgs_in,
                         void* msgs_out, void* stat, void* counters,
                         const void* edge_col, const void* var_edges,
                         const void* split, const void* encode, int count,
                         int n, int m, int dc, int dv, int k, int p, int iters,
                         int bucket, int warps, int frames, int lanes,
                         int grid, int table_shared, unsigned seed,
                         float sigma, float mean, float w_vc, float w_chk,
                         float w_marg, void* stream) {
  if (!plan_holds(bucket, warps, frames, m, n, dc, dv, lanes) ||
      !nms_edge::split_given(bucket, split) || grid < 0 || p < 0 || p > n ||
      (msgs_in != nullptr) != (src != nullptr) || (msgs_out && !stat))
    return static_cast<int>(cudaErrorInvalidValue);
  if (count == 0 || grid == 0) return 0;
  const int threads = 32 * warps * frames;
  const size_t smem =
      frames_smem(bucket, warps, frames, k) +
      (table_shared ? 4 * (static_cast<size_t>(n) + (k + 31) / 32 * p) : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  const int* sr = static_cast<const int*>(src);
  const float* mi = static_cast<const float*>(msgs_in);
  float* mo = static_cast<float*>(msgs_out);
  int* st = static_cast<int*>(stat);
  auto* cnt = static_cast<unsigned long long*>(counters);
  const int* ec = static_cast<const int*>(edge_col);
  const int* ve = static_cast<const int*>(var_edges);
  const int* sp = static_cast<const int*>(split);
  const int* enc = static_cast<const int*>(encode);
  return nms_edge::with_bucket(bucket, [&](auto bk) {
    using B = decltype(bk);
    auto kernel = st ? mc_frames_kernel<B, true> : mc_frames_kernel<B, false>;
    // the attribute belongs to the kernel, and a launch of another shape
    // (or an occupancy query) may have set it lower
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    kernel<<<grid, threads, smem, s>>>(id, sr, mi, mo, st, cnt, ec, ve, enc,
                                       count, n, m, dc, dv, k, p, iters, warps,
                                       frames, table_shared, seed, sigma, mean,
                                       w_vc, w_chk, w_marg, sp);
    return static_cast<int>(cudaGetLastError());
  });
}

// stat: int32 (groups * group_size,) from a STAGE launch; ids_in: its id list
// or NULL (slot i is frame i); ids_out, src_out: int32 (groups, rows_next),
// the next id list and each entry's slot in the STAGE launch; partials:
// int32 (groups, 6).
extern "C" int mc_group_rank(const void* stat, const void* ids_in,
                             void* ids_out, void* src_out, void* partials,
                             int groups, int group_size, int rows_next,
                             void* stream) {
  if (groups == 0) return 0;
  int threads = (group_size + 3) / 4;  // about four slots a thread
  threads = (threads + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  group_rank_kernel<<<groups, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(stat), static_cast<const int*>(ids_in),
      static_cast<int*>(ids_out), static_cast<int*>(src_out),
      static_cast<int*>(partials), group_size, rows_next);
  return static_cast<int>(cudaGetLastError());
}
