// Fused TEP-discrepancy parity term (kernel K5 of the port), on the int8
// tensor cores.
//
// Replaces the TPU kernel short_ldpc_decoding_osd_tpu/ops/osd_disc_pallas.py
// _lterm_kernel (entry lterm_pallas):
//
//   lterm[b, t] = sum_m u_l[b, m] * mod2( sum_k M[b, m, k] * T[t, k] )
//
// with M (B, m, k) int8 0/1, u_l (B, m) f32, T (N, k) int8 0/1 and the
// (B, N) f32 result; the (B, m, N) parity intermediate never reaches device
// memory.
//
// What bounds it on H100: 2 B m k N int8 operations at 1,979 TOP/s (412 G
// at the main path's B = 32768, N = 1536, m = k = 64: 0.208 ms; 327 T at
// WiMAX's B = 1024, m = 176, k = 880, N = 102912: 16.5 ms), against the
// compulsory traffic (0.34 GB at the main path: 0.10 ms) and B m N
// weighted adds: it is bound by operations.  Large frames add a second
// limit: every frame meets every TEP, so a kernel that holds a frame reads
// all of T once a frame (94 GB a WiMAX round), which has to come from L2
// (50 MB) at up to 23 bytes a clock an SM, near what L2 gives.
//
// Two plans (ops/osd_disc.py lterm_plan), one per shape of frame:
//
// Resident (m, k <= 64, the main path).  The inner sums are exact small
// integers, so they run as mma.sync m16n8k32 s8 x s8 -> s32 and `acc & 1`
// is the parity.  The MMA's rows are 16 TEPs (A, a tile of T) and its
// columns 8 check rows of one frame (B, M[b] as it lies: row-major (m, k)
// is the "col" operand), so a thread's accumulators are two TEPs x two
// check rows, and the u_l-weighted sum over check rows is a predicated add
// per accumulator plus two quad shuffles.
// - Operands read about once: a block keeps a tile of T (every TEP at the
//   main path, 1536 x 80 bytes) in shared memory for its whole life and
//   walks frames block-strided (persistent), M[b] and u_l[b] streamed in by
//   cp.async (16-byte chunks, zero-filled padding) into two buffers, the
//   next frame landing while this one computes.  Fragments come from
//   shared memory by ldmatrix (rows padded by 16 bytes, so conflict-free).
// - A warp loads a frame's B fragments and u_l once and runs every TEP
//   tile it owns against them, reading only A (64 bytes of shared memory
//   per MMA).  k is padded with zeros to 64, m with zero rows whose u is 0,
//   the ragged N and B edges are masked.
//
// General (any m > 64 or k > 64; m <= 256): frame-stationary, the TEPs
// streamed.  A block (persistent, one an SM) takes units of work, each one
// frame against one chunk of TEP tiles; it stages the frame's M once per
// unit into shared memory (m padded to a multiple of 16 with zero rows and
// u = 0, k to the plan's k-slice of 32, 64 or 128 bytes), in the swizzled
// K-major layout that wgmma reads, and runs every TEP of the chunk against
// it.  M is read from device memory once a unit instead of once per TEP
// tile, and T streams through the SMs in the same order on every block, so
// a wave of blocks reads each T tile from HBM about once.
// - Warp specialisation: two producer warps each drive a ring of stages (a
//   stage: 64 TEPs x one k-slice, brought by one TMA load with the same
//   swizzle, zero-filled beyond N and k, completion on an mbarrier); two
//   consumer warpgroups each own one ring and every other TEP tile of the
//   block's sequence.  A consumer issues wgmma.m64nNk32.s32.s8.s8 with A
//   the stage (64 TEPs) and B the frame (N = m_pad check rows, one
//   instruction a 32-byte k step), one commit group a k-slice, two groups
//   left in flight while it issues the next; a stage is freed once its
//   group is done.  The two warpgroups issue freely: while one runs its
//   epilogue the other's wgmmas use the tensor cores.  (Taking turns by
//   named barriers, a tile or half a tile a turn, or staggering their
//   starts, measured 8-26% slower at WiMAX's shape: one warpgroup alone
//   does not keep the tensor cores fed.)  The wgmma accumulator layout is
//   the mma.sync one repeated over 8-column groups, so the epilogue is the
//   resident plan's.
// - Nothing depends on the bits of T or M: every tile is multiplied whole.
// - T's traffic is not what bounds it: loading every tile from the same
//   few rows of T (all from L2) left the time unchanged, so the TEP tiles
//   are not multicast across a cluster.
// - A frame whose padded M does not fit beside two rings of three stages
//   is refused by the plan.
//
// Block minima (the second entry, block_minima_*): the same mainloops, and
// an epilogue that finishes the discrepancy map and reduces it, so that only
// the (B, P) block minima and first argmins leave the kernel.  Per (frame b,
// TEP t) it rounds the parity sum l to f32 as above and forms
// d = (c0[b] + l) + mrb(b, t) in IEEE f32 in that order, mrb(b, t) = u_m[b] . t
// summed in f32 over t's set columns in ascending order.  Those come from a
// per-TEP position list (CSR), whose head (offset, count and the first three
// columns: the path's TEPs have 1-3) is one 16-byte load issued before the
// tile's MMAs; it is exact for any T, a long list read on from the CSR.  A
// TEP in no block (the mask, past the real TEPs) is skipped.  Each lane
// keeps a running minimum of the 64-bit key (order-preserving bits << 32 |
// flat index) over its TEPs of one block, and atomicMin's it into the
// block's key when it moves to another block and at the end of the frame:
// the smallest d, the first index on ties (-0 counted as +0, as == does).
// Where one block holds all of a frame's TEPs (the resident plan with one
// tile) the keys close in shared memory, two buffers a frame apart, and the
// block writes the decoded minima and block-local argmins; otherwise into a
// (B, P) key array in device memory, filled before the launch and decoded
// after it (minima_decode).  Either way the result does not depend on the
// order of arrival.  An empty block reads (3.4e38, 0), as engine._BIG.
//
// Summation order, all in f64 and the same in both plans: a thread adds its
// check rows 8j + 2t and 8j + 2t + 1 in two chains over ascending j (then
// row 2t's chain plus row 2t + 1's), the quad adds lanes t^1 then t^2, and
// the sum is rounded once to f32.  Every term is an exact f32 value, so the
// result is the exact sum rounded (up to f64 rounding, ~1e-16 relative):
// its difference from the plain twin is the twin's own f32 rounding.  An
// f32 sum is faster (about a third of the kernel at the main path on an
// H100) and gives that up.

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // 227 KB, the opt-in limit of a block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// d += A (16 x 32 s8, row) * B (32 x 8 s8, col), s32 accumulators
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows [0, rows_pad) of a (rows, k) int8 matrix into shared memory at row
// stride S, zero beyond (rows, k) up to (rows_pad, k_pad); 16-byte cp.async
// when the rows are 16-byte aligned (vec), else byte loads and 4-byte stores
__device__ void stage_rows(int8_t* dst, const int8_t* src, int rows, int k,
                           int rows_pad, int k_pad, int S, bool vec) {
  if (vec) {
    const int cpr = k_pad / 16;
    for (int i = threadIdx.x; i < rows_pad * cpr; i += kThreads) {
      const int r = i / cpr;
      const int c = i - r * cpr;
      const bool in = r < rows && c * 16 < k;
      const int8_t* from = in ? src + static_cast<long long>(r) * k + c * 16
                              : src;
      cp_async16(smem_addr(dst + r * S + c * 16), from, in ? 16 : 0);
    }
  } else {
    const int wpr = k_pad / 4;
    for (int i = threadIdx.x; i < rows_pad * wpr; i += kThreads) {
      const int r = i / wpr;
      const int c = (i - r * wpr) * 4;
      uint32_t word = 0u;
      if (r < rows) {
        const int8_t* row = src + static_cast<long long>(r) * k;
        for (int q = 0; q < 4 && c + q < k; ++q)
          word |= static_cast<uint32_t>(static_cast<uint8_t>(row[c + q]))
                  << (8 * q);
      }
      *reinterpret_cast<uint32_t*>(dst + r * S + c) = word;
    }
  }
}

// s += u where the parity bit of acc is set: a predicate and a predicated
// f64 add (no select, no branch)
__device__ __forceinline__ void add_if_odd(double& s, int acc, double u) {
  asm("{\n"
      "  .reg .pred p;\n"
      "  .reg .b32 t;\n"
      "  and.b32 t, %1, 1;\n"
      "  setp.ne.b32 p, t, 0;\n"
      "  @p add.f64 %0, %0, %2;\n"
      "}\n"
      : "+d"(s)
      : "r"(acc), "d"(u));
}

// A thread's partials: TEP g (s[0], s[1]) and g + 8 (s[2], s[3]), each
// split by the parity of its check-row column into two independent f64
// chains.
struct Partials {
  double s[4] = {0.0, 0.0, 0.0, 0.0};

  // the parity-weighted terms of one 8-row tile's accumulators
  __device__ __forceinline__ void weigh(const int (&acc)[4], double2 u) {
    add_if_odd(s[0], acc[0], u.x);
    add_if_odd(s[1], acc[1], u.y);
    add_if_odd(s[2], acc[2], u.x);
    add_if_odd(s[3], acc[3], u.y);
  }

  // the quad's sums for TEPs g (s0) and g + 8 (s1), in every lane of it
  __device__ __forceinline__ void sums(double& s0, double& s1) const {
    s0 = s[0] + s[1];
    s1 = s[2] + s[3];
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
  }

  // the quad's sum for TEPs g and g + 8, rounded once; lanes t = 0 and 1
  // write 16 consecutive floats
  __device__ __forceinline__ void finish(float* outrow, int tep0, int lane,
                                        int ntot) const {
    double s0, s1;
    sums(s0, s1);
    const int g = lane >> 2, t = lane & 3;
    if (t == 0 && tep0 + g < ntot) outrow[tep0 + g] = __double2float_rn(s0);
    if (t == 1 && tep0 + g + 8 < ntot)
      outrow[tep0 + g + 8] = __double2float_rn(s1);
  }
};

// ---------------------------------------------------------------------------
// The block-minima epilogue.

// What the block-minima instantiations read and write beyond lterm's
// operands (all zero for lterm's).
struct MinimaArgs {
  const float* c0;           // (batch,)
  const float* um;           // (batch, k)
  const int4* heads;         // (ntot,): TEP t's position list (o, n, c0 |
                             //   c1 << 16, c2), its first three columns
  const int16_t* cols;       //   of cols[o .. o + n), ascending
  const int* block_of;       // (ntot,): t's block, -1 where it has none
  const long long* starts;   // (blocks,): each block's first flat index
  long long* keys;           // (batch, blocks) running keys; null: direct
  float* minima;             // (batch, blocks), written where direct
  long long* argmins;        // (batch, blocks), written where direct
  int blocks;
  int nreal;                 // TEPs at or past it are skipped
};

constexpr long long kNoKey = 0x7fffffffffffffffLL;  // a block with no TEP
constexpr float kBig = 3.4e38f;                     // osd/engine.py _BIG

// f32 bits as an int that orders as the floats do, -0 as +0 (an involution
// on the bits: the same map decodes)
__device__ __forceinline__ int order_bits(int i) {
  return i ^ ((i >> 31) & 0x7fffffff);
}

__device__ __forceinline__ void decode_key(long long key, long long start,
                                           float& v, long long& a) {
  if (key == kNoKey) {
    v = kBig;
    a = 0;
    return;
  }
  v = __int_as_float(order_bits(static_cast<int>(key >> 32)));
  a = static_cast<long long>(static_cast<unsigned>(key & 0xffffffffLL)) - start;
}

// A lane's TEP (lanes t = 0, 1 of a quad; none for t = 2, 3), its block
// (-1: none) and the head of its position list: two independent loads,
// issued before the tile's MMAs so that the epilogue does not wait on them.
struct TepPos {
  int tep, blk;
  int4 head;

  __device__ __forceinline__ void load(const MinimaArgs& ma, int t,
                                       bool mine) {
    tep = t;
    blk = -1;
    head = make_int4(0, 0, 0, 0);
    if (mine && t < ma.nreal) {
      blk = __ldg(ma.block_of + t);
      head = __ldg(ma.heads + t);
    }
  }

  // u_m . t in f32 (s_um the frame's u_m), the set columns in ascending
  // order: the first three from the head, the rest from the list
  __device__ __forceinline__ float mrb(const MinimaArgs& ma,
                                       const float* s_um) const {
    const int n = head.y;
    float s = 0.f;
    if (n > 0) s = s_um[head.z & 0xffff];
    if (n > 1) s = __fadd_rn(s, s_um[head.z >> 16]);
    if (n > 2) s = __fadd_rn(s, s_um[head.w]);
    for (int j = head.x + 3; j < head.x + n; ++j)
      s = __fadd_rn(s, s_um[__ldg(ma.cols + j)]);
    return s;
  }
};

// A lane's running minimum key (order bits << 32 | TEP) over the TEPs it
// holds of one block: folded into keys[block] (shared or device memory) by
// atomicMin when the lane meets another block, and by flush() at the end of
// the frame's TEPs.  The lane's TEPs ascend, so it changes block a few times
// a frame, and the fold asks nothing of the other lanes.  (Folding each
// tile's 16 TEPs across the warp instead, by match_any and redux, measured
// 13% slower at the main path and 9% at WiMAX's shape; combining the lanes
// that fold at once, 15% and 1% slower, or at the frame's end alone, 3% and
// 0%.)
struct RunMin {
  int blk = -1;
  long long key = kNoKey;

  // the discrepancy d (l rounded from the parity sum s, plus the frame's c0
  // and the TEP's mrb) of the lane's TEP pos
  __device__ __forceinline__ void add(const MinimaArgs& ma, const TepPos& pos,
                                      const float* s_um, float c0f, double s,
                                      long long* keys) {
    if (pos.blk < 0) return;
    const float l = __double2float_rn(s);
    const float d = __fadd_rn(__fadd_rn(c0f, l), pos.mrb(ma, s_um));
    const int ord = order_bits(__float_as_int(d == 0.f ? 0.f : d));
    const long long k = static_cast<long long>(
        (static_cast<unsigned long long>(static_cast<unsigned>(ord)) << 32) |
        static_cast<unsigned>(pos.tep));
    if (pos.blk != blk) {
      flush(keys);
      blk = pos.blk;
      key = k;
    } else if (k < key) {
      key = k;
    }
  }

  __device__ __forceinline__ void flush(long long* keys) {
    if (blk >= 0) atomicMin(keys + blk, key);
    blk = -1;
  }
};

// one frame, resident: the frame's 8 * TN rows x 32 * KCH bytes of B
// fragments and its u in registers, every TEP tile of the warp against them;
// lterm writes the tiles' sums to outrow (the warp's tiles warp, warp + 16,
// ...); block minima fold them into keys (the frame's u_m s_umf, its c0f),
// the warp's tiles contiguous, so that a lane's TEPs stay in a block long
// (lanes t = 0 and 1 hold TEPs g and g + 8 of each tile)
template <int KCH, int TN, bool kMinima>
__device__ __forceinline__ void frame_resident(
    const int8_t* s_t, const int8_t* s_mf, const double* s_uf, float* outrow,
    int S, int nt0, int ntot, int tiles, const MinimaArgs& ma,
    const float* s_umf, float c0f, long long* keys) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  uint32_t bf[TN][KCH][2];
  const int brow = (lane & 7) + 8 * (lane >> 4);
  const int bcol = 16 * ((lane >> 3) & 1);
#pragma unroll
  for (int jj = 0; jj < TN / 2; ++jj)
#pragma unroll
    for (int kc = 0; kc < KCH; ++kc)
      ldsm_x4(smem_addr(s_mf + (16 * jj + brow) * S + 32 * kc + bcol),
              bf[2 * jj][kc][0], bf[2 * jj][kc][1], bf[2 * jj + 1][kc][0],
              bf[2 * jj + 1][kc][1]);
  double2 uu[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j)
    uu[j] = *reinterpret_cast<const double2*>(s_uf + 8 * j + 2 * t);
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int acol = 16 * (lane >> 4);
  int lo = warp, hi = tiles, step = kWarps;
  if constexpr (kMinima) {
    const int per = (tiles + kWarps - 1) / kWarps;
    lo = warp * per;
    hi = min(tiles, lo + per);
    step = 1;
  }
  TepPos pos;
  RunMin run;
  for (int tile = lo; tile < hi; tile += step) {
    if constexpr (kMinima)
      pos.load(ma, nt0 + 16 * tile + (lane >> 2) + 8 * t, t < 2);
    uint32_t af[KCH][4];
#pragma unroll
    for (int kc = 0; kc < KCH; ++kc)
      ldsm_x4(smem_addr(s_t + (16 * tile + arow) * S + 32 * kc + acol),
              af[kc][0], af[kc][1], af[kc][2], af[kc][3]);
    Partials part;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int kc = 0; kc < KCH; ++kc)
        mma_s8(acc, af[kc], bf[j][kc][0], bf[j][kc][1]);
      part.weigh(acc, uu[j]);
    }
    if constexpr (kMinima) {
      double s0, s1;
      part.sums(s0, s1);
      run.add(ma, pos, s_umf, c0f, t == 0 ? s0 : s1, keys);
    } else {
      part.finish(outrow, nt0 + 16 * tile, lane, ntot);
    }
  }
  if constexpr (kMinima) run.flush(keys);
}

// frame f's keys of the block's TEPs (s_key), then reset: decoded into the
// outputs where the block holds all of the frame's TEPs, else folded into the
// device keys
__device__ void flush_minima(const MinimaArgs& ma, long long* s_key,
                             long long f) {
  for (int p = threadIdx.x; p < ma.blocks; p += kThreads) {
    const long long key = s_key[p];
    s_key[p] = kNoKey;
    if (ma.keys == nullptr) {
      decode_key(key, ma.starts[p], ma.minima[f * ma.blocks + p],
                 ma.argmins[f * ma.blocks + p]);
    } else if (key != kNoKey) {
      atomicMin(ma.keys + f * ma.blocks + p, key);
    }
  }
}

// the resident plan: m_pad == 8 TN, k_pad == 32 KCH.  Shared memory: the
// TEP tile, nbuf frames of M, their u as f64, and for block minima two
// buffers of keys (frames i and i - 1) and nbuf frames' u_m as f32.
template <int KCH, int TN, bool kMinima>
__global__ void __launch_bounds__(kThreads, 1)
    lterm_kernel(const int8_t* __restrict__ mm, const float* __restrict__ ul,
                 const int8_t* __restrict__ tt, float* __restrict__ out,
                 int batch, int m, int k, int ntot, int m_pad, int k_pad,
                 int nt, int nbuf, int vec, const MinimaArgs ma) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = k_pad + 16;
  int8_t* s_t = reinterpret_cast<int8_t*>(smem);     // nt rows of T
  int8_t* s_m = s_t + nt * S;                        // nbuf frames of M
  double* s_u = reinterpret_cast<double*>(s_m + nbuf * m_pad * S);
  long long* s_key = reinterpret_cast<long long*>(s_u + nbuf * m_pad);
  float* s_um = reinterpret_cast<float*>(s_key + 2 * ma.blocks);
  const int tid = threadIdx.x;
  const int nt0 = blockIdx.y * nt;
  const int teps_here = min(nt, ntot - nt0);
  const int tiles = (teps_here + 15) / 16;
  const long long frame_bytes = static_cast<long long>(m) * k;
  const long long step = gridDim.x;

  long long f = blockIdx.x;
  stage_rows(s_t, tt + static_cast<long long>(nt0) * k, teps_here, k, nt,
             k_pad, S, vec);
  if (f < batch) stage_rows(s_m, mm + f * frame_bytes, m, k, m_pad, k_pad, S,
                            vec);
  cp_async_commit();
  if (tid < m_pad)
    s_u[tid] = (f < batch && tid < m) ? static_cast<double>(ul[f * m + tid])
                                      : 0.0;
  if constexpr (kMinima) {
    for (int p = tid; p < 2 * ma.blocks; p += kThreads) s_key[p] = kNoKey;
    if (tid < k_pad) s_um[tid] = (f < batch && tid < k) ? ma.um[f * k + tid] : 0.f;
  }

  int i = 0;
  for (; f < batch; ++i, f += step) {
    const int cur = nbuf == 2 ? (i & 1) : 0;
    cp_async_wait_all();
    __syncthreads();  // frame f landed; every warp is done with frame f - step
    if constexpr (kMinima)
      if (i > 0) flush_minima(ma, s_key + ((i - 1) & 1) * ma.blocks, f - step);
    const long long fn = f + step;
    float u_next = 0.f, um_next = 0.f;
    if (nbuf == 2) {
      if (fn < batch)
        stage_rows(s_m + (cur ^ 1) * m_pad * S, mm + fn * frame_bytes, m, k,
                   m_pad, k_pad, S, vec);
      cp_async_commit();
      if (tid < m && fn < batch) u_next = ul[fn * m + tid];
      if constexpr (kMinima)
        if (tid < k && fn < batch) um_next = ma.um[fn * k + tid];
    }
    const int8_t* s_mf = s_m + cur * m_pad * S;
    const double* s_uf = s_u + cur * m_pad;
    float* outrow = kMinima ? nullptr : out + f * ntot;
    frame_resident<KCH, TN, kMinima>(
        s_t, s_mf, s_uf, outrow, S, nt0, ntot, tiles, ma, s_um + cur * k_pad,
        kMinima ? ma.c0[f] : 0.f, s_key + (i & 1) * ma.blocks);
    if (nbuf == 2) {
      if (tid < m_pad) s_u[(cur ^ 1) * m_pad + tid] = u_next;
      if constexpr (kMinima)
        if (tid < k_pad) s_um[(cur ^ 1) * k_pad + tid] = um_next;
    } else {
      __syncthreads();  // every warp is done with the one buffer
      if (fn < batch)
        stage_rows(s_m, mm + fn * frame_bytes, m, k, m_pad, k_pad, S, vec);
      cp_async_commit();
      if (tid < m_pad)
        s_u[tid] = (fn < batch && tid < m)
                       ? static_cast<double>(ul[fn * m + tid]) : 0.0;
      if constexpr (kMinima)
        if (tid < k_pad)
          s_um[tid] = (fn < batch && tid < k) ? ma.um[fn * k + tid] : 0.f;
    }
  }
  cp_async_wait_all();
  if constexpr (kMinima) {
    __syncthreads();  // every warp is done with the last frame
    if (i > 0) flush_minima(ma, s_key + ((i - 1) & 1) * ma.blocks, f - step);
  }
}


// ---------------------------------------------------------------------------
// The general plan: frame-stationary, TEPs streamed by TMA into wgmma.

constexpr int kGenThreads = 320;  // consumer warpgroups 0-1, producer warps 8-9
constexpr int kTepTile = 64;      // TEPs a wgmma tile (its M)
// wgmma groups (one a k-slice) a consumer leaves in flight while it issues
// the next, so a ring needs kLookahead + 1 stages at least (ops/osd_disc.py
// MIN_STAGES); at WiMAX's shape 1 and 3 took 8% and 20% longer than 2
constexpr int kLookahead = 2;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed; a
// wait of 2^26 polls (far beyond any stage's latency) traps instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  for (int polls = 0; !done; ++polls) {
    if (polls == (1 << 26)) __trap();
    asm volatile(
        "{\n"
        "  .reg .pred p;\n"
        "  mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "  selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// rows [row, row + 64) x bytes [col, col + box width) of the TEPs, by TMA
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_addr(bar))
      : "memory");
}

// a wgmma shared-memory descriptor: K-major, swizzled rows of `row_bytes`
// (32, 64 or 128), 8-row groups `8 row_bytes` apart
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, int row_bytes) {
  const uint64_t layout = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * row_bytes) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma
template <int kR>
__device__ __forceinline__ void fence_regs(int (&d)[kR]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x kN s32, wgmma fragment) += A (64 x 32 s8) * B (kN x 32 s8)^T,
// both K-major in shared memory; one instruction, its operand list spelled
// out for each width
#define K5_O0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define K5_O1 "%8, %9, %10, %11, %12, %13, %14, %15"
#define K5_O2 "%16, %17, %18, %19, %20, %21, %22, %23"
#define K5_O3 "%24, %25, %26, %27, %28, %29, %30, %31"
#define K5_O4 "%32, %33, %34, %35, %36, %37, %38, %39"
#define K5_O5 "%40, %41, %42, %43, %44, %45, %46, %47"
#define K5_O6 "%48, %49, %50, %51, %52, %53, %54, %55"
#define K5_O7 "%56, %57, %58, %59, %60, %61, %62, %63"
#define K5_O8 "%64, %65, %66, %67, %68, %69, %70, %71"
#define K5_O9 "%72, %73, %74, %75, %76, %77, %78, %79"
#define K5_O10 "%80, %81, %82, %83, %84, %85, %86, %87"
#define K5_O11 "%88, %89, %90, %91, %92, %93, %94, %95"
#define K5_O12 "%96, %97, %98, %99, %100, %101, %102, %103"
#define K5_O13 "%104, %105, %106, %107, %108, %109, %110, %111"
#define K5_O14 "%112, %113, %114, %115, %116, %117, %118, %119"
#define K5_O15 "%120, %121, %122, %123, %124, %125, %126, %127"
#define K5_OL1 K5_O0
#define K5_OL2 K5_OL1 ", " K5_O1
#define K5_OL3 K5_OL2 ", " K5_O2
#define K5_OL4 K5_OL3 ", " K5_O3
#define K5_OL5 K5_OL4 ", " K5_O4
#define K5_OL6 K5_OL5 ", " K5_O5
#define K5_OL7 K5_OL6 ", " K5_O6
#define K5_OL8 K5_OL7 ", " K5_O7
#define K5_OL9 K5_OL8 ", " K5_O8
#define K5_OL10 K5_OL9 ", " K5_O9
#define K5_OL11 K5_OL10 ", " K5_O10
#define K5_OL12 K5_OL11 ", " K5_O11
#define K5_OL13 K5_OL12 ", " K5_O12
#define K5_OL14 K5_OL13 ", " K5_O13
#define K5_OL15 K5_OL14 ", " K5_O14
#define K5_OL16 K5_OL15 ", " K5_O15
#define K5_D8(i)                                                          \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),            \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define K5_DL1 K5_D8(0)
#define K5_DL2 K5_DL1, K5_D8(8)
#define K5_DL3 K5_DL2, K5_D8(16)
#define K5_DL4 K5_DL3, K5_D8(24)
#define K5_DL5 K5_DL4, K5_D8(32)
#define K5_DL6 K5_DL5, K5_D8(40)
#define K5_DL7 K5_DL6, K5_D8(48)
#define K5_DL8 K5_DL7, K5_D8(56)
#define K5_DL9 K5_DL8, K5_D8(64)
#define K5_DL10 K5_DL9, K5_D8(72)
#define K5_DL11 K5_DL10, K5_D8(80)
#define K5_DL12 K5_DL11, K5_D8(88)
#define K5_DL13 K5_DL12, K5_D8(96)
#define K5_DL14 K5_DL13, K5_D8(104)
#define K5_DL15 K5_DL14, K5_D8(112)
#define K5_DL16 K5_DL15, K5_D8(120)
// width N = 16 Q: accumulators %0 .. %(8Q - 1), the two descriptors, then
// scale-d (1: accumulate)
#define K5_WGMMA(N, Q, RA, RB, RS)                                        \
  if constexpr (kN == N)                                                  \
    asm volatile("{\n"                                                    \
                 "  .reg .pred p;\n"                                      \
                 "  setp.ne.b32 p, %" #RS ", 0;\n"                        \
                 "  wgmma.mma_async.sync.aligned.m64n" #N                 \
                 "k32.s32.s8.s8 {" K5_OL##Q "}, %" #RA ", %" #RB ", p;\n" \
                 "}\n"                                                    \
                 : K5_DL##Q                                               \
                 : "l"(da), "l"(db), "r"(1));

template <int kN>
__device__ __forceinline__ void wgmma_s8(int (&d)[kN / 2], uint64_t da,
                                         uint64_t db) {
  K5_WGMMA(16, 1, 8, 9, 10)
  K5_WGMMA(32, 2, 16, 17, 18)
  K5_WGMMA(48, 3, 24, 25, 26)
  K5_WGMMA(64, 4, 32, 33, 34)
  K5_WGMMA(80, 5, 40, 41, 42)
  K5_WGMMA(96, 6, 48, 49, 50)
  K5_WGMMA(112, 7, 56, 57, 58)
  K5_WGMMA(128, 8, 64, 65, 66)
  K5_WGMMA(144, 9, 72, 73, 74)
  K5_WGMMA(160, 10, 80, 81, 82)
  K5_WGMMA(176, 11, 88, 89, 90)
  K5_WGMMA(192, 12, 96, 97, 98)
  K5_WGMMA(208, 13, 104, 105, 106)
  K5_WGMMA(224, 14, 112, 113, 114)
  K5_WGMMA(240, 15, 120, 121, 122)
  K5_WGMMA(256, 16, 128, 129, 130)
}

// one frame's M (rows, k) into shared memory as k_pad / slice regions of
// kN rows x `slice` bytes, each swizzled as TMA's and wgmma's
// CU_TENSOR_MAP_SWIZZLE_<slice>B (16-byte chunk c of row r at chunk
// c ^ (r / (128 / slice) mod (slice / 16))), zero beyond (rows, k); its u
// as f64, 0 beyond rows; for block minima its u_m (s_um, k_pad f32, 0
// beyond k).  16-byte cp.async where rows are 16-byte aligned (vec), else
// byte loads and one 16-byte store a chunk.  Threads 0-255.
template <int kN, bool kMinima>
__device__ void stage_frame(int8_t* s_m, double* s_u, float* s_um,
                            const int8_t* src, const float* usrc,
                            const float* umsrc, int rows, int k, int k_pad,
                            int slice, bool vec, int tid) {
  const int cpr = k_pad / 16, cps = slice / 16, mask = cps - 1;
  for (int i = tid; i < kN * cpr; i += 256) {
    const int r = i / cpr;
    const int c = i - r * cpr;
    const int s = c / cps;
    int o = r * slice + (c - s * cps) * 16;
    o ^= ((o >> 7) & mask) << 4;
    int8_t* dst = s_m + s * kN * slice + o;
    const bool in = r < rows && c * 16 < k;
    if (vec) {
      cp_async16(smem_addr(dst),
                 in ? src + static_cast<long long>(r) * k + c * 16 : src,
                 in ? 16 : 0);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (in) {
        const int8_t* row = src + static_cast<long long>(r) * k + c * 16;
        for (int q = 0; q < 16 && c * 16 + q < k; ++q)
          w[q >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(row[q]))
                       << (8 * (q & 3));
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  for (int i = tid; i < kN; i += 256)
    s_u[i] = i < rows ? static_cast<double>(usrc[i]) : 0.0;
  if constexpr (kMinima)
    for (int i = tid; i < k_pad; i += 256) s_um[i] = i < k ? umsrc[i] : 0.f;
  cp_async_commit();
  cp_async_wait_all();
}

// Units u = blockIdx.x, + gridDim.x, ...: frame u / chunks against TEP tiles
// [c tpc, min((c + 1) tpc, tiles)) of 64, c = u % chunks.  Shared memory
// (from a 1024-aligned base): two rings of `stages` stages of 64 x slice
// bytes, the frame (kN x k_pad), its u (kN f64), the full and empty
// barriers, and for block minima the frame's u_m (k_pad f32).  Block minima
// fold into the device keys ma.keys.
template <int kN, bool kMinima>
__global__ void __launch_bounds__(kGenThreads, 1)
    lterm_general_kernel(const __grid_constant__ CUtensorMap tmap,
                         const int8_t* __restrict__ mm,
                         const float* __restrict__ ul, float* __restrict__ out,
                         int batch, int m, int k, int ntot, int k_pad,
                         int slice, int stages, int tpc, int chunks, int vec,
                         const MinimaArgs ma) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~static_cast<uintptr_t>(1023));
  const int stage_bytes = kTepTile * slice;
  int8_t* ring = reinterpret_cast<int8_t*>(base);
  int8_t* s_m = ring + 2 * stages * stage_bytes;
  double* s_u = reinterpret_cast<double*>(s_m + kN * k_pad);
  uint64_t* full = reinterpret_cast<uint64_t*>(s_u + kN);
  uint64_t* empty = full + 2 * stages;
  float* s_um = reinterpret_cast<float*>(empty + 2 * stages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (ntot + kTepTile - 1) / kTepTile;
  const long long units = static_cast<long long>(batch) * chunks;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // lane 0 of each warp of the consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // producer of ring r: the tiles seq r, r + 2, ... of the block's units
    // (numbered across units), slice by slice, each into the next free stage
    if (lane == 0) {
      const int r = warp - 8;
      int stage = 0, seq = 0;
      uint32_t phase = 0;
      for (long long u = blockIdx.x; u < units; u += gridDim.x) {
        const int c = static_cast<int>(u % chunks);
        const int t_end = min((c + 1) * tpc, tiles);
        for (int tile = c * tpc; tile < t_end; ++tile, ++seq) {
          if ((seq & 1) != r) continue;
          for (int col = 0; col < k_pad; col += slice) {
            mbar_wait(&empty[r * stages + stage], phase ^ 1);
            mbar_expect_tx(&full[r * stages + stage], stage_bytes);
            tma_load_tile(ring + (r * stages + stage) * stage_bytes, &tmap,
                          &full[r * stages + stage], col, tile * kTepTile);
            if (++stage == stages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: ring wg, the tiles seq wg, wg + 2, ...
  const int wg = warp >> 2;
  const int wq = warp & 3;
  const uint32_t ring0 = smem_addr(ring + wg * stages * stage_bytes);
  const uint32_t frame0 = smem_addr(s_m);
  const int ksteps = slice / 32;
  const int slices = k_pad / slice;
  int stage = 0, seq = 0;
  uint32_t phase = 0;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long f = u / chunks;
    const int c = static_cast<int>(u % chunks);
    // both warpgroups are done with the last frame (wgmma and epilogue)
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    stage_frame<kN, kMinima>(s_m, s_u, s_um, mm + f * m * k, ul + f * m,
                             kMinima ? ma.um + f * k : nullptr, m, k, k_pad,
                             slice, vec != 0, threadIdx.x);
    // the frame's generic-proxy writes, visible to wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    float* outrow = kMinima ? nullptr : out + f * ntot;
    const float c0f = kMinima ? ma.c0[f] : 0.f;
    long long* keys = kMinima ? ma.keys + f * ma.blocks : nullptr;
    RunMin run;  // block minima: the lane's running key
    const int t_end = min((c + 1) * tpc, tiles);
    for (int tile = c * tpc; tile < t_end; ++tile, ++seq) {
      if ((seq & 1) != wg) continue;
      TepPos pos;
      if constexpr (kMinima)
        pos.load(ma, tile * kTepTile + 16 * wq + (lane >> 2) + 8 * (lane & 3),
                 (lane & 3) < 2);
      int acc[kN / 2];
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) acc[i] = 0;
      const int first = stage;  // the stage of the tile's first slice
      for (int sl = 0; sl < slices; ++sl) {
        mbar_wait(&full[wg * stages + stage], phase);
        const uint32_t a0 = ring0 + stage * stage_bytes;
        const uint32_t b0 = frame0 + sl * kN * slice;
        fence_regs(acc);
        wgmma_fence();
        for (int ks = 0; ks < ksteps; ++ks)
          wgmma_s8<kN>(acc, wgmma_desc(a0 + 32 * ks, slice),
                       wgmma_desc(b0 + 32 * ks, slice));
        wgmma_commit();
        fence_regs(acc);
        if (sl >= kLookahead) {
          // slice sl - kLookahead is done: its stage is free
          wgmma_wait<kLookahead>();
          fence_regs(acc);
          if (lane == 0)
            mbar_arrive(&empty[wg * stages + (first + sl - kLookahead) % stages]);
        }
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0)
        for (int sl = max(0, slices - kLookahead); sl < slices; ++sl)
          mbar_arrive(&empty[wg * stages + (first + sl) % stages]);
      Partials part;
      const int t = lane & 3;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int q[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                          acc[4 * j + 3]};
        part.weigh(q, *reinterpret_cast<const double2*>(s_u + 8 * j + 2 * t));
      }
      if constexpr (kMinima) {
        double s0, s1;
        part.sums(s0, s1);
        run.add(ma, pos, s_um, c0f, (lane & 3) == 0 ? s0 : s1, keys);
      } else {
        part.finish(outrow, tile * kTepTile + 16 * wq, lane, ntot);
      }
    }
    if constexpr (kMinima) run.flush(keys);
  }
}

// the decoded (batch, blocks) keys of the general route: minima and
// block-local first argmins
__global__ void minima_decode_kernel(const long long* __restrict__ keys,
                                     const long long* __restrict__ starts,
                                     float* __restrict__ minima,
                                     long long* __restrict__ argmins,
                                     long long n, int blocks) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    decode_key(keys[i], starts[i % blocks], minima[i], argmins[i]);
}

using Kernel = void (*)(const int8_t*, const float*, const int8_t*, float*,
                        int, int, int, int, int, int, int, int, int,
                        const MinimaArgs);
using GeneralKernel = void (*)(const CUtensorMap, const int8_t*, const float*,
                               float*, int, int, int, int, int, int, int, int,
                               int, int, const MinimaArgs);

// the resident instantiation: (kch, tn) = (2, 8), lterm's or block minima's
Kernel pick(int kch, int tn, bool minima) {
  if (kch == 2 && tn == 8)
    return minima ? lterm_kernel<2, 8, true> : lterm_kernel<2, 8, false>;
  return nullptr;
}

template <bool kMinima>
GeneralKernel pick_general_of(int m_pad) {
  switch (m_pad) {
    case 16: return lterm_general_kernel<16, kMinima>;
    case 32: return lterm_general_kernel<32, kMinima>;
    case 48: return lterm_general_kernel<48, kMinima>;
    case 64: return lterm_general_kernel<64, kMinima>;
    case 80: return lterm_general_kernel<80, kMinima>;
    case 96: return lterm_general_kernel<96, kMinima>;
    case 112: return lterm_general_kernel<112, kMinima>;
    case 128: return lterm_general_kernel<128, kMinima>;
    case 144: return lterm_general_kernel<144, kMinima>;
    case 160: return lterm_general_kernel<160, kMinima>;
    case 176: return lterm_general_kernel<176, kMinima>;
    case 192: return lterm_general_kernel<192, kMinima>;
    case 208: return lterm_general_kernel<208, kMinima>;
    case 224: return lterm_general_kernel<224, kMinima>;
    case 240: return lterm_general_kernel<240, kMinima>;
    case 256: return lterm_general_kernel<256, kMinima>;
    default: return nullptr;
  }
}

// the general instantiation for a padded frame of m_pad rows
GeneralKernel pick_general(int m_pad, bool minima) {
  return minima ? pick_general_of<true>(m_pad) : pick_general_of<false>(m_pad);
}

// shared bytes of a resident block (ops/osd_disc.py _smem): the TEP tile,
// nbuf frames and their u, and for block minima two buffers of keys and
// nbuf frames' u_m
long long plan_smem(int m_pad, int k_pad, int nt, int nbuf, int blocks) {
  const long long S = k_pad + 16;
  return S * nt + nbuf * (S * m_pad + 8LL * m_pad) +
         (blocks > 0 ? 16LL * blocks + 4LL * nbuf * k_pad : 0);
}

// shared bytes of a general block (ops/osd_disc.py general_smem), and for
// block minima the frame's u_m
long long general_smem(int m_pad, int k_pad, int slice, int stages,
                       int blocks) {
  return 1024LL + 2LL * stages * (kTepTile * slice + 16) +
         static_cast<long long>(m_pad) * k_pad + 8LL * m_pad +
         (blocks > 0 ? 4LL * k_pad : 0);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the process has already
// loaded
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

int set_smem(const void* kern, int smem_bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
}

// one resident plan, lterm's (ma.blocks == 0) or block minima's
int resident_launch(const void* m_matrix, const void* u_l, const void* teps,
                    void* out, int batch, int m, int k, int ntot, int kch,
                    int tn, int m_pad, int k_pad, int nt, int n_tiles,
                    int nbuf, int grid_x, int smem_bytes, void* stream,
                    const MinimaArgs& ma) {
  const bool minima = ma.blocks > 0;
  const Kernel kern = pick(kch, tn, minima);
  const bool ok =
      kern != nullptr && batch > 0 && ntot > 0 && m > 0 && k > 0 &&
      k <= k_pad && m <= m_pad && k_pad == 32 * kch && m_pad == 8 * tn &&
      nt % 16 == 0 && nt > 0 && static_cast<long long>(nt) * n_tiles >= ntot &&
      static_cast<long long>(nt) * (n_tiles - 1) < ntot &&
      (nbuf == 1 || nbuf == 2) && grid_x >= 1 && grid_x <= batch &&
      plan_smem(m_pad, k_pad, nt, nbuf, ma.blocks) == smem_bytes &&
      smem_bytes <= kMaxSmem &&
      // direct minima need the whole frame in one block
      (!minima || ma.keys != nullptr || n_tiles == 1);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  // the limit belongs to the kernel: set it before every launch
  const int err = set_smem(reinterpret_cast<const void*>(kern), smem_bytes);
  if (err != 0) return err;
  const int8_t* mm = static_cast<const int8_t*>(m_matrix);
  const int8_t* tt = static_cast<const int8_t*>(teps);
  const int vec = (k % 16 == 0 && reinterpret_cast<uintptr_t>(mm) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(tt) % 16 == 0) ? 1 : 0;
  const dim3 grid(grid_x, n_tiles);
  kern<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      mm, static_cast<const float*>(u_l), tt, static_cast<float*>(out), batch,
      m, k, ntot, m_pad, k_pad, nt, nbuf, vec, ma);
  return static_cast<int>(cudaGetLastError());
}

// one general plan, lterm's (ma.blocks == 0) or block minima's
int general_launch(const void* m_matrix, const void* u_l, const void* teps,
                   void* out, int batch, int m, int k, int ntot, int t_cols,
                   int m_pad, int k_pad, int slice, int stages, int nt,
                   int n_tiles, int grid_x, int smem_bytes, void* stream,
                   const MinimaArgs& ma) {
  const bool minima = ma.blocks > 0;
  const GeneralKernel kern = pick_general(m_pad, minima);
  const int tiles = (ntot + kTepTile - 1) / kTepTile;
  const int tpc = nt / kTepTile;
  const bool ok =
      kern != nullptr && batch > 0 && ntot > 0 && m > 0 && k > 0 &&
      m <= m_pad && m_pad - m < 16 &&
      (slice == 32 || slice == 64 || slice == 128) && k_pad % slice == 0 &&
      k <= k_pad && k_pad - k < slice && t_cols >= k && t_cols % 16 == 0 &&
      reinterpret_cast<uintptr_t>(teps) % 16 == 0 && stages > kLookahead &&
      nt % kTepTile == 0 && nt > 0 && n_tiles == (tiles + tpc - 1) / tpc &&
      grid_x >= 1 &&
      static_cast<long long>(grid_x) <= static_cast<long long>(batch) * n_tiles &&
      general_smem(m_pad, k_pad, slice, stages, ma.blocks) == smem_bytes &&
      smem_bytes <= kMaxSmem && (!minima || ma.keys != nullptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  alignas(64) CUtensorMap tmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(t_cols),
                              static_cast<cuuint64_t>(ntot)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(t_cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(slice),
                             static_cast<cuuint32_t>(kTepTile)};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swizzle =
      slice == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : slice == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  if (encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(teps),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = set_smem(reinterpret_cast<const void*>(kern), smem_bytes);
  if (err != 0) return err;
  const int8_t* mm = static_cast<const int8_t*>(m_matrix);
  const int vec = (k % 16 == 0 && reinterpret_cast<uintptr_t>(mm) % 16 == 0)
                      ? 1 : 0;
  kern<<<grid_x, kGenThreads, smem_bytes,
         static_cast<cudaStream_t>(stream)>>>(
      tmap, mm, static_cast<const float*>(u_l), static_cast<float*>(out),
      batch, m, k, ntot, k_pad, slice, stages, tpc, n_tiles, vec, ma);
  return static_cast<int>(cudaGetLastError());
}

MinimaArgs minima_args(const void* c0, const void* u_m, const void* heads,
                       const void* cols, const void* block_of,
                       const void* starts, void* keys, void* minima,
                       void* argmins, int blocks, int nreal) {
  return MinimaArgs{static_cast<const float*>(c0),
                    static_cast<const float*>(u_m),
                    static_cast<const int4*>(heads),
                    static_cast<const int16_t*>(cols),
                    static_cast<const int*>(block_of),
                    static_cast<const long long*>(starts),
                    static_cast<long long*>(keys),
                    static_cast<float*>(minima),
                    static_cast<long long*>(argmins),
                    blocks,
                    nreal};
}

}  // namespace

// The launch of one resident plan (ops/osd_disc.py lterm_plan); returns a
// cudaError code, cudaErrorInvalidValue for a plan that does not fit the
// shape.
extern "C" int lterm_launch(const void* m_matrix, const void* u_l,
                            const void* teps, void* out, int batch, int m,
                            int k, int ntot, int kch, int tn, int m_pad,
                            int k_pad, int nt, int n_tiles, int nbuf,
                            int grid_x, int smem_bytes, void* stream) {
  return resident_launch(m_matrix, u_l, teps, out, batch, m, k, ntot, kch, tn,
                         m_pad, k_pad, nt, n_tiles, nbuf, grid_x, smem_bytes,
                         stream, MinimaArgs{});
}

// The launch of one general plan: T (ntot, k) read through a tensor map
// with rows t_cols bytes apart (t_cols >= k, a multiple of 16, zero beyond
// k); nt TEPs (tpc tiles of 64) a unit, n_tiles units a frame, grid_x
// persistent blocks.  Returns a cudaError code (cudaErrorInvalidValue for
// a plan that does not fit the shape, cudaErrorNotSupported where
// libcuda gives no tensor map).
extern "C" int lterm_general_launch(const void* m_matrix, const void* u_l,
                                    const void* teps, void* out, int batch,
                                    int m, int k, int ntot, int t_cols,
                                    int m_pad, int k_pad, int slice,
                                    int stages, int nt, int n_tiles,
                                    int grid_x, int smem_bytes, void* stream) {
  return general_launch(m_matrix, u_l, teps, out, batch, m, k, ntot, t_cols,
                        m_pad, k_pad, slice, stages, nt, n_tiles, grid_x,
                        smem_bytes, stream, MinimaArgs{});
}

// Block minima on a resident plan (ops/osd_disc.py lterm_plan with
// blocks): c0 (batch,) and u_m (batch, k) f32, the TEPs' position list
// (heads int32 (ntot, 4), cols int16), block_of int32 (ntot,), starts
// int64 (blocks,), TEPs at or past nreal skipped.  With keys null the block
// writes minima (batch, blocks) f32 and argmins (batch, blocks) int64 itself
// (n_tiles 1); else it folds into keys (batch, blocks) int64, filled with
// INT64_MAX, for minima_decode.  Returns a cudaError code.
extern "C" int block_minima_launch(
    const void* m_matrix, const void* u_l, const void* teps, const void* c0,
    const void* u_m, const void* heads, const void* cols,
    const void* block_of, const void* starts, void* keys, void* minima,
    void* argmins, int batch, int m, int k, int ntot, int nreal, int blocks,
    int kch, int tn, int m_pad, int k_pad, int nt, int n_tiles, int nbuf,
    int grid_x, int smem_bytes, void* stream) {
  if (blocks < 1 || nreal < 0 || nreal > ntot)
    return static_cast<int>(cudaErrorInvalidValue);
  return resident_launch(
      m_matrix, u_l, teps, nullptr, batch, m, k, ntot, kch, tn, m_pad, k_pad,
      nt, n_tiles, nbuf, grid_x, smem_bytes, stream,
      minima_args(c0, u_m, heads, cols, block_of, starts, keys, minima,
                  argmins, blocks, nreal));
}

// Block minima on a general plan, into keys (batch, blocks) int64 filled
// with INT64_MAX (then minima_decode); the rest as block_minima_launch and
// lterm_general_launch.
extern "C" int block_minima_general_launch(
    const void* m_matrix, const void* u_l, const void* teps, const void* c0,
    const void* u_m, const void* heads, const void* cols,
    const void* block_of, void* keys, int batch, int m, int k, int ntot,
    int nreal, int blocks, int t_cols, int m_pad, int k_pad, int slice,
    int stages, int nt, int n_tiles, int grid_x, int smem_bytes,
    void* stream) {
  if (blocks < 1 || nreal < 0 || nreal > ntot)
    return static_cast<int>(cudaErrorInvalidValue);
  return general_launch(
      m_matrix, u_l, teps, nullptr, batch, m, k, ntot, t_cols, m_pad, k_pad,
      slice, stages, nt, n_tiles, grid_x, smem_bytes, stream,
      minima_args(c0, u_m, heads, cols, block_of, nullptr, keys, nullptr,
                  nullptr, blocks, nreal));
}

// keys (batch, blocks) -> minima f32 and argmins int64 (flat index minus
// the block's start; an empty block (3.4e38, 0)).  Returns a cudaError code.
extern "C" int minima_decode(const void* keys, const void* starts,
                             void* minima, void* argmins, int batch,
                             int blocks, void* stream) {
  if (batch < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(batch) * blocks;
  const int grid = static_cast<int>((n + 255) / 256 < 1024 ? (n + 255) / 256
                                                            : 1024);
  minima_decode_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys),
      static_cast<const long long*>(starts), static_cast<float*>(minima),
      static_cast<long long*>(argmins), n, blocks);
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of a plan's kernel at smem_bytes of dynamic shared
// memory: the resident (kch, tn) = (2, 8), or (kch 0) the general one for
// m_pad rows, lterm's or (minima 1) block minima's.  out = {registers, local
// bytes a thread, threads a block, resident blocks per SM, SMs, static
// shared bytes}; returns a cudaError.
extern "C" int lterm_occupancy(int kch, int tn, int m_pad, int smem_bytes,
                               int minima, int device, int* out) {
  const void* kern =
      kch == 0 ? reinterpret_cast<const void*>(pick_general(m_pad, minima != 0))
               : reinterpret_cast<const void*>(pick(kch, tn, minima != 0));
  const int threads = kch == 0 ? kGenThreads : kThreads;
  if (kern == nullptr || smem_bytes > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = set_smem(kern, smem_bytes);
  if (err != 0) return err;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads,
                                                    smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = threads;
  out[3] = blocks;
  out[4] = sms;
  out[5] = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}
