// The edge-layout normalized min-sum iteration body of every CUDA kernel of
// the port that decodes: K1/K2 (nms_edge.cu), the fused Monte-Carlo kernels
// K3/K4/K8 (mc_fused.cu) and the dense-rung kernels K6/K7 (nms_dense.cu).
// It is the CUDA form of the TPU's nms_edge_pallas._decode_edge (the body
// of _decode_kernel, _decode_traj_kernel, _mc_kernel and
// _mc_schedule_kernel); see nms_edge.cu for the semantics it holds
// (duplicate-at-minimum tournament, zero-aware sign product, dummy edges
// skipped).  With kClampBig (K6/K7) it also holds the dense-rung TPU
// kernel's clamp (nms_pallas.py): magnitudes are clamped to kBig and
// min/submin start at kBig, so a row of degree 1 sends w_chk * kBig where
// the other kernels send +inf.  NMS-r's kernels (nms_edge.cu) run the same
// phase A with a phase B of their own, `iterate_neural` (see its note).
//
// What bounds it on the H100: the f32 edge arithmetic (about 8 instructions
// per edge and iteration) and the shared-memory traffic of the message
// exchange, since nothing but the frame's input and output touches device
// memory.  An SM's shared memory serves 32 words a clock against 128 f32
// lanes, so each shared access per edge costs about as much as four
// arithmetic instructions.
//
// Design (one frame on one group of 32 * W threads, W warps):
//   * lane t of the group owns checks t + T q (q < CPL) and variables
//     t + T i (i < VPL), T = 32 W.  Each owned check keeps in registers,
//     for all iterations, its DC column offsets and its DC messages cv;
//     each owned variable its DV message slots and its channel value x.
//     DC, DV, CPL and VPL are compile-time (a Bucket), so every loop is
//     unrolled and every array stays in registers.  A check of lower degree
//     fills its slots with a dummy column that reads +inf (never the
//     minimum, never a sign); a variable of lower degree reads a word that
//     is always 0 (adding +0 leaves a sum unchanged);
//   * shared memory holds only what crosses lanes: the column totals
//     (VPL T words, then the +inf word) and the outgoing messages, one row
//     of S = DC | 1 words per check (an odd stride: the row stores of a
//     warp hit 32 distinct banks), then the zero word;
//   * per iteration, phase A: each variable sums its cv slots in ascending
//     check order (the order of the dense row sum), hands the column sum to
//     `emit(it, i, colsum)` and stores total = colsum + w_vc * x; phase B:
//     each check reads total[col] once per edge, keeps vc = total - cv in
//     the register of cv, runs the min/submin tournament and the sign
//     parity, then writes each outgoing message once, to its register and
//     to its row.  About 3 shared accesses per edge, no address arithmetic
//     and no degree test inside the loop;
//   * the sign product is the parity of the sign bits plus a zero flag
//     (min1 == 0: some vc is 0, which zeroes the row); the outgoing message
//     is the selected magnitude with its sign bit flipped by the parity of
//     the other edges: the twin's value, up to the sign of a zero message,
//     which no later step can see (a column sum starts at +0);
//   * phases are separated by frame-scoped barriers: __syncwarp for a
//     one-warp frame, a named barrier (bar.sync 1 + group, T) for a group of
//     warps.  No block-wide barrier runs inside a frame, so a block holds
//     as many frames as registers and shared memory allow and no frame
//     waits for another.
// Phase A runs iters + 1 times; the last one (it == iters) only emits, and
// the body returns without a closing barrier: a caller that reads what
// `emit` wrote from another lane synchronises the frame first.  Every
// thread of the group must call the body (it synchronises the group).
//
// Split checks (the split bucket, Bk::kSplit): a lane owns one *segment*
// of at most DC slots instead of a whole check, and a check of degree
// above DC spans two lanes 2p, 2p + 1 of one warp, the split checks first
// in check order and then the others (the lane map of ops/nms_edge.py
// split_map).  Each lane runs the tournament over its segment; the pair
// then exchanges min1, min2 and the sign parity with one __shfl_xor_sync
// each (`combine`) and takes the row's: min1 = min(a1, b1), min2 =
// min(max(a1, b1), min(a2, b2)), parity = pa ^ pb, exact and independent
// of order, so every message is the one-lane tournament's bit for bit.
// Message rows are kept per segment (S = DC | 1 words a lane); edge
// e = j*m + c of a split check lives in segment first[c] + j / DC, slot
// j % DC.  Phase A is unchanged but for those addresses; load and save
// keep the (dc, m) layout.  A bucket that does not split compiles as if
// this paragraph did not exist (if constexpr).

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace nms_edge {

constexpr float kBig = 3.4e38f;

// Compile-time degree buckets: the slots DC a lane keeps of a check and
// the largest variable degree DV they take, the checks and variables a
// lane owns, and whether a check of degree above DC splits over two lanes
// (then the bucket takes degrees up to 2 DC, a lane owns one segment).
// The packaged codes: dc 6-8 (code1_64_32, qc_96_48, ccsds_128_64,
// wimaxlike_384_192) take bucket 0, dc 11 (array_121_*) bucket 1, dc 20
// (wimax_1056_880) bucket 2; the extended matrices ENMS decodes on take
// bucket 3 (qc_96_48: dv 27, wimaxlike_384_192: dv 60) and the split
// bucket 4 (wimax_1056_880: dc 36).  ops/nms_edge.py (BUCKETS) mirrors
// this table.
template <int DC_, int DV_, int CPL_, int VPL_, bool SPLIT_ = false>
struct Bucket {
  static constexpr int DC = DC_, DV = DV_, CPL = CPL_, VPL = VPL_;
  static constexpr bool kSplit = SPLIT_;
  static constexpr int kDegree = SPLIT_ ? 2 * DC_ : DC_;  // largest dc
  static constexpr int S = DC_ | 1;  // words of a check's (segment's) row
  static_assert(!SPLIT_ || CPL_ == 1, "a split lane owns one segment");
};
using Bucket0 = Bucket<8, 6, 2, 4>;
using Bucket1 = Bucket<11, 6, 2, 4>;
using Bucket2 = Bucket<20, 6, 1, 4>;
using Bucket3 = Bucket<12, 64, 2, 1>;
using Bucket4 = Bucket<20, 6, 1, 4, true>;
constexpr int kBuckets = 5;
constexpr int kSplitBucket = 4;
// at most 16 warps a frame and 512 threads a block, so that every kernel
// over the body compiles with __launch_bounds__(kMaxThreads, 1): at most
// 128 registers a thread (without the cap the fused MC kernel takes 160-176
// and fits 2-3 blocks an SM; with it 4 blocks, and K3 ran 21% faster on
// the H100); at most 15 frames a block (named barriers 1..15; 0 is
// __syncthreads)
constexpr int kMaxWarps = 16;
constexpr int kMaxThreads = 512;
constexpr int kMaxFrames = 15;

// Calls f(Bucket{}) for bucket index b; cudaErrorInvalidValue for another b.
template <typename F>
inline int with_bucket(int b, F f) {
  switch (b) {
    case 0: return f(Bucket0{});
    case 1: return f(Bucket1{});
    case 2: return f(Bucket2{});
    case 3: return f(Bucket3{});
    case 4: return f(Bucket4{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// 4-byte words of one frame's region: totals + the +inf word, message rows
// + the zero word, and `extra` words of the caller.
template <class Bk>
__host__ __device__ inline size_t region_words(int threads, int extra) {
  return static_cast<size_t>(Bk::VPL) * threads + 1 +
         static_cast<size_t>(Bk::CPL) * threads * Bk::S + 1 + extra;
}

// True when `warps` warps a frame and `frames` frames a block of bucket Bk
// take an (m, n) code of largest degrees (dc, dv) whose checks take
// `lanes` lanes at the split bucket (m plus its checks of degree above
// DC; ignored by the others).
template <class Bk>
inline bool plan_holds(int warps, int frames, int m, int n, int dc, int dv,
                       int lanes) {
  const int threads = 32 * warps;
  const bool checks = Bk::kSplit ? lanes >= m && lanes <= threads
                                 : m <= Bk::CPL * threads;
  return warps >= 1 && warps <= kMaxWarps && frames >= 1 &&
         frames <= kMaxFrames && threads * frames <= kMaxThreads &&
         dc >= 1 && dc <= Bk::kDegree && dv >= 1 && dv <= Bk::DV && checks &&
         n <= Bk::VPL * threads;
}

// True when the lane map is given exactly where the bucket splits.
inline bool split_given(int bucket, const void* split) {
  return (bucket == kSplitBucket) == (split != nullptr);
}

// The dynamic shared memory of every kernel starts here; offsets below are
// bytes from it, held in 32-bit registers.
__device__ __forceinline__ float& sh(unsigned off) {
  extern __shared__ __align__(16) unsigned char nms_edge_shared[];
  return *reinterpret_cast<float*>(nms_edge_shared + off);
}

// Synchronises the `threads` threads of one frame (barrier id `bar`).
__device__ __forceinline__ void frame_sync(int bar, int threads) {
  if (threads == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(threads) : "memory");
  }
}

// One lane's share of a frame: its tables and messages, all in registers.
template <class Bk>
struct Lane {
  unsigned col[Bk::CPL][Bk::DC];  // offset of total[col] (dummy: the +inf word)
  unsigned row[Bk::CPL];          // offset of the check's message row
  unsigned ve[Bk::VPL][Bk::DV];   // offsets of the variable's message slots
  unsigned tot;                   // offset of total[t]; total[t + T i] at + 4 T i
  int t, threads, bar;
  float cv[Bk::CPL][Bk::DC];      // the owned checks' check-to-variable messages
  // split bucket only: 4 c + 2 p + h for segment h of check c, p = 1 when
  // the check spans this lane and lane t ^ 1; -4 for a lane owning none
  int seg;

  // Reads the code's tables (edge_col (dc, m): slot j of check c, -1 for a
  // dummy edge; var_edges (dv, n): edge e = j*m + c of variable v in
  // ascending check order, -1 padded; global or shared memory) into this
  // lane's registers for the frame region at byte offset `region`, lane t
  // of `threads`, barrier `bar`.  `split` (the split bucket only, else
  // unread): the lane map, entry l < kMaxThreads 2 c + h for lane l owning
  // segment h of check c (slots DC h ..), -1 for a lane that owns none,
  // then entry kMaxThreads + c the first lane of check c.  Lane 0 writes
  // the region's +inf and zero words; the first frame's barriers order
  // them before any read.
  __device__ __forceinline__ void setup(unsigned region, const int* edge_col,
                                        const int* var_edges,
                                        const int* split, int m, int n,
                                        int dc, int dv, int lane, int nthreads,
                                        int barrier) {
    t = lane;
    threads = nthreads;
    bar = barrier;
    const unsigned inf_word = region + 4u * (Bk::VPL * nthreads);
    const unsigned rows = inf_word + 4u;
    const unsigned zero_word = rows + 4u * (Bk::CPL * nthreads * Bk::S);
    tot = region + 4u * lane;
    if constexpr (Bk::kSplit) {
      const int s = split[lane];
      const bool pair = s >= 0 && (split[lane ^ 1] >> 1) == (s >> 1);
      seg = s >= 0 ? 2 * s - (s & 1) + 2 * pair : -4;
      row[0] = rows + 4u * static_cast<unsigned>(lane * Bk::S);
#pragma unroll
      for (int j = 0; j < Bk::DC; ++j) {
        const int jj = (s & 1) * Bk::DC + j, v =
            (s >= 0 && jj < dc) ? edge_col[jj * m + (s >> 1)] : -1;
        col[0][j] = v >= 0 ? region + 4u * v : inf_word;
      }
    } else {
#pragma unroll
      for (int q = 0; q < Bk::CPL; ++q) {
        const int c = lane + nthreads * q;
        row[q] = rows + 4u * static_cast<unsigned>(c * Bk::S);
#pragma unroll
        for (int j = 0; j < Bk::DC; ++j) {
          const int v = (c < m && j < dc) ? edge_col[j * m + c] : -1;
          col[q][j] = v >= 0 ? region + 4u * v : inf_word;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < Bk::VPL; ++i) {
      const int v = lane + nthreads * i;
#pragma unroll
      for (int d = 0; d < Bk::DV; ++d) {
        const int e = (v < n && d < dv) ? var_edges[d * n + v] : -1;
        if constexpr (Bk::kSplit) {  // segment first[c] + j / DC, slot j % DC
          ve[i][d] = e >= 0 ? rows + 4u * static_cast<unsigned>(
                                       (split[kMaxThreads + e % m] +
                                        e / m / Bk::DC) * Bk::S +
                                       e / m % Bk::DC)
                            : zero_word;
        } else {
          ve[i][d] = e >= 0 ? rows + 4u * static_cast<unsigned>(
                                       (e % m) * Bk::S + e / m)
                            : zero_word;
        }
      }
    }
    if (lane == 0) {
      sh(inf_word) = INFINITY;
      sh(zero_word) = 0.f;
    }
  }

  // Messages from scratch.
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int q = 0; q < Bk::CPL; ++q)
#pragma unroll
      for (int j = 0; j < Bk::DC; ++j) cv[q][j] = 0.f;
  }

  // Messages saved by `save` (src: (dc, m) f32, e = j*m + c).
  __device__ __forceinline__ void load(const float* src, int m, int dc) {
    if constexpr (Bk::kSplit) {
#pragma unroll
      for (int j = 0; j < Bk::DC; ++j) {
        const int jj = (seg & 1) * Bk::DC + j;
        cv[0][j] = (seg >= 0 && jj < dc) ? src[jj * m + (seg >> 2)] : 0.f;
      }
    } else {
#pragma unroll
      for (int q = 0; q < Bk::CPL; ++q) {
        const int c = t + threads * q;
#pragma unroll
        for (int j = 0; j < Bk::DC; ++j)
          cv[q][j] = (c < m && j < dc) ? src[j * m + c] : 0.f;
      }
    }
  }

  // The messages of the real edges to dst ((dc, m) f32, e = j*m + c; a
  // dummy edge's slot gets 0, as in the plain twin).
  __device__ __forceinline__ void save(float* dst, int m, int dc) const {
    const unsigned inf_word = tot - 4u * t + 4u * (Bk::VPL * threads);
    if constexpr (Bk::kSplit) {
#pragma unroll
      for (int j = 0; j < Bk::DC; ++j) {
        const int jj = (seg & 1) * Bk::DC + j;
        if (seg >= 0 && jj < dc)
          dst[jj * m + (seg >> 2)] = col[0][j] == inf_word ? 0.f : cv[0][j];
      }
    } else {
#pragma unroll
      for (int q = 0; q < Bk::CPL; ++q) {
        const int c = t + threads * q;
#pragma unroll
        for (int j = 0; j < Bk::DC; ++j)
          if (c < m && j < dc) dst[j * m + c] = col[q][j] == inf_word ? 0.f : cv[q][j];
      }
    }
  }

  // The total (or, after the last emit, whatever the caller stored there)
  // of owned variable i.
  __device__ __forceinline__ float& total(int i) {
    return sh(tot + 4u * static_cast<unsigned>(threads * i));
  }
};

// Stores the messages in L.cv to their rows, for the first phase A.
template <class Bk>
__device__ __forceinline__ void begin(Lane<Bk>& L) {
  // the region is free once every lane has left the previous frame
  frame_sync(L.bar, L.threads);
#pragma unroll
  for (int q = 0; q < Bk::CPL; ++q)
#pragma unroll
    for (int j = 0; j < Bk::DC; ++j) sh(L.row[q] + 4u * j) = L.cv[q][j];
  frame_sync(L.bar, L.threads);
}

// Phase A of iteration `it`: column sums in ascending check order ->
// emit(it, i, colsum), and the totals while it < iters.
template <class Bk, typename Emit>
__device__ __forceinline__ void column_sums(Lane<Bk>& L,
                                            const float (&x)[Bk::VPL], int it,
                                            int iters, float w_vc, Emit& emit) {
#pragma unroll
  for (int i = 0; i < Bk::VPL; ++i) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < Bk::DV; ++d) s += sh(L.ve[i][d]);
    emit(it, i, s);
    if (it < iters) L.total(i) = s + w_vc * x[i];
  }
}

// Split bucket: the two lanes of a split check hand each other their
// segment's tournament and sign parity, and each keeps the row's (see the
// header note).  Every lane of the warp runs the shuffles; a lane that
// holds a whole check (or none) keeps its own.  Nothing at another bucket.
template <class Bk>
__device__ __forceinline__ void combine(const Lane<Bk>& L, float& min1,
                                        float& min2, unsigned& parity) {
  if constexpr (Bk::kSplit) {
    const float b1 = __shfl_xor_sync(0xffffffffu, min1, 1);
    const float b2 = __shfl_xor_sync(0xffffffffu, min2, 1);
    const unsigned pb = __shfl_xor_sync(0xffffffffu, parity, 1);
    if (L.seg & 2) {
      min2 = fminf(fmaxf(min1, b1), fminf(min2, b2));
      min1 = fminf(min1, b1);
      parity ^= pb;
    }
  }
}

// The syndrome bit of an owned check from `par`, its owned slots' share:
// at the split bucket the pair's two shares together.
template <class Bk>
__device__ __forceinline__ int check_parity(const Lane<Bk>& L, int par) {
  if constexpr (Bk::kSplit) {
    const int other = __shfl_xor_sync(0xffffffffu, par, 1);
    if (L.seg & 2) par ^= other;
  }
  return par;
}

// `iters` iterations from the messages in L.cv on the channel values x
// (see the header note).  emit(it, i, colsum) for it = 0..iters.
template <class Bk, bool kClampBig, typename Emit>
__device__ __forceinline__ void iterate(Lane<Bk>& L, const float (&x)[Bk::VPL],
                                        int iters, float w_vc, float w_chk,
                                        Emit emit) {
  begin(L);
  for (int it = 0;; ++it) {
    column_sums(L, x, it, iters, w_vc, emit);
    if (it == iters) break;
    frame_sync(L.bar, L.threads);
    // phase B: per-check tournament and outgoing messages
#pragma unroll
    for (int q = 0; q < Bk::CPL; ++q) {
      float min1 = kClampBig ? kBig : INFINITY, min2 = min1;
      unsigned parity = 0;
#pragma unroll
      for (int j = 0; j < Bk::DC; ++j) {
        const float vc = sh(L.col[q][j]) - L.cv[q][j];
        L.cv[q][j] = vc;
        const float mag = kClampBig ? fminf(fabsf(vc), kBig) : fabsf(vc);
        min2 = fminf(min2, fmaxf(min1, mag));
        min1 = fminf(min1, mag);
        parity ^= __float_as_uint(vc);
      }
      combine(L, min1, min2, parity);
      // a zero vc (then min1 == 0) zeroes every message of the row
      const float wmin1 = min1 == 0.f ? 0.f : w_chk * min1;
      const float wmin2 = min1 == 0.f ? 0.f : w_chk * min2;
#pragma unroll
      for (int j = 0; j < Bk::DC; ++j) {
        const float vc = L.cv[q][j];
        const float mag = kClampBig ? fminf(fabsf(vc), kBig) : fabsf(vc);
        const float pick = mag > min1 ? wmin1 : wmin2;
        const float out = __uint_as_float(
            __float_as_uint(pick) ^
            ((__float_as_uint(vc) ^ parity) & 0x80000000u));
        L.cv[q][j] = out;
        sh(L.row[q] + 4u * j) = out;
      }
    }
    frame_sync(L.bar, L.threads);
  }
}

// ---------------------------------------------------------------------------
// NMS-r: the neural check update (the reference code's compute_cv1) in
// place of the tournament, for a regular check degree dc <= DC.  An edge's
// magnitude is a two-layer network, (dc-1) -> 4 -> 1 with no activation,
// over the ascending sort of its row's other dc-1 magnitudes:
//   hidden_j = x_0 w1[0][j] + x_1 w1[1][j] + ... (ascending i),
//   out = hidden_0 w2[0] + hidden_1 w2[1] + ... (ascending j),
// each product and sum rounded on its own (-fmad=false): the order of the
// plain reference (and of the twin in ops/nms_edge.py), so the soft outputs
// match it bit for bit.
//
// Phase B sorts the row's DC magnitudes once, each carrying its slot and
// its sign bit (19 compare-exchanges for DC = 8).  The leave-one-out list
// of the entry at sorted position r is the sorted list less that entry:
// position i of it is s[i] for i < r and s[i+1] past it, so it weighs
// s[i] by w1[i] before r and by w1[i-1] after it.  The DC-1 products of
// each kind and the running sums over the first r entries are shared by
// every position; only the terms after r are added per position, in the
// reference's order.  Equal magnitudes give equal lists, whichever copy is
// removed, so the order the sort gives ties does not matter.  Each
// position's magnitude goes to the row slot it carries (a store to the
// shared row, read back into the slot's register), its sign flipped by the
// parity of the other edges; a zero magnitude (s[0] == 0) zeroes the row.
//
// A regular code of dc < DC pads its rows with dummy slots that read the
// +inf word: their magnitudes are clamped to FLT_MAX (finite), sort last,
// and meet only the +0 rows of w1 past dc - 2, so they add +0 to a sum,
// which changes no value.  A real magnitude is never changed by the clamp
// (only +inf is).

constexpr int kHidden = 4;  // the network's hidden width

// NMS-r's weights, a by-value kernel argument (read through the constant
// bank): w1's rows past dc - 2 are +0.
template <class Bk>
struct Neural {
  float w1[Bk::DC - 1][kHidden];
  float w2[kHidden];
  float w_vc, w_marg;
};

// Ascending compare-exchange of sorted positions i < k, keys carried.
template <int D>
__device__ __forceinline__ void exchange(float (&a)[D], unsigned (&key)[D],
                                         int i, int k) {
  const bool swap = a[k] < a[i];
  const float lo = swap ? a[k] : a[i], hi = swap ? a[i] : a[k];
  const unsigned klo = swap ? key[k] : key[i], khi = swap ? key[i] : key[k];
  a[i] = lo;
  a[k] = hi;
  key[i] = klo;
  key[k] = khi;
}

// Phase B of NMS-r for owned check q (see the note above).
template <class Bk>
__device__ __forceinline__ void neural_check(Lane<Bk>& L, int q,
                                             const Neural<Bk>& w) {
  static_assert(Bk::DC == 8, "NMS-r's sorting network takes 8 slots");
  constexpr int D = Bk::DC;
  float a[D];
  unsigned key[D];  // the slot, and the sign bit of its vc
  unsigned parity = 0;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float vc = sh(L.col[q][j]) - L.cv[q][j];
    a[j] = fminf(fabsf(vc), FLT_MAX);
    key[j] = static_cast<unsigned>(j) | (__float_as_uint(vc) & 0x80000000u);
    parity ^= __float_as_uint(vc);
  }
  // an optimal sorting network of 8 inputs (depth 6)
  exchange(a, key, 0, 2); exchange(a, key, 1, 3);
  exchange(a, key, 4, 6); exchange(a, key, 5, 7);
  exchange(a, key, 0, 4); exchange(a, key, 1, 5);
  exchange(a, key, 2, 6); exchange(a, key, 3, 7);
  exchange(a, key, 0, 1); exchange(a, key, 2, 3);
  exchange(a, key, 4, 5); exchange(a, key, 6, 7);
  exchange(a, key, 2, 4); exchange(a, key, 3, 5);
  exchange(a, key, 1, 4); exchange(a, key, 3, 6);
  exchange(a, key, 1, 2); exchange(a, key, 3, 4); exchange(a, key, 5, 6);
  float out[D];
#pragma unroll
  for (int j = 0; j < kHidden; ++j) {
    float lo[D - 1], hi[D];  // s[i] w1[i][j], s[i] w1[i-1][j]
#pragma unroll
    for (int i = 0; i < D - 1; ++i) lo[i] = a[i] * w.w1[i][j];
#pragma unroll
    for (int i = 1; i < D; ++i) hi[i] = a[i] * w.w1[i - 1][j];
    float head = 0.f;  // the sum over the first r entries, r >= 1
#pragma unroll
    for (int r = 0; r < D; ++r) {
      float h;
      if (r == 0) {
        h = hi[1];
#pragma unroll
        for (int i = 2; i < D; ++i) h = h + hi[i];
      } else {
        head = r == 1 ? lo[0] : head + lo[r - 1];
        h = head;
#pragma unroll
        for (int i = r + 1; i < D; ++i) h = h + hi[i];
      }
      const float term = h * w.w2[j];
      out[r] = j == 0 ? term : out[r] + term;
    }
  }
  const bool zero = a[0] == 0.f;
#pragma unroll
  for (int r = 0; r < D; ++r) {
    const float v = zero ? 0.f
                         : __uint_as_float(__float_as_uint(out[r]) ^
                                           ((key[r] ^ parity) & 0x80000000u));
    sh(L.row[q] + 4u * (key[r] & 0xffu)) = v;
  }
#pragma unroll
  for (int j = 0; j < D; ++j) L.cv[q][j] = sh(L.row[q] + 4u * j);
}

// `iters` NMS-r iterations from the messages in L.cv: phase A as
// `iterate`, phase B `neural_check`.  emit(it, i, colsum) for it = 0..iters.
template <class Bk, typename Emit>
__device__ __forceinline__ void iterate_neural(Lane<Bk>& L,
                                               const float (&x)[Bk::VPL],
                                               int iters, const Neural<Bk>& w,
                                               Emit emit) {
  begin(L);
  for (int it = 0;; ++it) {
    column_sums(L, x, it, iters, w.w_vc, emit);
    if (it == iters) break;
    frame_sync(L.bar, L.threads);
#pragma unroll
    for (int q = 0; q < Bk::CPL; ++q) neural_check(L, q, w);
    frame_sync(L.bar, L.threads);
  }
}

}  // namespace nms_edge
