// Bit-packed batched GF(2) elimination (the GE of engine.prepare) on Hopper.
//
// Replaces short_ldpc_decoding_osd_tpu/ops/gf2_bitpack.py _reduce_packed,
// reached from gf2ops.identify_mrb_from_perm / identify_mrb (their packed
// branch).  That is not a Pallas kernel: JAX runs it in XLA, its Pallas GE
// (gf2_pallas) having been retired (docs/ROUND5.md section 8).  Per frame
// it computes, bit for bit, what the plain twins in ops/gf2_bitpack.py
// compute: m pivot steps on the frame's (m, n) 0/1 matrix, at step t
//   1. the first row p >= t with a 1 in column t is the pivot (rows t and p
//      swap);
//   2. with no pivot, the first column c > t with a 1 in row t swaps with
//      column t (in every row and in the column order); with neither, the
//      columns stay;
//   3. row t is XORed into every other row with a 1 in column t.
// Out: the last n - c0 columns of the reduced matrix as int8 (B, m, n - c0)
// and the column order (B, n) int32 (the position each column came from).
// Two loads: "perm" gathers frame b's columns from the static H packed by
// columns (hcol, (n, mw) int32): column p of the frame is column perm[b, p]
// of H; "dense" reads a (B, m, n) int8 batch.
//
// What bounds it on H100: bytes at the main path (B = 32768, m = 64,
// n = 128, tail 64): perm in (33.5 MB), the tail (134 MB) and the order
// (16.8 MB) out, 0.0551 ms at 3.35 TB/s, against about 0.54 G word XORs
// (B m^2 nw, 0.032 ms on 64 INT32 lanes an SM).  In block mode the XORs
// bound it: wimaxlike 192 x 384 at 4,096 frames 0.108 ms, WiMAX 176 x 1056
// at 1,024 frames 0.063 ms.
//
// Design, for those bytes: the matrix never reaches device memory, and the
// threads own COLUMNS, each column's m rows as bits in registers (MW words),
// so that a step exchanges nothing between threads but column t:
// - load: the perm load gathers H's packed columns (column p of frame b is
//   hcol[perm[b, p]]); the dense load reads 32 rows x 32 columns a warp as
//   16-byte rows and transposes them (a 32 x 32 bit transpose by shuffles);
// - step t: column t is made known to the frame (two shuffles in a warp; in
//   a block thread t writes it and the pivot to shared memory, double-
//   buffered by step parity, behind one barrier); the pivot p is column t's
//   lowest set bit >= t, the same on every thread; then in each owned
//   column rows t and p swap and, where the new bit t is set, column t less
//   bit p is XORed in: folded into "where bit p was set, XOR A (column t,
//   bit t flipped); where bit t was set and p != t, XOR bits t and p", a
//   predicated XOR a word.  The step loop runs per word of t and a uniform
//   branch picks p's word, so both are compile-time and nothing indexes
//   registers at run time; a warp skips the slots whose columns are all < t
//   (final: e_j, or no bit at rows >= j);
// - no pivot (rank-deficient H only): the lowest column sc > t with bit t
//   set (a warp minimum, and a block-wide one over shared memory) takes
//   column t's part for the step, which turns it into e_t; columns t and
//   sc, both without bits at rows >= t from then on, are exchanged with
//   their order entries after the last step, swap by swap in step order;
// - out: the tail through the same 32 x 32 transposes, lane r writing row
//   r's 32 bytes of its warp's columns as two 16-byte stores (byte stores
//   where n or c0 is not a multiple of 16), and the order a column a thread.
// "warp" (m <= 64, n <= 128: CCSDS and the other short codes): a frame on
//   a warp, lane l owns columns l + 32 s (s < ceil(n/32)), so column t is
//   slot t >> 5 of lane t & 31; 8 frames a block.
// "block" (wimaxlike 192 x 384, WiMAX 176 x 1056, array_121_60's 66-row
//   raw H): a frame on a block of T = 32 ceil(m/32) threads (<= 256),
//   thread i owning columns i + T s, so column t (t < m <= T) is slot 0 of
//   thread t; up to 6 columns (BLOCK_COLS) of up to 8 words a thread.
// Registers (ptxas -v for sm_90a, cudaFuncGetAttributes) and resident
// frames an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) on an
// NVIDIA H100 80GB HBM3 (chip_smoke.py "GE launch shape" lines): warp
// ge_kernel<2, 4> (CCSDS) 38 registers, 48 frames; block <6, 2>
// (wimaxlike) 46 registers, 6 frames; <6, 6> (WiMAX) 78 registers, 4
// frames; <4, 2> (array_121_60's raw H) 47 registers, 13 frames; none of
// them spills.  Their registers are capped by min_blocks below.
// A shape that neither mode takes (m > 256 rows, or more than 6 columns
// for each of 256 threads) is refused by the host plan
// (ops/gf2_bitpack.py ge_plan) and here.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpFrames = 8;         // frames (warps) a block, warp mode
constexpr int kWarpCols = 4;           // columns a lane, at most, warp mode
constexpr int kBlockMaxThreads = 256;  // block mode

// One owned column's words c at step t with pivot p: rows t and p swap (bits
// t and p of c), then where the new bit t (the old bit p) is set, c XORs
// column t less bit p.  With A = column t with bit t flipped (a pivot) or
// cleared (none, p = t), that is: where bit p was set, c ^= A; where bit t
// was set and p != t (SWAP), c ^= bits t and p.  tb and pb are the bits of
// t and p in their words JW and PW.  The conditions compile to predicated
// XORs (sign masks and one LOP3 a word were 7% slower on the card).
template <int MW, int JW, int PW, bool SWAP>
__device__ __forceinline__ void update_column(uint32_t (&c)[MW], uint32_t tb,
                                              uint32_t pb,
                                              const uint32_t (&a)[MW]) {
  const bool hp = (c[PW] & pb) != 0;
  const bool ht = SWAP && (c[JW] & tb) != 0;
  if (hp) {
#pragma unroll
    for (int w = 0; w < MW; ++w) c[w] ^= a[w];
  }
  if (ht) {
    c[JW] ^= tb;
    c[PW] ^= pb;
  }
}

// Whether slot s of this thread's warp holds a column that step t can
// change: columns < t are final (e_j, or no bit at rows >= j), columns >= n
// do not exist.  The same on every lane of the warp; compile-time but for
// a block's first slot (columns < T, some < t) and the last (some >= n).
template <int CPT, bool WARP, int JW>
__device__ __forceinline__ bool slot_live(int s, int tid, int nthr, int t,
                                          int n) {
  if (WARP) return s >= JW;  // CPT = ceil(n / 32): no slot is empty
  if (s > 0 && s < CPT - 1) return true;
  const int first = (tid & ~31) + nthr * s;
  return first < n && first + 31 >= t;
}

// Every owned column at p != t; p's word pw (>= JW, the same on every
// thread) becomes the compile-time PW by a uniform branch.
template <int MW, int CPT, bool WARP, int JW, int PW = JW>
__device__ __forceinline__ void update_swapping(uint32_t (&col)[CPT][MW],
                                                int p, uint32_t tb,
                                                const uint32_t (&a)[MW],
                                                int tid, int nthr, int t,
                                                int n) {
  if constexpr (PW + 1 < MW) {
    if ((p >> 5) != PW) {
      update_swapping<MW, CPT, WARP, JW, PW + 1>(col, p, tb, a, tid, nthr, t,
                                                 n);
      return;
    }
  }
  const uint32_t pb = 1u << (p & 31);
#pragma unroll
  for (int s = 0; s < CPT; ++s)
    if (slot_live<CPT, WARP, JW>(s, tid, nthr, t, n))
      update_column<MW, JW, PW, true>(col[s], tb, pb, a);
}

// The lowest set bit at or above bit jb of word JW of v, or -1.
template <int MW, int JW>
__device__ __forceinline__ int lowest_from(const uint32_t (&v)[MW], int jb) {
  const uint32_t lo = v[JW] & (kFull << jb);
  if (lo) return 32 * JW + __ffs(lo) - 1;
  int p = -1;
#pragma unroll
  for (int w = MW - 1; w > JW; --w)
    if (v[w]) p = 32 * w + __ffs(v[w]) - 1;
  return p;
}

// A frame's shared words: column t and its pivot (block mode, words 0..7
// and 8, double-buffered by step parity), two columns' words and order entries being exchanged, each
// warp's lowest swap-column candidate (block mode), and the deferred column
// swaps, (t << 16) | sc, at most one a step of R.
template <int R>
struct FrameShared {
  uint32_t colt[2][12];
  uint32_t x[8], y[8];
  int xo, yo;
  int wmin[kBlockMaxThreads / 32];
  int swaps[R];
};

template <bool WARP>
__device__ __forceinline__ void frame_sync() {
  if constexpr (WARP)
    __syncwarp();
  else
    __syncthreads();
}

// No pivot at step t: the lowest column sc > t with bit t set takes column
// t's part, colT becoming its words.  The exchange of the two columns is
// deferred (apply_swaps): the step turns column sc into e_t in place of
// column t, and both have no bit at rows >= t, so no later step changes or
// picks either.  Paid only on such steps (rank-deficient H).
template <int MW, int CPT, bool WARP, int JW, int R>
__device__ __forceinline__ void find_swap(const uint32_t (&col)[CPT][MW],
                                          uint32_t (&colT)[MW],
                                          FrameShared<R>& fs, int& nsw,
                                          int tid, int nthr, int t,
                                          uint32_t tb, int n) {
  int cand = INT_MAX;
#pragma unroll
  for (int s = CPT - 1; s >= 0; --s) {
    const int c = tid + nthr * s;
    if (c > t && c < n && (col[s][JW] & tb)) cand = c;
  }
  int sc = __reduce_min_sync(kFull, cand);
  if constexpr (!WARP) {
    if ((tid & 31) == 0) fs.wmin[tid >> 5] = sc;
    __syncthreads();
    sc = INT_MAX;
    for (int i = 0; i < (nthr >> 5); ++i) sc = min(sc, fs.wmin[i]);
  }
  if (sc == INT_MAX) return;  // neither: the columns stay
  const int so = sc % nthr, ss = sc / nthr;
  uint32_t v[MW];
#pragma unroll
  for (int w = 0; w < MW; ++w) v[w] = col[0][w];
#pragma unroll
  for (int s = 1; s < CPT; ++s) {
    if (s == ss) {
#pragma unroll
      for (int w = 0; w < MW; ++w) v[w] = col[s][w];
    }
  }
  if constexpr (WARP) {
#pragma unroll
    for (int w = 0; w < MW; ++w) colT[w] = __shfl_sync(kFull, v[w], so);
  } else {
    if (tid == so) {
#pragma unroll
      for (int w = 0; w < MW; ++w) fs.x[w] = v[w];
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < MW; ++w) colT[w] = fs.x[w];
  }
  if (tid == 0) fs.swaps[nsw] = (t << 16) | sc;
  ++nsw;
}

// Slot s of this thread's columns: its words into x and order entry into
// xo where s == slot (a select over the slots, no indexing at run time).
template <int MW, int CPT>
__device__ __forceinline__ void read_slot(const uint32_t (&col)[CPT][MW],
                                          const int (&ord)[CPT], int slot,
                                          uint32_t* x, int* xo) {
#pragma unroll
  for (int s = 0; s < CPT; ++s) {
    if (s == slot) {
      *xo = ord[s];
#pragma unroll
      for (int w = 0; w < MW; ++w) x[w] = col[s][w];
    }
  }
}

template <int MW, int CPT>
__device__ __forceinline__ void write_slot(uint32_t (&col)[CPT][MW],
                                           int (&ord)[CPT], int slot,
                                           const uint32_t* x, int xo) {
#pragma unroll
  for (int s = 0; s < CPT; ++s) {
    if (s == slot) {
      ord[s] = xo;
#pragma unroll
      for (int w = 0; w < MW; ++w) col[s][w] = x[w];
    }
  }
}

// The deferred column swaps, in step order: columns t and sc exchange their
// words and order entries.
template <int MW, int CPT, bool WARP, int R>
__device__ __forceinline__ void apply_swaps(uint32_t (&col)[CPT][MW],
                                            int (&ord)[CPT],
                                            FrameShared<R>& fs, int nsw,
                                            int tid, int nthr) {
  if (nsw == 0) return;
  frame_sync<WARP>();
  for (int i = 0; i < nsw; ++i) {
    const int t = fs.swaps[i] >> 16, sc = fs.swaps[i] & 0xffff;
    const int ot = t % nthr, st = t / nthr, os = sc % nthr, ss = sc / nthr;
    if (tid == ot) read_slot<MW, CPT>(col, ord, st, fs.x, &fs.xo);
    if (tid == os) read_slot<MW, CPT>(col, ord, ss, fs.y, &fs.yo);
    frame_sync<WARP>();
    if (tid == ot) write_slot<MW, CPT>(col, ord, st, fs.y, fs.yo);
    if (tid == os) write_slot<MW, CPT>(col, ord, ss, fs.x, fs.xo);
    frame_sync<WARP>();
  }
}

// The steps t = 32 JW .. of word JW: column t made known to the frame,
// the pivot, a swap column where there is none, and the elimination.
template <int MW, int CPT, bool WARP, int JW, int R>
__device__ __forceinline__ void steps(uint32_t (&col)[CPT][MW],
                                      FrameShared<R>& fs, int& nsw, int tid,
                                      int nthr, int m, int n) {
  if constexpr (JW < MW) {
    constexpr int TS = WARP ? JW : 0;  // column t's slot
#pragma unroll 1
    for (int jb = 0; jb < 32 && 32 * JW + jb < m; ++jb) {
      const int t = 32 * JW + jb;
      const uint32_t tb = 1u << jb;
      uint32_t colT[MW];
      int p;
      if constexpr (WARP) {
#pragma unroll
        for (int w = 0; w < MW; ++w)
          colT[w] = __shfl_sync(kFull, col[TS][w], jb);
        p = lowest_from<MW, JW>(colT, jb);
      } else {  // thread t finds the pivot once for the block
        uint32_t* buf = fs.colt[t & 1];
        if (tid == t) {
#pragma unroll
          for (int w = 0; w < MW; ++w) buf[w] = col[TS][w];
          buf[8] = static_cast<uint32_t>(lowest_from<MW, JW>(col[TS], jb));
        }
        __syncthreads();
#pragma unroll
        for (int w = 0; w < MW; ++w) colT[w] = buf[w];
        p = static_cast<int>(buf[8]);
      }
      if (p < 0)
        find_swap<MW, CPT, WARP, JW>(col, colT, fs, nsw, tid, nthr, t, tb, n);
      uint32_t a[MW];
#pragma unroll
      for (int w = 0; w < MW; ++w) a[w] = colT[w];
      a[JW] = p < 0 ? a[JW] & ~tb : a[JW] ^ tb;
      if (p < 0 || p == t) {  // rows stay: bit p is bit t
#pragma unroll
        for (int s = 0; s < CPT; ++s)
          if (slot_live<CPT, WARP, JW>(s, tid, nthr, t, n))
            update_column<MW, JW, JW, false>(col[s], tb, tb, a);
      } else {
        update_swapping<MW, CPT, WARP, JW>(col, p, tb, a, tid, nthr, t, n);
      }
    }
    steps<MW, CPT, WARP, JW + 1>(col, fs, nsw, tid, nthr, m, n);
  }
}

// The 32 x 32 bit matrix held a word a lane, transposed: bit r of lane l's
// word becomes bit l of lane r's (five butterfly rounds of shuffles).
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  uint32_t m = 0x0000ffffu;
#pragma unroll
  for (int j = 16; j > 0; j >>= 1, m ^= m << j) {
    const uint32_t y = __shfl_xor_sync(kFull, x, j);
    x = (lane & j) ? (x & ~m) | ((y >> j) & m) : (x & m) | ((y << j) & ~m);
  }
  return x;
}

// Bit i of y as byte i (0 or 1) of row[off .. off + 32), 16 bytes a store,
// the first half where lo and the second where hi (16-byte aligned).
__device__ __forceinline__ void store_bits(int8_t* row, int off, uint32_t y,
                                           bool lo, bool hi) {
  uint32_t w[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)  // a nibble spread to the low bit of 4 bytes
    w[q] = (((y >> (4 * q)) & 0xfu) * 0x00204081u) & 0x01010101u;
  if (lo)
    *reinterpret_cast<uint4*>(row + off) = make_uint4(w[0], w[1], w[2], w[3]);
  if (hi)
    *reinterpret_cast<uint4*>(row + off + 16) =
        make_uint4(w[4], w[5], w[6], w[7]);
}

// Byte i != 0 of row[off .. off + 32) as bit i, the halves read where lo /
// hi (else 0), 16 bytes a load (16-byte aligned).
__device__ __forceinline__ uint32_t load_bits(const int8_t* row, int off,
                                              bool lo, bool hi) {
  uint4 v0 = make_uint4(0, 0, 0, 0), v1 = v0;
  if (lo) v0 = *reinterpret_cast<const uint4*>(row + off);
  if (hi) v1 = *reinterpret_cast<const uint4*>(row + off + 16);
  const uint32_t w[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  uint32_t bits = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    uint32_t x = w[q];  // bit 0 of each byte: the OR of its 8 bits
    x |= x >> 4;
    x |= x >> 2;
    x |= x >> 1;
    bits |= (((x & 0x01010101u) * 0x10204080u) >> 28) << (4 * q);
  }
  return bits;
}

// Resident blocks an SM that the register cap must allow: 6 warp-mode
// blocks (48 frames); 3 blocks of 256 for a block frame of 24 or more
// column words a thread (85 registers: 4 WiMAX frames of 192 threads),
// else 5 (51 registers: 7 wimaxlike frames).
template <int MW, int CPT, bool WARP>
constexpr int min_blocks() {
  return WARP ? 6 : (MW * CPT >= 24 ? 3 : 5);
}

template <int MW, int CPT, bool WARP>
__global__ void __launch_bounds__(kBlockMaxThreads, min_blocks<MW, CPT, WARP>())
    ge_kernel(const int64_t* __restrict__ perm,
              const uint32_t* __restrict__ hcol, int mw,
              const int8_t* __restrict__ dense, int8_t* __restrict__ out,
              int32_t* __restrict__ order, int batch, int m, int n, int c0) {
  constexpr int R = WARP ? 64 : kBlockMaxThreads;  // steps a frame, at most
  __shared__ FrameShared<R> shared[WARP ? kWarpFrames : 1];
  const int tid = WARP ? threadIdx.x & 31 : threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int nthr = WARP ? 32 : blockDim.x;
  const long long b =
      WARP ? static_cast<long long>(blockIdx.x) * kWarpFrames +
                 (threadIdx.x >> 5)
           : blockIdx.x;
  if (b >= batch) return;  // a whole warp (warp mode) leaves together
  FrameShared<R>& fs = shared[WARP ? threadIdx.x >> 5 : 0];

  // columns tid + T s, a bit a row; columns >= n and rows >= m stay 0
  uint32_t col[CPT][MW];
  int ord[CPT];
#pragma unroll
  for (int s = 0; s < CPT; ++s) {
    ord[s] = tid + nthr * s;
#pragma unroll
    for (int w = 0; w < MW; ++w) col[s][w] = 0;
  }
  if (perm != nullptr) {
#pragma unroll
    for (int s = 0; s < CPT; ++s) {
      const int c = tid + nthr * s;
      if (c < n) {
        const long long j = perm[b * n + c];
#pragma unroll
        for (int w = 0; w < MW; ++w)
          if (w < mw) col[s][w] = hcol[j * mw + w];
      }
    }
  } else if ((n & 15) == 0) {
    // a warp's 32 columns g..: lane l reads row 32 w + l's 32 bytes of
    // them, and a transpose gives each lane its column's word w.  The
    // shuffles stay outside any condition the compiler cannot see is the
    // same on the whole warp (else it emulates them, slowly).
    const int8_t* f = dense + b * m * n;
#pragma unroll
    for (int s = 0; s < CPT; ++s) {
      const int g = (tid & ~31) + nthr * s;
      if (WARP && g >= n) continue;  // g = 32 s: known uniform
#pragma unroll
      for (int w = 0; w < MW; ++w) {
        if (32 * w >= m) continue;
        const int r = 32 * w + lane;
        const uint32_t bits =
            r < m && g < n ? load_bits(f + r * n, g, true, g + 32 <= n) : 0u;
        col[s][w] = transpose32(bits, lane);
      }
    }
  } else {
    const int8_t* f = dense + b * m * n;
#pragma unroll
    for (int s = 0; s < CPT; ++s) {
      const int c = tid + nthr * s;
      if (c >= n) continue;
#pragma unroll
      for (int w = 0; w < MW; ++w) {
#pragma unroll 1
        for (int rb = 0; rb < 32; ++rb) {
          const int r = 32 * w + rb;
          if (r < m && f[r * n + c] != 0) col[s][w] |= 1u << rb;
        }
      }
    }
  }

  int nsw = 0;  // deferred column swaps, the same count on every thread
  steps<MW, CPT, WARP, 0>(col, fs, nsw, tid, nthr, m, n);
  apply_swaps<MW, CPT, WARP>(col, ord, fs, nsw, tid, nthr);

  const int kt = n - c0;
  int8_t* o = out + b * m * kt;
  int32_t* ob = order + b * n;
#pragma unroll
  for (int s = 0; s < CPT; ++s) {
    const int c = tid + nthr * s;
    if (c < n) ob[c] = ord[s];
  }
  if ((n & 15) == 0 && (c0 & 15) == 0) {
    // a warp's 32 columns transposed to rows: lane l writes row 32 w + l's
    // 32 bytes of them, 16 a store
#pragma unroll
    for (int s = 0; s < CPT; ++s) {
      const int g = (tid & ~31) + nthr * s;
      if (WARP && (g + 32 <= c0 || g >= n)) continue;
      const bool lo = g >= c0 && g + 16 <= n;
      const bool hi = g + 16 >= c0 && g + 32 <= n;
#pragma unroll
      for (int w = 0; w < MW; ++w) {
        if (32 * w >= m) continue;
        const uint32_t y = transpose32(col[s][w], lane);
        const int r = 32 * w + lane;
        if (r < m) store_bits(o + r * kt, g - c0, y, lo, hi);
      }
    }
    return;
  }
  // else the tail a byte a column (32 bytes a warp a row)
#pragma unroll
  for (int s = 0; s < CPT; ++s) {
    const int c = tid + nthr * s;
    if (c < c0 || c >= n) continue;
#pragma unroll
    for (int w = 0; w < MW; ++w) {
#pragma unroll 1
      for (int rb = 0; rb < 32; ++rb) {
        const int r = 32 * w + rb;
        if (r < m)
          o[r * kt + c - c0] = static_cast<int8_t>((col[s][w] >> rb) & 1u);
      }
    }
  }
}

using Kernel = void (*)(const int64_t*, const uint32_t*, int, const int8_t*,
                        int8_t*, int32_t*, int, int, int, int);

template <int MW>
Kernel pick_block_cols(int cols) {
  switch (cols) {
    case 2: return ge_kernel<MW, 2, false>;
    case 4: return ge_kernel<MW, 4, false>;
    case 6: return ge_kernel<MW, 6, false>;
    default: return nullptr;
  }
}

// warp mode: words a column 1 or 2 x columns a lane ceil(n / 32) <= 4;
// block mode: words {2, 4, 6, 8} x columns a thread {2, 4, 6}, as
// ops/gf2_bitpack.py BLOCK_WORDS and BLOCK_COLS
Kernel pick(int mode, int words, int cols) {
  if (mode == 0) {
    switch (words * 8 + cols) {
      case 9: return ge_kernel<1, 1, true>;
      case 10: return ge_kernel<1, 2, true>;
      case 11: return ge_kernel<1, 3, true>;
      case 12: return ge_kernel<1, 4, true>;
      case 18: return ge_kernel<2, 2, true>;
      case 19: return ge_kernel<2, 3, true>;
      case 20: return ge_kernel<2, 4, true>;
      default: return nullptr;
    }
  }
  if (mode != 1) return nullptr;
  switch (words) {
    case 2: return pick_block_cols<2>(cols);
    case 4: return pick_block_cols<4>(cols);
    case 6: return pick_block_cols<6>(cols);
    case 8: return pick_block_cols<8>(cols);
    default: return nullptr;
  }
}

// The plan (mode 0 warp, 1 block; words a column, columns a thread,
// threads a block) is one that ops/gf2_bitpack.py ge_plan makes for (m, n).
bool plan_ok(int m, int n, int mode, int words, int cols, int threads) {
  if (pick(mode, words, cols) == nullptr) return false;
  if (mode == 0)
    return m <= 64 && n <= 32 * kWarpCols && words == (m + 31) / 32 &&
           cols == (n + 31) / 32 && threads == kWarpFrames * 32;
  return threads % 32 == 0 && threads >= m && threads <= kBlockMaxThreads &&
         32 * words >= m && cols * threads >= n;
}

}  // namespace

// perm (B, n) int64 with hcol (n, mw) int32, or dense (B, m, n) int8 (the
// other null); out (B, m, n - c0) int8; order (B, n) int32.  The plan
// (mode, words, cols, threads, grid) from ge_plan, checked here.
extern "C" int ge_launch(const void* perm, const void* hcol, int mw,
                         const void* dense, void* out, void* order, int batch,
                         int m, int n, int c0, int mode, int words, int cols,
                         int threads, int grid, void* stream) {
  const bool from_perm = perm != nullptr;
  const bool ok = batch > 0 && m > 0 && n > 0 && c0 >= 0 && c0 < n &&
                  from_perm == (hcol != nullptr) &&
                  from_perm != (dense != nullptr) &&
                  (!from_perm || mw == (m + 31) / 32) && out != nullptr &&
                  order != nullptr &&
                  plan_ok(m, n, mode, words, cols, threads) &&
                  grid == (mode == 0 ? (batch + kWarpFrames - 1) / kWarpFrames
                                     : batch);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Kernel kern = pick(mode, words, cols);
  kern<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(perm), static_cast<const uint32_t*>(hcol),
      mw, static_cast<const int8_t*>(dense), static_cast<int8_t*>(out),
      static_cast<int32_t*>(order), batch, m, n, c0);
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of a plan's kernel: out = {registers, local bytes a
// thread, threads a block, resident blocks per SM, SMs, static shared
// bytes}; returns a cudaError.
extern "C" int ge_occupancy(int m, int n, int mode, int words, int cols,
                            int threads, int device, int* out) {
  if (!plan_ok(m, n, mode, words, cols, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kern = reinterpret_cast<const void*>(pick(mode, words, cols));
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads,
                                                      0);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = threads;
  out[3] = blocks;
  out[4] = sms;
  out[5] = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}
