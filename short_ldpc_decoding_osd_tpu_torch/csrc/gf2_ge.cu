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
// Two loads: "perm" builds frame b's rows from the static H packed by
// columns (hcol, (n, mw) int32) and its permutation perm[b] (B, n) int64,
// so that column p of the frame is column perm[b, p] of H; "dense" reads a
// (B, m, n) int8 batch.
//
// What bounds it on H100: bytes.  At the main path (B = 32768, m = 64,
// n = 128, tail 64) it reads perm (33.5 MB) and writes the tail (134 MB)
// and the order (16.8 MB): 0.055 ms at 3.35 TB/s, against about 0.54 G
// word XORs (B m^2 nw, 0.032 ms on 64 INT32 lanes an SM).
//
// Design, for those bytes: the matrix never reaches device memory.  Each
// frame's rows are built on load as 32-bit words of columns (one ballot
// per row and word: lane l contributes column 32q + l, read coalesced from
// perm or from the dense batch), eliminated on chip, and only the tail
// columns and the order are written, the tail four bytes a lane where the
// shapes allow.
// - "warp" (m <= 64, n <= 128: CCSDS and the other short codes): a frame
//   on one warp, lane l holds rows l and l + 32 in registers (2 x nw
//   words).  The pivot is a ballot of bit t over the rows >= t and __ffs;
//   rows t and p and row t for the swap-column search and the XOR come by
//   __shfl_sync; the column order is an int array in shared memory that
//   lane 0 swaps.  No block barrier in the loop.  The load's ballot loops
//   stay rolled: unrolled by the compiler they took the kernel to 178-255
//   registers, one block an SM and 0.74 ms at the main path, against 47
//   registers and 0.49 ms rolled (NVIDIA H100 80GB HBM3, 700 W).
// - "block" (larger codes: wimaxlike 192 x 384, WiMAX 176 x 1056): a frame
//   on one block, its rows in shared memory (m x nw words, 23 KB for
//   WiMAX), the pivot by a shared atomicMin, the swap column by warp 0,
//   the row XOR a warp a row.
// A shape that neither takes (a frame's rows beyond shared memory) is
// refused by the host plan (ops/gf2_bitpack.py ge_plan) and checked here.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpFrames = 8;     // frames (warps) a block, warp mode
constexpr int kBlockThreads = 256;  // block mode
constexpr int kMaxSmem = 232448;    // 227 KB, the opt-in limit of a block

// bits jb+1.. of a word (none at jb = 31)
__device__ __forceinline__ uint32_t above(int jb) {
  return jb == 31 ? 0u : (kFull << (jb + 1));
}

template <int NW>
__device__ __forceinline__ uint32_t pick(const uint32_t (&w)[NW], int q) {
  uint32_t v = w[0];
#pragma unroll
  for (int i = 1; i < NW; ++i) v = q == i ? w[i] : v;
  return v;
}

// Writes a frame's tail columns c0..n-1 (int8) from its packed rows in
// shared memory, and its column order; threads tid, tid + nthr, ...
__device__ void write_frame(const uint32_t* rows, const int* order_s, int nw,
                            int m, int n, int c0, int8_t* out,
                            int32_t* order, int tid, int nthr) {
  const int kt = n - c0;
  if ((kt & 3) == 0 && (c0 & 3) == 0) {
    // four columns a thread: one nibble of a word -> four bytes
    const int kq = kt >> 2;
    uint32_t* out4 = reinterpret_cast<uint32_t*>(out);
    int r = 0, g = tid;
    while (g >= kq) { g -= kq; ++r; }
    while (r < m) {
      const int c = c0 + 4 * g;
      const uint32_t v = (rows[r * nw + (c >> 5)] >> (c & 31)) & 0xfu;
      out4[r * kq + g] = (v & 1u) | ((v & 2u) << 7) | ((v & 4u) << 14) |
                         ((v & 8u) << 21);
      g += nthr;
      while (g >= kq) { g -= kq; ++r; }
    }
  } else {
    int r = 0, g = tid;
    while (g >= kt) { g -= kt; ++r; }
    while (r < m) {
      const int c = c0 + g;
      out[r * kt + g] =
          static_cast<int8_t>((rows[r * nw + (c >> 5)] >> (c & 31)) & 1u);
      g += nthr;
      while (g >= kt) { g -= kt; ++r; }
    }
  }
  for (int p = tid; p < n; p += nthr) order[p] = order_s[p];
}

// ---------------------------------------------------------------- warp mode
template <int NW>
__global__ void __launch_bounds__(kWarpFrames * 32)
    ge_warp_kernel(const int64_t* __restrict__ perm,
                   const uint32_t* __restrict__ hcol, int mw,
                   const int8_t* __restrict__ dense, int8_t* __restrict__ out,
                   int32_t* __restrict__ order, int batch, int m, int n,
                   int c0) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWarpFrames + warp;
  if (b >= batch) return;  // the whole warp leaves together
  uint32_t* rows_s = smem + warp * (64 * NW);
  int* order_s = reinterpret_cast<int*>(smem + kWarpFrames * 64 * NW) +
                 warp * (32 * NW);

  // rows lane (r0) and lane + 32 (r1); rows >= m stay 0
  uint32_t r0[NW], r1[NW];
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    r0[q] = 0;
    r1[q] = 0;
    const int p = 32 * q + lane;
    if (perm != nullptr) {
      uint64_t col = 0;  // column perm[b, p] of H, a bit a row
      if (p < n) {
        const long long j = perm[b * n + p];
        col = hcol[j * mw];
        if (mw > 1) col |= static_cast<uint64_t>(hcol[j * mw + 1]) << 32;
      }
#pragma unroll 1
      for (int rr = 0; rr < 32; ++rr) {
        const uint32_t w0 = __ballot_sync(kFull, (col >> rr) & 1u);
        const uint32_t w1 = __ballot_sync(kFull, (col >> (rr + 32)) & 1u);
        if (lane == rr) {
          r0[q] = w0;
          r1[q] = w1;
        }
      }
    } else {
      const int8_t* f = dense + b * m * n;
#pragma unroll 1
      for (int rr = 0; rr < 32; ++rr) {
        const bool v0 = p < n && rr < m && f[rr * n + p] != 0;
        const bool v1 = p < n && rr + 32 < m && f[(rr + 32) * n + p] != 0;
        const uint32_t w0 = __ballot_sync(kFull, v0);
        const uint32_t w1 = __ballot_sync(kFull, v1);
        if (lane == rr) {
          r0[q] = w0;
          r1[q] = w1;
        }
      }
    }
  }
  for (int p = lane; p < 32 * NW; p += 32) order_s[p] = p;
  __syncwarp();

  for (int t = 0; t < m; ++t) {
    const int jw = t >> 5, jb = t & 31;
    const uint32_t bt = 1u << jb;
    const int src_t = t & 31;
    const bool t_hi = t >= 32;
    const uint32_t piv0 = __ballot_sync(kFull, (pick(r0, jw) & bt) && lane >= t);
    const uint32_t piv1 =
        __ballot_sync(kFull, (pick(r1, jw) & bt) && lane + 32 >= t);
    if (piv0 | piv1) {
      const int p = piv0 ? __ffs(piv0) - 1 : 31 + __ffs(piv1);
      if (p != t) {  // rows t <-> p
        const int src_p = p & 31;
        const bool p_hi = p >= 32;
#pragma unroll
        for (int q = 0; q < NW; ++q) {
          const uint32_t vt = __shfl_sync(kFull, t_hi ? r1[q] : r0[q], src_t);
          const uint32_t vp = __shfl_sync(kFull, p_hi ? r1[q] : r0[q], src_p);
          if (lane == src_t) {
            if (t_hi) r1[q] = vp; else r0[q] = vp;
          }
          if (lane == src_p) {
            if (p_hi) r1[q] = vt; else r0[q] = vt;
          }
        }
      }
    } else {
      // swap column: the lowest set bit above t in row t
      int sc = -1;
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        uint32_t cand = __shfl_sync(kFull, t_hi ? r1[q] : r0[q], src_t);
        cand = q < jw ? 0u : (q == jw ? cand & above(jb) : cand);
        if (sc < 0 && cand != 0) sc = 32 * q + __ffs(cand) - 1;
      }
      if (sc >= 0) {  // columns t <-> sc
        const int sw = sc >> 5;
        const uint32_t bs = 1u << (sc & 31);
        const bool d0 = ((pick(r0, jw) & bt) != 0) != ((pick(r0, sw) & bs) != 0);
        const bool d1 = ((pick(r1, jw) & bt) != 0) != ((pick(r1, sw) & bs) != 0);
#pragma unroll
        for (int q = 0; q < NW; ++q) {
          const uint32_t cm = (q == jw ? bt : 0u) | (q == sw ? bs : 0u);
          if (d0) r0[q] ^= cm;
          if (d1) r1[q] ^= cm;
        }
        if (lane == 0) {
          const int o = order_s[t];
          order_s[t] = order_s[sc];
          order_s[sc] = o;
        }
      }
    }
    // row t into every other row with a 1 in column t
    const bool e0 = (pick(r0, jw) & bt) && lane != t;
    const bool e1 = (pick(r1, jw) & bt) && lane + 32 != t;
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      const uint32_t pv = __shfl_sync(kFull, t_hi ? r1[q] : r0[q], src_t);
      if (e0) r0[q] ^= pv;
      if (e1) r1[q] ^= pv;
    }
  }

#pragma unroll
  for (int q = 0; q < NW; ++q) {
    rows_s[lane * NW + q] = r0[q];
    rows_s[(lane + 32) * NW + q] = r1[q];
  }
  __syncwarp();
  write_frame(rows_s, order_s, NW, m, n, c0, out + b * m * (n - c0),
              order + b * n, lane, 32);
}

// --------------------------------------------------------------- block mode
__global__ void __launch_bounds__(kBlockThreads)
    ge_block_kernel(const int64_t* __restrict__ perm,
                    const uint32_t* __restrict__ hcol, int mw,
                    const int8_t* __restrict__ dense, int8_t* __restrict__ out,
                    int32_t* __restrict__ order, int batch, int m, int n,
                    int nw, int c0) {
  extern __shared__ uint32_t smem[];
  uint32_t* rows = smem;                                 // (m, nw)
  int* order_s = reinterpret_cast<int*>(smem + m * nw);  // (32 nw)
  __shared__ int s_piv, s_sc;
  const long long b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  if (perm != nullptr) {
    // warp w builds words q = w, w + nwarps, ...: lane l holds column
    // perm[b, 32q + l] of H, one ballot a row
    for (int q = warp; q < nw; q += nwarps) {
      const int p = 32 * q + lane;
      const long long j = p < n ? perm[b * n + p] : -1;
      for (int r5 = 0; r5 < mw; ++r5) {
        const uint32_t hw = j >= 0 ? hcol[j * mw + r5] : 0u;
        for (int rb = 0; rb < 32 && 32 * r5 + rb < m; ++rb) {
          const uint32_t w = __ballot_sync(kFull, (hw >> rb) & 1u);
          if (lane == rb) rows[(32 * r5 + rb) * nw + q] = w;
        }
      }
    }
  } else {
    const int8_t* f = dense + b * m * n;
    for (int r = warp; r < m; r += nwarps) {
      for (int q = 0; q < nw; ++q) {
        const int p = 32 * q + lane;
        const uint32_t w = __ballot_sync(kFull, p < n && f[r * n + p] != 0);
        if (lane == 0) rows[r * nw + q] = w;
      }
    }
  }
  for (int p = tid; p < 32 * nw; p += blockDim.x) order_s[p] = p;
  if (tid == 0) s_piv = INT_MAX;
  __syncthreads();

  for (int t = 0; t < m; ++t) {
    const int jw = t >> 5, jb = t & 31;
    const uint32_t bt = 1u << jb;
    for (int r = t + tid; r < m; r += blockDim.x)
      if (rows[r * nw + jw] & bt) atomicMin(&s_piv, r);
    __syncthreads();
    const int p = s_piv;
    if (p == INT_MAX) {
      if (warp == 0) {  // the swap column: lowest set bit above t in row t
        int sc = -1;
        for (int base = jw; base < nw && sc < 0; base += 32) {
          const int q = base + lane;
          uint32_t cand = q < nw ? rows[t * nw + q] : 0u;
          if (q == jw) cand &= above(jb);
          const uint32_t any = __ballot_sync(kFull, cand != 0);
          if (any) {
            const int src = __ffs(any) - 1;
            const uint32_t c = __shfl_sync(kFull, cand, src);
            sc = 32 * (base + src) + __ffs(c) - 1;
          }
        }
        if (lane == 0) s_sc = sc;
      }
      __syncthreads();
      const int sc = s_sc;
      if (sc >= 0) {  // columns t <-> sc
        const int sw = sc >> 5;
        const uint32_t bs = 1u << (sc & 31);
        for (int r = tid; r < m; r += blockDim.x) {
          uint32_t* row = rows + r * nw;
          if (((row[jw] & bt) != 0) != ((row[sw] & bs) != 0)) {
            row[jw] ^= bt;
            row[sw] ^= bs;
          }
        }
        if (tid == 0) {
          const int o = order_s[t];
          order_s[t] = order_s[sc];
          order_s[sc] = o;
        }
      }
    } else if (p != t) {  // rows t <-> p
      for (int q = tid; q < nw; q += blockDim.x) {
        const uint32_t v = rows[t * nw + q];
        rows[t * nw + q] = rows[p * nw + q];
        rows[p * nw + q] = v;
      }
    }
    __syncthreads();
    // row t into every other row with a 1 in column t, a warp a row; the
    // row's flag is read by lane 0 before any lane writes the row
    const uint32_t* row_t = rows + t * nw;
    for (int r = warp; r < m; r += nwarps) {
      if (r == t) continue;
      const bool hit =
          __shfl_sync(kFull, lane == 0 ? rows[r * nw + jw] & bt : 0u, 0) != 0;
      if (hit)
        for (int q = lane; q < nw; q += 32) rows[r * nw + q] ^= row_t[q];
    }
    if (tid == 0) s_piv = INT_MAX;
    __syncthreads();
  }
  write_frame(rows, order_s, nw, m, n, c0, out + b * m * (n - c0),
              order + b * n, tid, blockDim.x);
}

using WarpKernel = void (*)(const int64_t*, const uint32_t*, int,
                            const int8_t*, int8_t*, int32_t*, int, int, int,
                            int);

WarpKernel pick_warp(int nw) {
  switch (nw) {
    case 1: return ge_warp_kernel<1>;
    case 2: return ge_warp_kernel<2>;
    case 3: return ge_warp_kernel<3>;
    case 4: return ge_warp_kernel<4>;
    default: return nullptr;
  }
}

}  // namespace

// perm (B, n) int64 with hcol (n, mw) int32, or dense (B, m, n) int8 (the
// other null); out (B, m, n - c0) int8; order (B, n) int32.  mode 0 warp,
// 1 block; threads, smem_bytes and grid from ge_plan, checked here.
extern "C" int ge_launch(const void* perm, const void* hcol, int mw,
                         const void* dense, void* out, void* order, int batch,
                         int m, int n, int c0, int mode, int nw, int threads,
                         int smem_bytes, int grid, void* stream) {
  const bool from_perm = perm != nullptr;
  bool ok = batch > 0 && m > 0 && n > 0 && c0 >= 0 && c0 < n &&
            nw == (n + 31) / 32 && from_perm == (hcol != nullptr) &&
            from_perm != (dense != nullptr) &&
            (!from_perm || mw == (m + 31) / 32) && out != nullptr &&
            order != nullptr && smem_bytes <= kMaxSmem;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* pp = static_cast<const int64_t*>(perm);
  const uint32_t* hc = static_cast<const uint32_t*>(hcol);
  const int8_t* dn = static_cast<const int8_t*>(dense);
  int8_t* o = static_cast<int8_t*>(out);
  int32_t* ord = static_cast<int32_t*>(order);
  if (mode == 0) {
    const WarpKernel kern = pick_warp(nw);
    ok = ok && kern != nullptr && m <= 64 && threads == kWarpFrames * 32 &&
         grid == (batch + kWarpFrames - 1) / kWarpFrames &&
         smem_bytes == kWarpFrames * (64 * nw + 32 * nw) * 4;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, threads, smem_bytes, st>>>(pp, hc, mw, dn, o, ord, batch, m,
                                            n, c0);
  } else if (mode == 1) {
    ok = ok && threads == kBlockThreads && grid == batch &&
         smem_bytes == (m * nw + 32 * nw) * 4;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        ge_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ge_block_kernel<<<grid, threads, smem_bytes, st>>>(pp, hc, mw, dn, o, ord,
                                                       batch, m, n, nw, c0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
