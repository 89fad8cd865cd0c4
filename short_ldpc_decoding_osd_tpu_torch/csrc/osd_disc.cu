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
// What bounds it on H100: 2 B m k N int8 operations (412 G at the main
// path's B = 32768, N = 1536, m = k = 64: 0.208 ms at 1,979 TOP/s), against
// 0.34 GB of compulsory traffic (0.10 ms) and B m N weighted adds (0.10 ms
// on the f32 pipe): it is bound by operations.
//
// Design.  The inner sums are exact small integers, so they run as
// mma.sync m16n8k32 s8 x s8 -> s32 and `acc & 1` is the parity.  The MMA's
// rows are 16 TEPs (A, a tile of T) and its columns 8 check rows of one
// frame (B, M[b] as it lies: row-major (m, k) is the "col" operand), so a
// thread's accumulators are two TEPs x two check rows, and the u_l-weighted
// sum over check rows is a predicated add per accumulator plus two quad
// shuffles.  The host's plan (ops/osd_disc.py lterm_plan) fixes the tiles;
// this file checks it.
// - Operands read about once: a block keeps a tile of T (every TEP at the
//   main path, 1536 x 80 bytes) in shared memory for its whole life and
//   walks frames block-strided (persistent), M[b] and u_l[b] streamed in by
//   cp.async (16-byte chunks, zero-filled padding) into two buffers, the
//   next frame landing while this one computes: M is read once per TEP tile
//   of the plan (once at the main path) instead of 12 times, and nothing is
//   packed.  Fragments come from shared memory by ldmatrix (rows padded by
//   16 bytes, so conflict-free).
// - The inner loop on the tensor cores: one MMA replaces the 4096 AND/XOR/
//   POPC products of a 16 x 8 x 32 tile.  Where a frame's B fragments fit
//   in registers (m <= 64, k <= 64: "resident", the main path) a warp loads
//   them and the frame's u_l once and runs every TEP tile it owns against
//   them, reading only A (64 bytes of shared memory per MMA); larger frames
//   ("general") loop over 32-row groups and 32-byte k chunks with A and B
//   from shared memory.
// - Every shape: k is padded with zeros to 32, m with zero rows whose u is
//   0, the ragged N and B edges are masked; a frame larger than shared
//   memory (far above every packaged code; WiMAX's 176 x 880 takes 175 KB)
//   is refused by the plan.
// Summation order, all in f64: a thread adds its check rows 8j + 2t and
// 8j + 2t + 1 in two chains over ascending j (then row 2t's chain plus row
// 2t + 1's), the quad adds lanes t^1 then t^2, and the sum is rounded once
// to f32.  Every term is an exact f32 value, so the result is the exact sum
// rounded (up to f64 rounding, ~1e-16 relative): its difference from the
// plain twin is the twin's own f32 rounding.  An f32 sum is faster (about
// a third of the kernel at the main path on an H100) and gives that up.

#include <cuda_runtime.h>
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

  // the quad's sum for TEPs g and g + 8, rounded once; lanes t = 0 and 1
  // write 16 consecutive floats
  __device__ __forceinline__ void finish(float* outrow, int tep0, int lane,
                                        int ntot) const {
    double s0 = s[0] + s[1], s1 = s[2] + s[3];
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    const int g = lane >> 2, t = lane & 3;
    if (t == 0 && tep0 + g < ntot) outrow[tep0 + g] = __double2float_rn(s0);
    if (t == 1 && tep0 + g + 8 < ntot)
      outrow[tep0 + g + 8] = __double2float_rn(s1);
  }
};

// one frame, resident: the frame's 8 * TN rows x 32 * KCH bytes of B
// fragments and its u in registers, every TEP tile of the warp against them
template <int KCH, int TN>
__device__ __forceinline__ void frame_resident(const int8_t* s_t,
                                               const int8_t* s_mf,
                                               const double* s_uf,
                                               float* outrow, int S, int nt0,
                                               int ntot, int tiles) {
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
  for (int tile = warp; tile < tiles; tile += kWarps) {
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
    part.finish(outrow, nt0 + 16 * tile, lane, ntot);
  }
}

// one frame, general: groups of 8 * TN rows, k in 32-byte chunks, A and B
// from shared memory
template <int TN>
__device__ __forceinline__ void frame_general(const int8_t* s_t,
                                              const int8_t* s_mf,
                                              const double* s_uf,
                                              float* outrow, int S, int kch,
                                              int groups, int nt0, int ntot,
                                              int tiles) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int brow = (lane & 7) + 8 * (lane >> 4);
  const int bcol = 16 * ((lane >> 3) & 1);
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int acol = 16 * (lane >> 4);
  for (int tile = warp; tile < tiles; tile += kWarps) {
    const int8_t* a_base = s_t + (16 * tile + arow) * S + acol;
    Partials part;
    for (int grp = 0; grp < groups; ++grp) {
      const int row0 = 8 * TN * grp;
      const int8_t* b_base = s_mf + (row0 + brow) * S + bcol;
      int acc[TN][4];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
      for (int kc = 0; kc < kch; ++kc) {
        uint32_t af[4];
        ldsm_x4(smem_addr(a_base + 32 * kc), af[0], af[1], af[2], af[3]);
#pragma unroll
        for (int jj = 0; jj < TN / 2; ++jj) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(smem_addr(b_base + 16 * jj * S + 32 * kc), b0, b1, b2, b3);
          mma_s8(acc[2 * jj], af, b0, b1);
          mma_s8(acc[2 * jj + 1], af, b2, b3);
        }
      }
#pragma unroll
      for (int j = 0; j < TN; ++j)
        part.weigh(acc[j], *reinterpret_cast<const double2*>(
                               s_uf + row0 + 8 * j + 2 * t));
    }
    part.finish(outrow, nt0 + 16 * tile, lane, ntot);
  }
}

// KCH > 0: resident (m_pad == 8 TN, k_pad == 32 KCH); KCH == 0: general
template <int KCH, int TN>
__global__ void __launch_bounds__(kThreads, 1)
    lterm_kernel(const int8_t* __restrict__ mm, const float* __restrict__ ul,
                 const int8_t* __restrict__ tt, float* __restrict__ out,
                 int batch, int m, int k, int ntot, int m_pad, int k_pad,
                 int nt, int nbuf, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = k_pad + 16;
  int8_t* s_t = reinterpret_cast<int8_t*>(smem);     // nt rows of T
  int8_t* s_m = s_t + nt * S;                        // nbuf frames of M
  double* s_u = reinterpret_cast<double*>(s_m + nbuf * m_pad * S);
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

  for (int i = 0; f < batch; ++i, f += step) {
    const int cur = nbuf == 2 ? (i & 1) : 0;
    cp_async_wait_all();
    __syncthreads();  // frame f landed; every warp is done with frame f - step
    const long long fn = f + step;
    float u_next = 0.f;
    if (nbuf == 2) {
      if (fn < batch)
        stage_rows(s_m + (cur ^ 1) * m_pad * S, mm + fn * frame_bytes, m, k,
                   m_pad, k_pad, S, vec);
      cp_async_commit();
      if (tid < m && fn < batch) u_next = ul[fn * m + tid];
    }
    const int8_t* s_mf = s_m + cur * m_pad * S;
    const double* s_uf = s_u + cur * m_pad;
    float* outrow = out + f * ntot;
    if constexpr (KCH > 0)
      frame_resident<KCH, TN>(s_t, s_mf, s_uf, outrow, S, nt0, ntot, tiles);
    else
      frame_general<TN>(s_t, s_mf, s_uf, outrow, S, k_pad / 32,
                        m_pad / (8 * TN), nt0, ntot, tiles);
    if (nbuf == 2) {
      if (tid < m_pad) s_u[(cur ^ 1) * m_pad + tid] = u_next;
    } else {
      __syncthreads();  // every warp is done with the one buffer
      if (fn < batch)
        stage_rows(s_m, mm + fn * frame_bytes, m, k, m_pad, k_pad, S, vec);
      cp_async_commit();
      if (tid < m_pad)
        s_u[tid] = (fn < batch && tid < m)
                       ? static_cast<double>(ul[fn * m + tid]) : 0.0;
    }
  }
  cp_async_wait_all();
}

using Kernel = void (*)(const int8_t*, const float*, const int8_t*, float*,
                        int, int, int, int, int, int, int, int, int);

// the instantiation a plan names: (kch, tn) = (2, 8) resident, or (0, 4)
// general
Kernel pick(int kch, int tn) {
  if (kch == 2 && tn == 8) return lterm_kernel<2, 8>;
  if (kch == 0 && tn == 4) return lterm_kernel<0, 4>;
  return nullptr;
}

long long plan_smem(int m_pad, int k_pad, int nt, int nbuf) {
  const long long S = k_pad + 16;
  return S * nt + nbuf * (S * m_pad + 8LL * m_pad);
}

}  // namespace

// The launch of one plan (ops/osd_disc.py lterm_plan); returns a cudaError
// code, cudaErrorInvalidValue for a plan that does not fit the shape.
extern "C" int lterm_launch(const void* m_matrix, const void* u_l,
                            const void* teps, void* out, int batch, int m,
                            int k, int ntot, int kch, int tn, int m_pad,
                            int k_pad, int nt, int n_tiles, int nbuf,
                            int grid_x, int smem_bytes, void* stream) {
  const Kernel kern = pick(kch, tn);
  const bool ok =
      kern != nullptr && batch > 0 && ntot > 0 && m > 0 && k > 0 &&
      k_pad % 32 == 0 && k <= k_pad && m <= m_pad && m_pad % (8 * tn) == 0 &&
      (kch == 0 || (k_pad == 32 * kch && m_pad == 8 * tn)) && nt % 16 == 0 &&
      nt > 0 && static_cast<long long>(nt) * n_tiles >= ntot &&
      static_cast<long long>(nt) * (n_tiles - 1) < ntot &&
      (nbuf == 1 || nbuf == 2) && grid_x >= 1 && grid_x <= batch &&
      m_pad <= kThreads &&
      plan_smem(m_pad, k_pad, nt, nbuf) == smem_bytes &&
      smem_bytes <= kMaxSmem;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  // the limit belongs to the kernel: set it before every launch
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int8_t* mm = static_cast<const int8_t*>(m_matrix);
  const int8_t* tt = static_cast<const int8_t*>(teps);
  const int vec = (k % 16 == 0 && reinterpret_cast<uintptr_t>(mm) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(tt) % 16 == 0) ? 1 : 0;
  const dim3 grid(grid_x, n_tiles);
  kern<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      mm, static_cast<const float*>(u_l), tt, static_cast<float*>(out), batch,
      m, k, ntot, m_pad, k_pad, nt, nbuf, vec);
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of an instantiation at smem_bytes of dynamic shared
// memory: out = {registers, local bytes a thread, threads a block,
// resident blocks per SM, SMs, static shared bytes}; returns a cudaError.
extern "C" int lterm_occupancy(int kch, int tn, int smem_bytes, int device,
                               int* out) {
  const Kernel kern = pick(kch, tn);
  if (kern == nullptr || smem_bytes > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kThreads,
                                                      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = kThreads;
  out[3] = blocks;
  out[4] = sms;
  out[5] = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}
