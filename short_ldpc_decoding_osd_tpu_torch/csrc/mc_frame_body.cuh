// One Monte-Carlo frame, sample to counters, shared by the port's fused
// Monte-Carlo kernels: mc_frames_kernel (mc_fused.cu: K3, K4, K8) and
// dense_mc_kernel (nms_dense.cu: K7).  Per frame: hash words -> message bits
// (one warp ballot per 32 bits) -> codeword bit v = popcount(msg & column v
// of G) & 1 (exact) -> Box-Muller normal (one per pair, cos only: streams
// k+1..k+n and k+1+n..k+2n) -> llr = (1-2c)(mean + sigma z) -> `iters`
// iterations of the edge body (nms_edge_body.cuh) -> hard decision
// soft < 0 -> bit errors and syndrome.
//
// A frame's region of shared memory (frame_words 4-byte words): cv (dc*m,
// slab-major), total (n), x (n), bits (n: bit 0 codeword, bit 1 hard
// decision), msg (ceil(k/32)), flags (2: bit errors, unconverged).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "mc_hash.cuh"
#include "nms_edge_body.cuh"

namespace mc_frame {

__host__ __device__ inline size_t frame_words(int n, int m, int dc, int k) {
  return static_cast<size_t>(dc) * m + 3 * static_cast<size_t>(n) +
         (k + 31) / 32 + 2;
}

// Runs frame `fid` of `seed` (fid < 0: an idle slot, channel input 0) in
// the region at `cv` with the threads lt = 0..threads_per_frame-1 of its
// group (`in_block` false for the block's threads outside every group).
// gcols: (n, ceil(k/32)), bit b of word w of column v = G[32w + b, v].
// Every thread of the block must call it (it synchronises); it returns the
// frame's flags, readable by any thread of the block: [bit errors,
// unconverged].  A caller reusing the region synchronises first.
template <bool kClampBig>
__device__ __forceinline__ const int* run(
    float* cv, const int* s_edge_col, const int* s_var_edges,
    const unsigned* gcols, int fid, bool in_block, int lt,
    int threads_per_frame, int n, int m, int dc, int dv, int k, int iters,
    unsigned seed, float sigma, float mean, float w_vc, float w_chk,
    float w_marg) {
  const int num_edges = dc * m;
  const int kw = (k + 31) / 32;
  float* total = cv + num_edges;
  float* x = total + n;                            // channel llr
  int* bits = reinterpret_cast<int*>(x + n);       // bit 0 codeword, bit 1 hard
  unsigned* msg = reinterpret_cast<unsigned*>(bits + n);
  int* flags = reinterpret_cast<int*>(msg + kw);   // bit errors, unconverged
  const bool active = fid >= 0;
  const unsigned base =
      mc_hash::mix32(static_cast<unsigned>(fid) * mc_hash::kGold1 + seed);

  if (in_block) {
    for (int e = lt; e < num_edges; e += threads_per_frame) cv[e] = 0.f;
    if (lt < 2) flags[lt] = 0;
    // message bit j is bit 0 of stream j + 1; a warp's ballot packs 32
    // (threads_per_frame is a multiple of 32, so the loop is warp-uniform)
    for (int j0 = 0; j0 < kw * 32; j0 += threads_per_frame) {
      const int j = j0 + lt;
      const bool bit = j < k && (mc_hash::stream_word(base, j + 1) & 1u);
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
      const float u1 =
          mc_hash::uniform01(mc_hash::stream_word(base, k + 1 + v));
      const float u2 =
          mc_hash::uniform01(mc_hash::stream_word(base, k + 1 + n + v));
      const float z = sqrtf(-2.0f * logf(u1)) * cosf(6.283185307179586f * u2);
      const float received = mean + sigma * z;
      x[v] = active ? (1.0f - 2.0f * static_cast<float>(c)) * received : 0.f;
      bits[v] = c;
    }
  }
  __syncthreads();

  nms_edge::iterate<kClampBig>(
      cv, total, x, s_edge_col, s_var_edges, n, m, dc, dv, iters, lt,
      threads_per_frame, in_block, w_vc, w_chk, [&](int it, int v, float s) {
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
  return flags;
}

}  // namespace mc_frame
