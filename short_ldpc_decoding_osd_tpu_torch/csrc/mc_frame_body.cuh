// One Monte-Carlo frame, sample to counters, shared by the port's fused
// Monte-Carlo kernels: mc_frames_kernel (mc_fused.cu: K3, K4, K8) and
// dense_mc_kernel (nms_dense.cu: K7).  It is the CUDA form of the per-frame
// work of the TPU kernels nms_edge_pallas._mc_kernel /
// _mc_schedule_kernel (K4 / K3), mc_cascade._phase1_kernel /
// _phase2_kernel (K8) and mc_pallas._mc_kernel (K7), on K8's hash sampler.
//
// Per frame, on the frame's group of lanes (the iteration body of
// nms_edge_body.cuh, whose lane owns checks t + T q and variables t + T i):
// hash words -> message bits, one warp ballot per 32 bits, into the frame's
// message words -> codeword bit of each owned variable v, by the kind of
// G's column v (ops/nms_edge.encode_tables, read from G once): a unit
// column (weight 1, message bit j) copies bit j of the message words, any
// other column p is popcount(msg & parity column p) & 1 over a word-major
// table, so neighbouring lanes read neighbouring words (exact either way)
// -> Box-Muller normal (one per pair, cos only: streams k+1..k+n and
// k+1+n..k+2n) -> x = (1-2c)(mean + sigma z), in registers -> `iters`
// iterations from the lane's messages (zero, or a resumed frame's saved
// ones) -> soft = colsum + w_marg x, hard decision soft < 0 -> bit errors
// (owned variables) and syndrome (owned checks, reading the hard decisions
// through their column offsets) -> warp reductions (and, for a group of
// warps, two shared flags).
//
// What bounds it on the H100: the iterations (nms_edge_body.cuh), then the
// sample: 3 n accurate logf/sqrtf/cosf and 2 n + k hash words a frame.
// Since the body's redesign the sample is no longer small: K4 timed at
// T = 0 in chip_smoke.py took 24% of K4 at T = 12 on CCSDS and on WiMAX.
// The encode popcounts only G's parity columns (WiMAX (1056, 880): 176 of
// 1,056), so a WiMAX frame reads 880 message bits and 176 x 28 table
// words, neighbouring lanes on neighbouring banks.  Beyond the body's
// region a frame keeps in shared memory only what crosses lanes: its
// ceil(k/32) message words and 2 flags (extra_words); the kernels keep
// G's encode tables there too, once a block.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "mc_hash.cuh"
#include "nms_edge_body.cuh"

namespace mc_frame {

// Words a frame needs beyond the body's region: message words and flags.
__host__ __device__ inline int extra_words(int k) { return (k + 31) / 32 + 2; }

// Frame `fid` of `seed` from the messages in L.cv (zero for a frame from
// scratch) through `iters` iterations.  `words` is the byte offset of the
// frame's extra words.  `table`: G's encode tables (ops/nms_edge.encode_
// tables, in shared or global memory), the n column kinds (j >= 0 for a
// unit column that copies message bit j, ~p for parity column p), then
// the (ceil(k/32), P) parity words: bit b of word w of parity column p,
// at table[n + w P + p], is its G[32w + b].
// Every lane of the group must call it; it returns, in every lane, {bit
// errors, unconverged}; L.cv then holds the messages after `iters`
// iterations.
template <class Bk, bool kClampBig>
__device__ __forceinline__ int2 run(nms_edge::Lane<Bk>& L, unsigned words,
                                    const int* table, int P, int fid, int n,
                                    int k, int iters, unsigned seed,
                                    float sigma, float mean, float w_vc,
                                    float w_chk, float w_marg) {
  using nms_edge::sh;
  const int kw = (k + 31) / 32;
  const int t = L.t, T = L.threads;
  const unsigned flags = words + 4u * kw;  // bit errors, unconverged
  const unsigned base =
      mc_hash::mix32(static_cast<unsigned>(fid) * mc_hash::kGold1 + seed);

  // message bit j is bit 0 of stream j + 1; a warp's ballot packs 32
  // (T is a multiple of 32, so the loop is warp-uniform)
  for (int j0 = 0; j0 < kw * 32; j0 += T) {
    const int j = j0 + t;
    const bool bit = j < k && (mc_hash::stream_word(base, j + 1) & 1u);
    const unsigned word = __ballot_sync(0xffffffffu, bit);
    if ((t & 31) == 0 && j < kw * 32)
      sh(words + 4u * (j >> 5)) = __uint_as_float(word);
  }
  nms_edge::frame_sync(L.bar, T);
  if (t < 2) sh(flags + 4u * t) = 0.f;  // read back after later barriers

  const unsigned* parity = reinterpret_cast<const unsigned*>(table + n);
  unsigned codeword = 0;  // bit i: the codeword bit of owned variable i
#pragma unroll
  for (int i = 0; i < Bk::VPL; ++i) {
    const int v = t + T * i;
    if (v >= n) continue;
    const int j = table[v];
    unsigned c;
    if (j >= 0) {  // a unit column: message bit j
      c = __float_as_uint(sh(words + 4u * (j >> 5))) >> (j & 31);
    } else {
      c = 0;
      for (int w = 0; w < kw; ++w)
        c ^= __popc(__float_as_uint(sh(words + 4u * w)) & parity[w * P + ~j]);
    }
    codeword |= (c & 1u) << i;
  }

  float x[Bk::VPL];
  // branch-free over the owned variables, so that their independent
  // logf/cosf chains interleave; a padding variable (v >= n) computes a
  // value it then drops
#pragma unroll
  for (int i = 0; i < Bk::VPL; ++i) {
    const int v = t + T * i;
    const float c = static_cast<float>((codeword >> i) & 1u);
    const float u1 = mc_hash::uniform01(mc_hash::stream_word(base, k + 1 + v));
    const float u2 =
        mc_hash::uniform01(mc_hash::stream_word(base, k + 1 + n + v));
    const float z = sqrtf(-2.0f * logf(u1)) * cosf(6.283185307179586f * u2);
    const float received = mean + sigma * z;
    x[i] = v < n ? (1.0f - 2.0f * c) * received : 0.f;
  }

  int errs = 0;
  nms_edge::iterate<Bk, kClampBig>(
      L, x, iters, w_vc, w_chk, [&](int it, int i, float s) {
        if (it == iters) {
          const float soft = s + w_marg * x[i];
          L.total(i) = soft;  // the syndrome below reads it by column
          errs += static_cast<int>(soft < 0.f) ^ ((codeword >> i) & 1);
        }
      });
  nms_edge::frame_sync(L.bar, T);

  int odd = 0;
#pragma unroll
  for (int q = 0; q < Bk::CPL; ++q) {
    int par = 0;
#pragma unroll
    for (int j = 0; j < Bk::DC; ++j) par ^= sh(L.col[q][j]) < 0.f;  // +inf: 0
    odd |= nms_edge::check_parity(L, par);
  }
  errs = __reduce_add_sync(0xffffffffu, errs);
  odd = __any_sync(0xffffffffu, odd);
  if (T == 32) return make_int2(errs, odd);
  int* f = reinterpret_cast<int*>(&sh(flags));
  if ((t & 31) == 0) {
    if (errs) atomicAdd(&f[0], errs);
    if (odd) atomicOr(&f[1], 1);
  }
  nms_edge::frame_sync(L.bar, T);
  return make_int2(f[0], f[1]);
}

}  // namespace mc_frame
