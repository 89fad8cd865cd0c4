// The counter-based murmur3 channel sampler shared by the port's fused
// Monte-Carlo kernels (mc_fused.cu: K3, K4, K8; nms_dense.cu: K7).  It is the
// CUDA form of mc_cascade.py's _mix / _stream_bits / _bits_to_uniform, and
// ops/mc_hash.py is its plain PyTorch twin.  Per frame the base word is
// mix32(fid * kGold1 + seed); message bit j is bit 0 of stream j + 1, and the
// normal of column v is one Box-Muller value (cos only) from the uniforms of
// streams k + 1 + v and k + 1 + n + v.

#pragma once

#include <cuda_runtime.h>

namespace mc_hash {

constexpr unsigned kGold1 = 0x9E3779B9u;  // golden-ratio increment
constexpr unsigned kGold2 = 0xB4014E05u;  // odd stream constant (int32 -1274982907)

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

}  // namespace mc_hash
