// Fused TEP-discrepancy parity term (kernel K5 of the port).
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
// What bounds it on H100: B*m*k*N binary multiply-adds (206 G, i.e. 412 G
// operations, at the main path's B = 32768, N = 1536, m = k = 64) -- about
// 0.2 ms even at the int8 tensor-core rate -- against ~0.34 GB of compulsory
// traffic (M in, the (B, N) result out), so it is bound by operations.
//
// Design: the products are 0/1, so a row's parity is the parity of a
// popcount.  Each M row and each TEP is packed into 32-bit words
// (ceil(k/32) words, W <= 8): TEPs by their own thread, M rows with one
// warp ballot per word as the frame tile is loaded.  A block owns 128 TEPs
// (one per thread, its words in registers) and a tile of frames whose packed
// M and u_l sit in shared memory, read as warp-wide broadcasts.  The parity
// of (Mrow & T) is __popc(xor of word ANDs) & 1, and u_l[b, m] is added in
// f32 over ascending m.  This is exact in the parity and differs from the
// plain PyTorch twin only in the order of the f32 sum.  Tensor-core
// (mma / wgmma int8) variants are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTepsPerBlock = 128;

template <int W>
__global__ void lterm_kernel(const int8_t* __restrict__ m_matrix,
                             const float* __restrict__ u_l,
                             const int8_t* __restrict__ teps,
                             float* __restrict__ out, int batch, int m,
                             int k, int ntot, int frames_per_block) {
  extern __shared__ unsigned int smem[];
  unsigned int* s_m = smem;                                       // (tile*m, W)
  float* s_ul = reinterpret_cast<float*>(smem + frames_per_block * m * W);

  const int tid = threadIdx.x;
  const int t_idx = blockIdx.y * kTepsPerBlock + tid;
  const long long b0 = static_cast<long long>(blockIdx.x) * frames_per_block;

  unsigned int tep[W];
#pragma unroll
  for (int w = 0; w < W; ++w) tep[w] = 0u;
  if (t_idx < ntot) {
    const int8_t* row = teps + static_cast<size_t>(t_idx) * k;
    for (int j = 0; j < k; ++j)
      if (row[j]) tep[j >> 5] |= 1u << (j & 31);
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int rows = frames_per_block * m;
  for (int r = warp; r < rows; r += nwarps) {
    const long long b = b0 + r / m;
    const int8_t* row = m_matrix + (b * m + r % m) * static_cast<long long>(k);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int col = w * 32 + lane;
      const int v = (b < batch && col < k) ? row[col] : 0;
      const unsigned int word = __ballot_sync(0xffffffffu, v != 0);
      if (lane == 0) s_m[r * W + w] = word;
    }
  }
  for (int i = tid; i < rows; i += blockDim.x) {
    const long long b = b0 + i / m;
    s_ul[i] = b < batch ? u_l[b * m + i % m] : 0.f;
  }
  __syncthreads();
  if (t_idx >= ntot) return;

  for (int f = 0; f < frames_per_block; ++f) {
    const long long b = b0 + f;
    if (b >= batch) break;
    const unsigned int* mrow = s_m + f * m * W;
    const float* u = s_ul + f * m;
    float acc = 0.f;
    for (int r = 0; r < m; ++r) {
      unsigned int x = 0u;
#pragma unroll
      for (int w = 0; w < W; ++w) x ^= mrow[r * W + w] & tep[w];
      acc += (__popc(x) & 1) ? u[r] : 0.f;
    }
    out[b * ntot + t_idx] = acc;
  }
}

template <int W>
int launch(const int8_t* mm, const float* ul, const int8_t* tt, float* out,
           int batch, int m, int k, int ntot, cudaStream_t stream) {
  int frames = 32;
  while (frames > 1 &&
         static_cast<size_t>(frames) * m * (W + 1) * 4 > 48 * 1024)
    frames /= 2;
  const size_t smem = static_cast<size_t>(frames) * m * (W + 1) * 4;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((batch + frames - 1) / frames,
                  (ntot + kTepsPerBlock - 1) / kTepsPerBlock);
  lterm_kernel<W><<<grid, kTepsPerBlock, smem, stream>>>(
      mm, ul, tt, out, batch, m, k, ntot, frames);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lterm_launch(const void* m_matrix, const void* u_l,
                            const void* teps, void* out, int batch, int m,
                            int k, int ntot, void* stream) {
  if (batch == 0 || ntot == 0) return 0;
  const int8_t* mm = static_cast<const int8_t*>(m_matrix);
  const float* ul = static_cast<const float*>(u_l);
  const int8_t* tt = static_cast<const int8_t*>(teps);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((k + 31) / 32) {
    case 1: return launch<1>(mm, ul, tt, o, batch, m, k, ntot, s);
    case 2: return launch<2>(mm, ul, tt, o, batch, m, k, ntot, s);
    case 3: return launch<3>(mm, ul, tt, o, batch, m, k, ntot, s);
    case 4: return launch<4>(mm, ul, tt, o, batch, m, k, ntot, s);
    case 5: return launch<5>(mm, ul, tt, o, batch, m, k, ntot, s);
    case 6: return launch<6>(mm, ul, tt, o, batch, m, k, ntot, s);
    case 7: return launch<7>(mm, ul, tt, o, batch, m, k, ntot, s);
    case 8: return launch<8>(mm, ul, tt, o, batch, m, k, ntot, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
