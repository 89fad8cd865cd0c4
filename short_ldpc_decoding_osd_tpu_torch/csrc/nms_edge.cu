// Edge-layout normalized min-sum decode (kernels K1 and K2 of the port).
//
// Replaces the TPU kernels of short_ldpc_decoding_osd_tpu/ops/nms_edge_pallas.py:
//   K1  _decode_kernel       (entry decode_final_edge): the final soft output
//                            colsum + w_marg * llr, shape (B, n);
//   K2  _decode_traj_kernel  (entry decode_traj_edge): the trajectory
//                            (T+1, B, n), slot 0 = llr, slot t = colsum_t + w_marg * llr.
// One template serves both (TRAJ).  Semantics held exactly (ops/nms.py):
//   * min/submin by a two-register tournament; a duplicated minimum lands in
//     min2 (nms_edge_pallas.py:264-275);
//   * the sign product over the row's edges: one zero edge zeroes every
//     outgoing message of the row (nms.py:100-113);
//   * dummy edges of irregular rows (edge_col < 0) are skipped, so they never
//     win the minimum or flip a sign;
//   * (w_vc, w_chk, w_marg) come from nms._weights, so NMS-1/2/3 and ENMS run
//     here.
// NMS-r (the neural check update) has two entries of its own over the same
// frame loop, nmsr_edge_kernel (entry nms_edge_decode_nmsr): the iteration
// body's phase A with iterate_neural's phase B, its network's weights a
// by-value argument (nms_edge_body.cuh).
//
// What bounds it on H100: for a 12-iteration decode the f32 edge arithmetic
// (~8 f32 instructions per edge and iteration) outweighs the bytes (llr in, soft
// values out), so it is bound by operations for K1 and by the (T+1)-slot
// write for K2.  The TPU kernel's one-hot incidence matmuls, bf16 hi/lo
// split and lane packing are MXU artifacts and are not carried over.
//
// Design: the iteration body of nms_edge_body.cuh (a frame on one warp, or
// a group of warps for a large code; each check's messages and every table
// in registers; the column totals and outgoing messages in shared memory;
// frame-scoped barriers), shared with the fused Monte-Carlo kernels of
// mc_fused.cu and the dense rung of nms_dense.cu.  The blocks are
// persistent (one wave of as many as fit the SMs), so each group reads the
// tables into registers once and then walks frames; only llr and the
// outputs touch device memory.
// Built with -fmad=false, so each step rounds exactly like the plain PyTorch
// twin in ops/nms_edge.py.

#include <cuda_runtime.h>

#include "nms_edge_body.cuh"

namespace {

template <class Bk, bool TRAJ>
__global__ void __launch_bounds__(nms_edge::kMaxThreads, 1)
    nms_edge_kernel(const float* __restrict__ llr,
                                float* __restrict__ out,
                                const int* __restrict__ edge_col,
                                const int* __restrict__ var_edges, int batch,
                                int n, int m, int dc, int dv, int iters,
                                int warps, int frames, float w_vc, float w_chk,
                                float w_marg, const int* __restrict__ split) {
  const int T = 32 * warps;
  const int g = threadIdx.x / T;
  const int t = threadIdx.x - g * T;
  const size_t words = nms_edge::region_words<Bk>(T, 0);
  nms_edge::Lane<Bk> L;
  L.setup(4u * static_cast<unsigned>(g * words), edge_col, var_edges, split,
          m, n, dc, dv, t, T, 1 + g);
  for (long long frame = static_cast<long long>(blockIdx.x) * frames + g;
       frame < batch; frame += static_cast<long long>(gridDim.x) * frames) {
    float x[Bk::VPL];
#pragma unroll
    for (int i = 0; i < Bk::VPL; ++i) {
      const int v = t + T * i;
      x[i] = v < n ? llr[frame * n + v] : 0.f;
      if (TRAJ && v < n) out[frame * n + v] = x[i];  // slot 0: channel input
    }
    L.reset();
    nms_edge::iterate<Bk, false>(
        L, x, iters, w_vc, w_chk, [&](int it, int i, float s) {
          const int v = t + T * i;
          if (v < n && it > 0 && (TRAJ || it == iters)) {
            const size_t slot = TRAJ ? static_cast<size_t>(it) * batch : 0;
            out[(slot + frame) * n + v] = s + w_marg * x[i];
          }
        });
  }
}

// NMS-r's decode (entries nms_edge_decode_nmsr): the frame loop of
// nms_edge_kernel over iterate_neural; the soft outputs add w.w_marg * llr.
template <class Bk, bool TRAJ>
__global__ void __launch_bounds__(nms_edge::kMaxThreads, 1)
    nmsr_edge_kernel(const float* __restrict__ llr, float* __restrict__ out,
                     const int* __restrict__ edge_col,
                     const int* __restrict__ var_edges, int batch, int n,
                     int m, int dc, int dv, int iters, int warps, int frames,
                     const nms_edge::Neural<Bk> w) {
  const int T = 32 * warps;
  const int g = threadIdx.x / T;
  const int t = threadIdx.x - g * T;
  const size_t words = nms_edge::region_words<Bk>(T, 0);
  nms_edge::Lane<Bk> L;
  L.setup(4u * static_cast<unsigned>(g * words), edge_col, var_edges, nullptr,
          m, n, dc, dv, t, T, 1 + g);
  for (long long frame = static_cast<long long>(blockIdx.x) * frames + g;
       frame < batch; frame += static_cast<long long>(gridDim.x) * frames) {
    float x[Bk::VPL];
#pragma unroll
    for (int i = 0; i < Bk::VPL; ++i) {
      const int v = t + T * i;
      x[i] = v < n ? llr[frame * n + v] : 0.f;
      if (TRAJ && v < n) out[frame * n + v] = x[i];  // slot 0: channel input
    }
    L.reset();
    nms_edge::iterate_neural<Bk>(L, x, iters, w, [&](int it, int i, float s) {
      const int v = t + T * i;
      if (v < n && it > 0 && (TRAJ || it == iters)) {
        const size_t slot = TRAJ ? static_cast<size_t>(it) * batch : 0;
        out[(slot + frame) * n + v] = s + w.w_marg * x[i];
      }
    });
  }
}

// Launches `kernel` over batch frames as one persistent wave: as many
// blocks of `frames` frames of 32 * warps threads as fit the SMs.
template <class Bk, typename Kernel, typename... Args>
int start(Kernel kernel, int batch, int warps, int frames, cudaStream_t s,
          Args... args) {
  const int threads = 32 * warps * frames;
  const size_t smem = 4 * frames * nms_edge::region_words<Bk>(32 * warps, 0);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  // the attribute belongs to the kernel: a launch of another shape may have
  // set it lower
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidValue);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long need = (static_cast<long long>(batch) + frames - 1) / frames;
  const int grid = static_cast<int>(need < per_sm * sms ? need : per_sm * sms);
  kernel<<<grid, threads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <class Bk, bool TRAJ>
int launch(const float* llr, float* out, const int* edge_col,
           const int* var_edges, const int* split, int batch, int n, int m,
           int dc, int dv, int iters, int warps, int frames, float w_vc,
           float w_chk, float w_marg, cudaStream_t s) {
  return start<Bk>(nms_edge_kernel<Bk, TRAJ>, batch, warps, frames, s, llr,
                   out, edge_col, var_edges, batch, n, m, dc, dv, iters, warps,
                   frames, w_vc, w_chk, w_marg, split);
}

}  // namespace

// llr: f32 (batch, n); out: f32 (batch, n), or (iters + 1, batch, n) with
// traj; edge_col int32 (dc, m), var_edges int32 (dv, n); split: int32
// (512 + m,), the split bucket's lane map (ops/nms_edge.py split_map),
// NULL at another bucket; bucket, warps, frames, lanes: the launch plan
// (ops/nms_edge.py launch_plan) and the lanes its checks take.
extern "C" int nms_edge_decode(const void* llr, void* out, const void* edge_col,
                               const void* var_edges, const void* split,
                               int batch, int n, int m, int dc, int dv,
                               int iters, float w_vc, float w_chk,
                               float w_marg, int traj, int bucket, int warps,
                               int frames, int lanes, void* stream) {
  const bool ok = nms_edge::with_bucket(bucket, [&](auto bk) {
                    return static_cast<int>(
                        nms_edge::plan_holds<decltype(bk)>(warps, frames, m, n,
                                                           dc, dv, lanes));
                  }) == 1;
  if (!ok || !nms_edge::split_given(bucket, split))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const float* l = static_cast<const float*>(llr);
  float* o = static_cast<float*>(out);
  const int* ec = static_cast<const int*>(edge_col);
  const int* ve = static_cast<const int*>(var_edges);
  const int* sp = static_cast<const int*>(split);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return nms_edge::with_bucket(bucket, [&](auto bk) {
    using B = decltype(bk);
    return traj ? launch<B, true>(l, o, ec, ve, sp, batch, n, m, dc, dv,
                                  iters, warps, frames, w_vc, w_chk, w_marg, s)
                : launch<B, false>(l, o, ec, ve, sp, batch, n, m, dc, dv,
                                   iters, warps, frames, w_vc, w_chk, w_marg,
                                   s);
  });
}

// NMS-r (the neural check update; bucket 0, a regular check degree dc of 2
// to 8): as nms_edge_decode, with `weights` the host f32 values w_vc,
// w_marg, w2 (4), then w1 ((dc - 1) x 4, row-major), passed to the kernel
// by value.
extern "C" int nms_edge_decode_nmsr(const void* llr, void* out,
                                    const void* edge_col,
                                    const void* var_edges, int batch, int n,
                                    int m, int dc, int dv, int iters,
                                    const void* weights, int traj, int bucket,
                                    int warps, int frames, void* stream) {
  using B = nms_edge::Bucket0;
  if (bucket != 0 || dc < 2 ||
      !nms_edge::plan_holds<B>(warps, frames, m, n, dc, dv, m))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const float* wh = static_cast<const float*>(weights);
  nms_edge::Neural<B> w{};  // value-initialised: w1's rows past dc - 2 are +0
  w.w_vc = wh[0];
  w.w_marg = wh[1];
  for (int j = 0; j < nms_edge::kHidden; ++j) w.w2[j] = wh[2 + j];
  for (int i = 0; i < dc - 1; ++i)
    for (int j = 0; j < nms_edge::kHidden; ++j)
      w.w1[i][j] = wh[2 + nms_edge::kHidden + nms_edge::kHidden * i + j];
  const float* l = static_cast<const float*>(llr);
  float* o = static_cast<float*>(out);
  const int* ec = static_cast<const int*>(edge_col);
  const int* ve = static_cast<const int*>(var_edges);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return traj ? start<B>(nmsr_edge_kernel<B, true>, batch, warps, frames, s,
                         l, o, ec, ve, batch, n, m, dc, dv, iters, warps,
                         frames, w)
              : start<B>(nmsr_edge_kernel<B, false>, batch, warps, frames, s,
                         l, o, ec, ve, batch, n, m, dc, dv, iters, warps,
                         frames, w);
}
