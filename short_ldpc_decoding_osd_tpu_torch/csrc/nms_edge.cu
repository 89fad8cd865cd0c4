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
//     here; NMS-r (neural check update) is refused by the Python wrapper.
//
// What bounds it on H100: for a 12-iteration decode the f32 edge arithmetic
// (~8 f32 instructions per edge and iteration) outweighs the bytes (llr in, soft
// values out), so it is bound by operations for K1 and by the (T+1)-slot
// write for K2.  The TPU kernel's one-hot incidence matmuls, bf16 hi/lo
// split and lane packing are MXU artifacts and are not carried over.
//
// Design: a block holds a few frames; each frame keeps its check-to-variable
// messages cv (m*dc f32, 2 KB for CCSDS) and its column totals (n f32) in
// shared memory for all T iterations, so nothing but llr and the outputs
// touches device memory.  The iteration body (phase A column sums, phase B
// tournament) lives in nms_edge_body.cuh, shared with the fused Monte-Carlo
// kernels of mc_fused.cu.
// Built with -fmad=false, so each step rounds exactly like the plain PyTorch
// twin in ops/nms_edge.py.

#include <cuda_runtime.h>

#include "nms_edge_body.cuh"

namespace {

template <bool TRAJ>
__global__ void nms_edge_kernel(const float* __restrict__ llr,
                                float* __restrict__ out,
                                const int* __restrict__ edge_col,
                                const int* __restrict__ var_edges,
                                int batch, int n, int m, int dc, int dv,
                                int iters, int frames_per_block,
                                int threads_per_frame,
                                float w_vc, float w_chk, float w_marg) {
  extern __shared__ float smem[];
  const int num_edges = dc * m;
  int* s_edge_col = reinterpret_cast<int*>(smem);   // (dc, m)
  int* s_var_edges = s_edge_col + num_edges;        // (dv, n)
  float* s_frames = reinterpret_cast<float*>(s_var_edges + dv * n);

  for (int i = threadIdx.x; i < num_edges; i += blockDim.x)
    s_edge_col[i] = edge_col[i];
  for (int i = threadIdx.x; i < dv * n; i += blockDim.x)
    s_var_edges[i] = var_edges[i];

  const int f = threadIdx.x / threads_per_frame;
  const int lt = threadIdx.x - f * threads_per_frame;
  const bool in_block = f < frames_per_block;
  const long long frame = static_cast<long long>(blockIdx.x) * frames_per_block + f;
  const bool active = in_block && frame < batch;
  float* cv = s_frames + static_cast<size_t>(in_block ? f : 0) * (num_edges + 2 * n);
  float* total = cv + num_edges;
  float* x = total + n;  // this frame's channel llr

  if (in_block) {
    for (int e = lt; e < num_edges; e += threads_per_frame) cv[e] = 0.f;
    for (int v = lt; v < n; v += threads_per_frame) {
      const float xv = active ? llr[frame * n + v] : 0.f;
      x[v] = xv;
      if (TRAJ && active) out[frame * n + v] = xv;  // slot 0: channel input
    }
  }
  __syncthreads();

  nms_edge::iterate(
      cv, total, x, s_edge_col, s_var_edges, n, m, dc, dv, iters, lt,
      threads_per_frame, in_block, w_vc, w_chk,
      [&](int it, int v, float s) {
        if (active && it > 0 && (TRAJ || it == iters)) {
          const size_t slot = TRAJ ? static_cast<size_t>(it) * batch : 0;
          out[(slot + frame) * n + v] = s + w_marg * x[v];
        }
      });
}

}  // namespace

extern "C" int nms_edge_decode(const void* llr, void* out, const void* edge_col,
                               const void* var_edges, int batch, int n, int m,
                               int dc, int dv, int iters, float w_vc,
                               float w_chk, float w_marg, int traj,
                               void* stream) {
  int threads_per_frame, frames_per_block;
  size_t smem;
  if (!nms_edge::launch_shape(n, m, static_cast<size_t>(dc) * m + dv * n,
                              static_cast<size_t>(dc) * m + 2 * n,
                              &threads_per_frame, &frames_per_block, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = frames_per_block * threads_per_frame;
  const int blocks = (batch + frames_per_block - 1) / frames_per_block;
  if (blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(llr);
  float* o = static_cast<float*>(out);
  const int* ec = static_cast<const int*>(edge_col);
  const int* ve = static_cast<const int*>(var_edges);
  if (traj) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(nms_edge_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    nms_edge_kernel<true><<<blocks, threads, smem, s>>>(
        l, o, ec, ve, batch, n, m, dc, dv, iters, frames_per_block,
        threads_per_frame, w_vc, w_chk, w_marg);
  } else {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(nms_edge_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    nms_edge_kernel<false><<<blocks, threads, smem, s>>>(
        l, o, ec, ve, batch, n, m, dc, dv, iters, frames_per_block,
        threads_per_frame, w_vc, w_chk, w_marg);
  }
  return static_cast<int>(cudaGetLastError());
}
