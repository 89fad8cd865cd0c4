// The edge-layout normalized min-sum iteration body shared by the port's
// CUDA kernels: K1/K2 (nms_edge.cu), the fused Monte-Carlo kernels
// K3/K4/K8 (mc_fused.cu) and the dense-rung kernels K6/K7 (nms_dense.cu).
// It is the CUDA form of the TPU's nms_edge_pallas._decode_edge; see
// nms_edge.cu for the semantics it holds (duplicate-at-minimum tournament,
// zero-aware sign product, dummy edges skipped).  With kClampBig (K6/K7) it
// also holds the dense-rung TPU kernel's clamp (nms_pallas.py): magnitudes
// are clamped to kBig and min/submin start at kBig, so a row of degree 1
// sends w_chk * kBig where the other kernels send +inf.
//
// A block holds `frames_per_block` frames of `threads_per_frame` threads
// each (a multiple of 32, so a warp never straddles two frames).  Each frame
// keeps in shared memory its check-to-variable messages cv (dc*m floats,
// slab-major e = j*m + c), its column totals (n) and its channel llr x (n).
// Per iteration:
//   phase A: one thread per variable sums its edges' cv in ascending check
//            order (the order of the dense row sum), hands the column sum to
//            `emit(it, v, colsum)` and forms total = colsum + w_vc * x;
//   phase B: one thread per check runs the min/submin tournament over its
//            real edges and writes the outgoing cv.
// Phase A runs iters + 1 times; the last one (it == iters) only emits, and
// the body returns without a closing __syncthreads: a caller that reads
// what `emit` wrote from another thread synchronises first.  Every thread of
// the block must call the body (it contains __syncthreads).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace nms_edge {

constexpr float kBig = 3.4e38f;

template <bool kClampBig = false, typename Emit>
__device__ __forceinline__ void iterate(float* cv, float* total, const float* x,
                                        const int* s_edge_col,
                                        const int* s_var_edges, int n, int m,
                                        int dc, int dv, int iters, int lt,
                                        int threads_per_frame, bool in_block,
                                        float w_vc, float w_chk, Emit emit) {
  for (int it = 0; it <= iters; ++it) {
    // phase A: column sums in ascending check order -> totals (and outputs)
    if (in_block) {
      for (int v = lt; v < n; v += threads_per_frame) {
        float s = 0.f;
        for (int d = 0; d < dv; ++d) {
          const int e = s_var_edges[d * n + v];
          if (e < 0) break;
          s += cv[e];
        }
        emit(it, v, s);
        total[v] = s + w_vc * x[v];
      }
    }
    if (it == iters) break;
    __syncthreads();
    // phase B: per-check min/submin tournament and outgoing messages
    if (in_block) {
      for (int c = lt; c < m; c += threads_per_frame) {
        float min1 = kClampBig ? kBig : INFINITY, min2 = min1, sign_prod = 1.f;
        for (int j = 0; j < dc; ++j) {
          const int e = j * m + c;
          const int col = s_edge_col[e];
          if (col < 0) continue;
          const float vc = total[col] - cv[e];
          const float mag = kClampBig ? fminf(fabsf(vc), kBig) : fabsf(vc);
          const float sg = vc > 0.f ? 1.f : (vc < 0.f ? -1.f : 0.f);
          min2 = fminf(min2, fmaxf(min1, mag));
          min1 = fminf(min1, mag);
          sign_prod = sign_prod * sg;
        }
        const float wmin1 = w_chk * min1;
        const float wmin2 = w_chk * min2;
        for (int j = 0; j < dc; ++j) {
          const int e = j * m + c;
          const int col = s_edge_col[e];
          if (col < 0) continue;
          const float vc = total[col] - cv[e];
          const float mag = kClampBig ? fminf(fabsf(vc), kBig) : fabsf(vc);
          const float sg = vc > 0.f ? 1.f : (vc < 0.f ? -1.f : 0.f);
          cv[e] = (mag > min1 ? wmin1 : wmin2) * (sign_prod * sg);
        }
      }
    }
    __syncthreads();
  }
}

// Launch shape shared by the kernels: one thread per variable or check
// (the larger count, rounded up to a warp, at most 1024), as many frames as
// fit 512 threads and 48 KB of shared memory (at least one frame).
// `table_words` and `frame_words` are the 4-byte words of shared memory the
// kernel needs once per block and once per frame.  Returns false when one
// frame does not fit the 227 KB a block can use.
inline bool launch_shape(int n, int m, size_t table_words, size_t frame_words,
                         int* threads_per_frame, int* frames_per_block,
                         size_t* smem) {
  int tpf = ((n > m ? n : m) + 31) / 32 * 32;
  if (tpf > 1024) tpf = 1024;
  int fpb = 512 / tpf;
  if (fpb < 1) fpb = 1;
  const size_t table = table_words * 4;
  const size_t per_frame = frame_words * 4;
  while (fpb > 1 && table + fpb * per_frame > 48 * 1024) --fpb;
  *threads_per_frame = tpf;
  *frames_per_block = fpb;
  *smem = table + fpb * per_frame;
  return *smem <= 227 * 1024;
}

}  // namespace nms_edge
