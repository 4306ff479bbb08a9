// Pieces shared by every MLP kernel of the port: the fixed-order chunk
// sums (reduce_chunks, the second pass of every weight gradient and column
// sum), the final linear layer (alone, or fused with the masked-MSE loss
// gradient and the SSE sums of a train step), and the launch helpers.
//
// A sum over rows is written as per-chunk partials and summed in chunk
// order by reduce_chunks: no float atomics, so a result is identical run
// to run.  The final layer uses one warp per row; its lanes stride over the
// inputs and meet in a fixed butterfly, so its sums do not depend on
// scheduling either.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace gemm_common {

constexpr int kThreads = 256;
constexpr int kChunkRows = 2048;  // rows summed by one column-sum block
constexpr int kFinalRowsPerBlock = 64;
constexpr int kMaxOut = 8;

#define GEMM_CHECK(expr)                  \
  do {                                    \
    cudaError_t err_ = (expr);            \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

inline int ceil_div(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

// out[e] = sum over c = 0 .. C-1, in that order, of part[c * E + e]; with a
// column scale, entries e of the first `scaled_rows` rows of an (E / NB) x
// NB block are then multiplied by colscale[e % NB].
__global__ void reduce_chunks_kernel(const float* __restrict__ part, int C,
                                     int E, float* __restrict__ out,
                                     const float* __restrict__ colscale,
                                     int NB, int scaled_rows) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
  for (int c = 0; c < C; ++c) s += part[(size_t)c * E + e];
  if (colscale != nullptr && e / NB < scaled_rows) s *= colscale[e % NB];
  out[e] = s;
}

// Sum C partials of E floats each, in chunk order, into out.
inline cudaError_t reduce_chunks(const float* part, int C, int E, float* out,
                                 cudaStream_t st,
                                 const float* colscale = nullptr, int NB = 1,
                                 int scaled_rows = 0) {
  reduce_chunks_kernel<<<ceil_div(E, kThreads), kThreads, 0, st>>>(
      part, C, E, out, colscale, NB, scaled_rows);
  return cudaGetLastError();
}

// Final linear layer: pred = a @ fW + fb, a (n x K), fW (K x o), o <= kMaxOut.
__global__ void __launch_bounds__(kThreads) final_forward_kernel(
    const float* __restrict__ a, const float* __restrict__ fW,
    const float* __restrict__ fb, float* __restrict__ pred, int n, int K,
    int o) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kWarps = kThreads / 32;
  for (int it = 0; it < kFinalRowsPerBlock / kWarps; ++it) {
    const int r = blockIdx.x * kFinalRowsPerBlock + it * kWarps + warp;
    if (r >= n) break;
    float acc[kMaxOut];
#pragma unroll
    for (int c = 0; c < kMaxOut; ++c) acc[c] = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float av = a[(size_t)r * K + k];
#pragma unroll
      for (int c = 0; c < kMaxOut; ++c)
        if (c < o) acc[c] = fmaf(av, fW[(size_t)k * o + c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < kMaxOut; ++c) {
      if (c >= o) break;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kMaxOut; ++c) {
        if (c >= o) break;
        pred[(size_t)r * o + c] = acc[c] + fb[c];
      }
    }
  }
}

// Final layer + loss gradient + masked SSE partials of a train step:
//   pred = a @ fW + fb;  g = two_inv_denom * mask * (pred - t),
//   mask = row < nvalid; sse_part holds (sum (mask (pred - t))^2,
//   sum (mask (pred - gt))^2) per block, summed later in block order.
__global__ void __launch_bounds__(kThreads) final_loss_kernel(
    const float* __restrict__ a, const float* __restrict__ fW,
    const float* __restrict__ fb, const float* __restrict__ t,
    const float* __restrict__ gt, float* __restrict__ pred,
    float* __restrict__ g, float* __restrict__ sse_part, int n, int K,
    int o, int nvalid, float two_inv_denom) {
  __shared__ float warp_sse[kThreads / 32][2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kWarps = kThreads / 32;
  float st = 0.f, sg = 0.f;
  for (int it = 0; it < kFinalRowsPerBlock / kWarps; ++it) {
    const int r = blockIdx.x * kFinalRowsPerBlock + it * kWarps + warp;
    if (r >= n) break;
    float acc[kMaxOut];
#pragma unroll
    for (int c = 0; c < kMaxOut; ++c) acc[c] = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float av = a[(size_t)r * K + k];
#pragma unroll
      for (int c = 0; c < kMaxOut; ++c)
        if (c < o) acc[c] = fmaf(av, fW[(size_t)k * o + c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < kMaxOut; ++c) {
      if (c >= o) break;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
    }
    if (lane == 0) {
      const bool valid = r < nvalid;
#pragma unroll
      for (int c = 0; c < kMaxOut; ++c) {
        if (c >= o) break;
        const size_t idx = (size_t)r * o + c;
        const float y = acc[c] + fb[c];
        pred[idx] = y;
        const float et = valid ? y - t[idx] : 0.f;
        const float eg = valid ? y - gt[idx] : 0.f;
        g[idx] = two_inv_denom * et;
        st += et * et;
        sg += eg * eg;
      }
    }
  }
  if (lane == 0) {
    warp_sse[warp][0] = st;
    warp_sse[warp][1] = sg;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s0 = 0.f, s1 = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      s0 += warp_sse[w][0];
      s1 += warp_sse[w][1];
    }
    sse_part[2 * blockIdx.x] = s0;
    sse_part[2 * blockIdx.x + 1] = s1;
  }
}

inline cudaError_t final_forward(const float* a, const float* fW,
                                 const float* fb, float* pred, int n, int K,
                                 int o, cudaStream_t st) {
  final_forward_kernel<<<ceil_div(n, kFinalRowsPerBlock), kThreads, 0, st>>>(
      a, fW, fb, pred, n, K, o);
  return cudaGetLastError();
}

// Blocks of final_loss_kernel for n rows (its SSE partials: 2 floats each).
inline int final_loss_blocks(int n) { return ceil_div(n, kFinalRowsPerBlock); }

// The step's final layer and loss: pred, g (n x o); with want_metrics the
// SSE sums (2) from `part` (2 x final_loss_blocks(n) floats of scratch).
inline cudaError_t final_loss(const float* a, const float* fW,
                              const float* fb, const float* t,
                              const float* gt, float* pred, float* g,
                              float* sse, float* part, int n, int K, int o,
                              int nvalid, float two_inv_denom,
                              int want_metrics, cudaStream_t st) {
  const int blocks = final_loss_blocks(n);
  final_loss_kernel<<<blocks, kThreads, 0, st>>>(
      a, fW, fb, t, gt ? gt : t, pred, g, part, n, K, o, nvalid,
      two_inv_denom);
  GEMM_CHECK(cudaGetLastError());
  if (want_metrics) {
    reduce_chunks_kernel<<<1, 32, 0, st>>>(part, blocks, 2, sse, nullptr, 1,
                                           0);
    GEMM_CHECK(cudaGetLastError());
  }
  return cudaSuccess;
}

}  // namespace gemm_common
