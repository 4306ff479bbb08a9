// Pieces shared by every MLP kernel of the port: the fixed-order chunk
// sums (reduce_chunks, every weight gradient's second pass), the final
// linear layer (alone, or fused with the masked-MSE loss gradient and the
// SSE sums of a train step), the launch helpers, and the CUDA-core weight
// gradient of the kernels not on the tensor cores (real_mlp.cu).
//
// That weight gradient [A | 1]^T D over n rows is written as
// per-2048-row-chunk partials and summed in chunk order by a second pass:
// no float atomics, so a result is identical run to run, and the bias
// gradient is the row of ones.  The final layer uses one warp per row; its
// lanes stride over the inputs and meet in a fixed butterfly, so its sums
// do not depend on scheduling either.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace gemm_common {

constexpr int kThreads = 256;
constexpr int kTileK = 16;        // depth of one shared-memory slice
constexpr int kTileOut = 64;      // weight-gradient output tile edge
constexpr int kChunkRows = 2048;  // rows summed by one weight-gradient block
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

// Per-chunk partial of [A | 1]^T D: A (n x KA), D (n x NB); the partial of
// chunk z is a (KA + 1) x NB block whose last row is the column sum of D
// (the bias gradient).
__global__ void __launch_bounds__(kThreads) wgrad_partial_kernel(
    const float* __restrict__ A, const float* __restrict__ D,
    float* __restrict__ part, int n, int KA, int NB) {
  __shared__ __align__(16) float As[kTileK][kTileOut];
  __shared__ __align__(16) float Ds[kTileK][kTileOut];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.x * kTileOut, j0 = blockIdx.y * kTileOut;
  const int chunk = blockIdx.z;
  const int r_begin = chunk * kChunkRows;
  const int r_end = min(n, r_begin + kChunkRows);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kTileK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int rr = tid / kTileOut + q * (kThreads / kTileOut);
      const int col = tid % kTileOut;
      const int gr = r0 + rr;
      const bool live = gr < r_end;
      const int gi = i0 + col, gj = j0 + col;
      float av = 0.f;
      if (live) av = gi < KA ? A[(size_t)gr * KA + gi] : (gi == KA ? 1.f : 0.f);
      As[rr][col] = av;
      Ds[rr][col] = (live && gj < NB) ? D[(size_t)gr * NB + gj] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kTileK; ++rr) {
      const float4 a = *reinterpret_cast<const float4*>(&As[rr][ty * 4]);
      const float4 dv = *reinterpret_cast<const float4*>(&Ds[rr][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  const size_t block = (size_t)chunk * (KA + 1) * NB;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = i0 + ty * 4 + i;
    if (gi > KA) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = j0 + tx * 4 + j;
      if (gj < NB) part[block + (size_t)gi * NB + gj] = acc[i][j];
    }
  }
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

// [A | 1]^T D summed over all n rows into out ((KA + 1) x NB).  With
// `colscale` (NB), the first KA rows come out multiplied by it per column:
// A^T (D diag(colscale)), the bias row stays the plain column sum of D.
inline cudaError_t weight_grad(const float* A, const float* D, float* part,
                               float* out, int n, int KA, int NB,
                               cudaStream_t st,
                               const float* colscale = nullptr) {
  const int chunks = ceil_div(n, kChunkRows);
  const dim3 grid(ceil_div(KA + 1, kTileOut), ceil_div(NB, kTileOut), chunks);
  wgrad_partial_kernel<<<grid, kThreads, 0, st>>>(A, D, part, n, KA, NB);
  GEMM_CHECK(cudaGetLastError());
  return reduce_chunks(part, chunks, (KA + 1) * NB, out, st, colscale, NB,
                       KA);
}

// Floats of the `part` workspace that weight_grad needs for an
// (KA + 1) x NB gradient over n rows.
inline long long wgrad_part_floats(int n, int KA, int NB) {
  return (long long)ceil_div(n, kChunkRows) * (KA + 1) * NB;
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
