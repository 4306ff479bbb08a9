// The canonical real MLP's pieces that real_tc.cuh builds its chains from
// (real_mlp.cu's pair and step, mscale2_step.cu's stacked trunks): the bases
// and their explicit derivatives, a layer's affine and basis as the
// epilogues read them, the network's shape, and the fixed-order column sums.
// real_mlp.cu's header comment says what they compute and why they are
// built so.
#pragma once

#include "gemm_common.cuh"

namespace real_chain {

using namespace gemm_common;

// Basis codes, as ops/real_mlp.py:BASIS_CODES.
enum Basis : int {
  kZero = 0,
  kQspline = 1,
  kCspline = 2,
  kSine = 3,
  kGauss = 4,
  kRelu = 5,
  kSrelu = 6,
  kIdentity = 7,
};

__device__ __forceinline__ float rl(float x) { return fmaxf(x, 0.f); }

__device__ __forceinline__ float basis_value(int code, float v) {
  const float a = fabsf(v);
  switch (code) {
    case kQspline:
      return a < 0.5f ? 0.75f - v * v
                      : (a < 1.5f ? 0.5f * (1.5f - a) * (1.5f - a) : 0.f);
    case kCspline:
      return a < 1.f ? (2.f / 3.f) - v * v + 0.5f * a * a * a
                     : (a < 2.f ? (1.f / 6.f) * (2.f - a) * (2.f - a) *
                                      (2.f - a)
                                : 0.f);
    case kSine:
      return sinf(v);
    case kGauss:
      return expf(-v * v);
    case kRelu:
      return fmaxf(v, 0.f);
    case kSrelu: {
      const float g = rl(1.f - v) * rl(v);
      return g * g;
    }
    case kIdentity:
      return v;
    default:
      return 0.f;
  }
}

__device__ __forceinline__ float basis_deriv(int code, float v) {
  const float a = fabsf(v);
  const float s = v < 0.f ? -1.f : 1.f;
  switch (code) {
    case kQspline:
      return a < 0.5f ? -2.f * v : (a < 1.5f ? -s * (1.5f - a) : 0.f);
    case kCspline:
      return a < 1.f ? -2.f * v + 1.5f * v * a
                     : (a < 2.f ? -0.5f * s * (2.f - a) * (2.f - a) : 0.f);
    case kSine:
      return cosf(v);
    case kGauss:
      return -2.f * v * expf(-v * v);
    case kRelu:
      return v > 0.f ? 1.f : 0.f;
    case kSrelu: {
      const float g = rl(1.f - v) * rl(v);
      return 2.f * g * (rl(1.f - v) * (v > 0.f ? 1.f : 0.f) -
                        (v < 1.f ? 1.f : 0.f) * rl(v));
    }
    case kIdentity:
      return 1.f;
    default:
      return 0.f;
  }
}

// The epilogues' two modes (real_tc.cuh): forward, data gradient.
enum Epilogue { kFwd = 0, kBwd = 1 };

// One layer's affine and basis, as the epilogues read them.
struct Layer {
  const float* alpha;           // (N)
  const float* beta;            // (N)
  const unsigned char* codes;   // (N) basis codes
  const float* gammas;          // per row block, or null
  int rows_per_block;
};

constexpr int kColsPerBlock = 32;
constexpr int kRowGroups = kThreads / kColsPerBlock;

// Per-chunk column sums of X (n x N): part[chunk * N + c] = sum of X[r, c]
// over the chunk's kChunkRows rows.  Thread (c, g) sums the rows r = g,
// g + 8, ... of the chunk in order; the 8 groups then meet in order in
// shared memory.  Replica blockIdx.z: its X (n x N) and its chunk partials
// follow its predecessors'.
__global__ void __launch_bounds__(kThreads) colsum_partial_kernel(
    const float* __restrict__ X, float* __restrict__ part, int n, int N) {
  __shared__ float sums[kRowGroups][kColsPerBlock];
  X += (size_t)blockIdx.z * n * N;
  part += (size_t)blockIdx.z * gridDim.y * N;
  const int cx = threadIdx.x % kColsPerBlock;
  const int g = threadIdx.x / kColsPerBlock;
  const int c = blockIdx.x * kColsPerBlock + cx;
  const int chunk = blockIdx.y;
  const int r_end = min(n, (chunk + 1) * kChunkRows);
  float s = 0.f;
  if (c < N) {
#pragma unroll 8
    for (int r = chunk * kChunkRows + g; r < r_end; r += kRowGroups)
      s += X[(size_t)r * N + c];
  }
  sums[g][cx] = s;
  __syncthreads();
  if (g == 0 && c < N) {
    float t = 0.f;
    for (int q = 0; q < kRowGroups; ++q) t += sums[q][cx];
    part[(size_t)chunk * N + c] = t;
  }
}

// Column sums of X (n x N) into out (N), in a fixed order; for `reps`
// replicas X holds reps x n x N, part reps x the chunk partials, out reps x
// N.
inline cudaError_t column_sum(const float* X, float* part, float* out,
                              int n, int N, cudaStream_t st, int reps = 1) {
  const int chunks = ceil_div(n, kChunkRows);
  const dim3 grid(ceil_div(N, kColsPerBlock), chunks, reps);
  colsum_partial_kernel<<<grid, kThreads, 0, st>>>(X, part, n, N);
  GEMM_CHECK(cudaGetLastError());
  return reduce_chunks(part, chunks, N, out, st, nullptr, 1, 0, reps);
}

// The network's shape: L activation layers; widths[0] = d (input features),
// widths[1 + l] = width of layer l, widths[L + 1] = o (outputs).
struct Shape {
  int n, L;
  const int* widths;
  int in(int l) const { return widths[l]; }
  int out(int l) const { return widths[l + 1]; }
  int o() const { return widths[L + 1]; }
  int max_width() const {
    int m = 0;
    for (int l = 0; l < L; ++l) m = out(l) > m ? out(l) : m;
    return m;
  }
};

inline Layer layer_of(const float* const* alpha, const float* const* beta,
                      const unsigned char* const* codes,
                      const float* gammas, int rows_per_block, int l) {
  return Layer{alpha[l], beta[l], codes[l], gammas, rows_per_block};
}

}  // namespace real_chain
