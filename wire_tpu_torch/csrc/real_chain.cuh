// The canonical real MLP's chains, shared by real_mlp.cu (the apply/VJP
// pair and the one-pass step) and mscale2_step.cu (every scale's trunk in
// one stacked pass): the bases and their explicit derivatives, the tiled
// GEMM with its forward and backward epilogues, the fixed-order column
// sums, and the forward and backward chains through L activation layers,
// with an optional per-row-block gamma.  real_mlp.cu's header comment says
// what they compute and why they are built so.
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

constexpr int kTileRows = 64;
constexpr int kTileCols = 64;

enum Epilogue { kFwd = 0, kBwd = 1, kPlain = 2 };

// One layer's affine and basis, as the epilogues read them.
struct Layer {
  const float* alpha;           // (N)
  const float* beta;            // (N)
  const unsigned char* codes;   // (N) basis codes
  const float* gammas;          // per row block, or null
  int rows_per_block;
};

// acc = A (n x K) @ B (K x N) for a 64 x 64 tile, then the epilogue:
//   kFwd:   z = acc; v = gamma (alpha z + beta); out0 = z (skipped when
//           null), out1 = B(v)                             (n x N each)
//   kBwd:   acc is da; z = zin; v as above; dv = gamma dB(v) da;
//           out0 = dv, out1 = z dv                         (n x N each)
//   kPlain: out0 = acc
template <int kEpi>
__global__ void __launch_bounds__(kThreads) real_gemm_kernel(
    const float* __restrict__ A, const float* __restrict__ B, Layer lay,
    const float* __restrict__ zin, float* __restrict__ out0,
    float* __restrict__ out1, int n, int K, int N) {
  __shared__ __align__(16) float As[kTileK][kTileRows + 4];
  __shared__ __align__(16) float Bs[kTileK][kTileCols];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4 .. tx*4+3 of the tile
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3 of the tile
  const int row0 = blockIdx.x * kTileRows;
  const int col0 = blockIdx.y * kTileCols;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = tid / kTileK + q * (kThreads / kTileK);
      const int k = tid % kTileK;
      const int gr = row0 + r, gk = k0 + k;
      As[k][r] = (gr < n && gk < K) ? A[(size_t)gr * K + gk] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = tid / kTileCols + q * (kThreads / kTileCols);
      const int c = tid % kTileCols;
      const int gk = k0 + k, gc = col0 + c;
      Bs[k][c] = (gk < K && gc < N) ? B[(size_t)gk * N + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= n) continue;
    float gamma = 1.f;
    if (kEpi != kPlain && lay.gammas != nullptr)
      gamma = lay.gammas[r / lay.rows_per_block];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c >= N) continue;
      const size_t idx = (size_t)r * N + c;
      if (kEpi == kPlain) {
        out0[idx] = acc[i][j];
      } else if (kEpi == kFwd) {
        const float z = acc[i][j];
        float v = lay.alpha[c] * z + lay.beta[c];
        if (lay.gammas != nullptr) v = gamma * v;
        if (out0 != nullptr) out0[idx] = z;
        out1[idx] = basis_value(lay.codes[c], v);
      } else {
        const float z = zin[idx];
        float v = lay.alpha[c] * z + lay.beta[c];
        if (lay.gammas != nullptr) v = gamma * v;
        float dv = basis_deriv(lay.codes[c], v) * acc[i][j];
        if (lay.gammas != nullptr) dv = gamma * dv;
        out0[idx] = dv;
        out1[idx] = z * dv;
      }
    }
  }
}

template <int kEpi>
cudaError_t real_gemm(const float* A, const float* B, const Layer& lay,
                      const float* zin, float* out0, float* out1, int n,
                      int K, int N, cudaStream_t st) {
  const dim3 grid(ceil_div(n, kTileRows), ceil_div(N, kTileCols));
  real_gemm_kernel<kEpi><<<grid, kThreads, 0, st>>>(A, B, lay, zin, out0,
                                                    out1, n, K, N);
  return cudaGetLastError();
}

constexpr int kColsPerBlock = 32;
constexpr int kRowGroups = kThreads / kColsPerBlock;

// Per-chunk column sums of X (n x N): part[chunk * N + c] = sum of X[r, c]
// over the chunk's kChunkRows rows.  Thread (c, g) sums the rows r = g,
// g + 8, ... of the chunk in order; the 8 groups then meet in order in
// shared memory.
__global__ void __launch_bounds__(kThreads) colsum_partial_kernel(
    const float* __restrict__ X, float* __restrict__ part, int n, int N) {
  __shared__ float sums[kRowGroups][kColsPerBlock];
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

// Column sums of X (n x N) into out (N), in a fixed order.
inline cudaError_t column_sum(const float* X, float* part, float* out,
                              int n, int N, cudaStream_t st) {
  const int chunks = ceil_div(n, kChunkRows);
  const dim3 grid(ceil_div(N, kColsPerBlock), chunks);
  colsum_partial_kernel<<<grid, kThreads, 0, st>>>(X, part, n, N);
  GEMM_CHECK(cudaGetLastError());
  return reduce_chunks(part, chunks, N, out, st);
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

// Floats of the `part` workspace that backward_chain (and a step's SSE
// partials) need.
inline long long chain_part_floats(const Shape& s) {
  const int n = s.n, L = s.L;
  long long need = wgrad_part_floats(n, s.out(L - 1), s.o());
  for (int l = 0; l < L; ++l) {
    const long long w = wgrad_part_floats(n, s.in(l), s.out(l));
    const long long c = (long long)ceil_div(n, kChunkRows) * s.out(l);
    need = w > need ? w : need;
    need = c > need ? c : need;
  }
  const long long sse = 2LL * final_loss_blocks(n);
  return need > sse ? need : sse;
}

inline Layer layer_of(const float* const* alpha, const float* const* beta,
                      const unsigned char* const* codes,
                      const float* gammas, int rows_per_block, int l) {
  return Layer{alpha[l], beta[l], codes[l], gammas, rows_per_block};
}

// Forward chain through the L activation layers: acts[l] (n x w_l) and,
// where zs[l] is not null, zs[l].  The final layer is the caller's.
inline cudaError_t forward_chain(const Shape& s, const float* x,
                                 const float* const* W,
                                 const float* const* alpha,
                                 const float* const* beta,
                                 const unsigned char* const* codes,
                                 const float* gammas, int rows_per_block,
                                 float* const* zs, float* const* acts,
                                 cudaStream_t st) {
  for (int l = 0; l < s.L; ++l) {
    const float* a_prev = l == 0 ? x : acts[l - 1];
    GEMM_CHECK(real_gemm<kFwd>(
        a_prev, W[l], layer_of(alpha, beta, codes, gammas, rows_per_block, l),
        nullptr, zs[l], acts[l], s.n, s.in(l), s.out(l), st));
  }
  return cudaSuccess;
}

// Backward chain from g = dL/dy (n x o) through the saved zs and acts:
//   gWf ((w_{L-1} + 1) x o) = [dWf; dbf];
//   gW[l] ((in_l + 1) x w_l) = [dW; dbeta];  galpha[l] (w_l);
//   dcoords (n x d) = dz_0 W_0^T when not null.
// WaT[l] = (W_l diag(alpha_l))^T (w_l x in_l), WfT = Wf^T (o x w_{L-1}).
// Scratch: dv (2, n, max w), zdv (n, max w), part.
inline cudaError_t backward_chain(const Shape& s, const float* x,
                                  const float* g, const float* const* WaT,
                                  const float* const* alpha,
                                  const float* const* beta,
                                  const unsigned char* const* codes,
                                  const float* WfT, const float* gammas,
                                  int rows_per_block, const float* const* zs,
                                  const float* const* acts, float* const* gW,
                                  float* const* galpha, float* gWf,
                                  float* dcoords, float* dv, float* zdv,
                                  float* part, cudaStream_t st) {
  const int n = s.n, L = s.L;
  const size_t plane = (size_t)n * s.max_width();
  GEMM_CHECK(weight_grad(acts[L - 1], g, part, gWf, n, s.out(L - 1), s.o(),
                         st));
  const float* src = g;
  const float* bt = WfT;
  int kdim = s.o();
  int cur = 0;
  for (int l = L - 1; l >= 0; --l) {
    float* dvl = dv + cur * plane;
    GEMM_CHECK(real_gemm<kBwd>(
        src, bt, layer_of(alpha, beta, codes, gammas, rows_per_block, l),
        zs[l], dvl, zdv, n, kdim, s.out(l), st));
    const float* a_prev = l == 0 ? x : acts[l - 1];
    GEMM_CHECK(weight_grad(a_prev, dvl, part, gW[l], n, s.in(l), s.out(l),
                           st, alpha[l]));
    GEMM_CHECK(column_sum(zdv, part, galpha[l], n, s.out(l), st));
    src = dvl;
    bt = WaT[l];
    kdim = s.out(l);
    cur ^= 1;
  }
  if (dcoords != nullptr) {
    GEMM_CHECK(real_gemm<kPlain>(src, bt, Layer{}, nullptr, dcoords, nullptr,
                                 n, kdim, s.in(0), st));
  }
  return cudaSuccess;
}

}  // namespace real_chain
