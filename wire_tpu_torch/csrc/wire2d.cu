// WIRE-2D (the two-head 2-D Gabor MLP) as hand-written fp32 kernels for
// Hopper (sm_90a): the one-pass train step and the apply/VJP pair.
//
// Replaces: wire_tpu/ops/pallas/wire2d_step.py:wire2d_step_fused (the
// one-pass step: forward, masked-MSE loss gradient with nvalid and denom,
// backward without dcoords, the SSE sums against target and gt) and
// wire2d_mlp_fused (the forward Pallas call and the recompute-backward
// Pallas call of its custom VJP, with dcoords).  Same math, in the stacked
// layout of ops/wire2d.py:stack_params (no lane padding):
//   z1 = c @ [Wl | Wo] + b1 = [lr | or]  (n x 2h)
//   a0 = e^{-s^2 (lr^2 + or^2)} [cos(w1 lr) | sin(w1 lr)]
//   per hidden layer: z4 = a @ W2 + B2 = [lr | li | or | oi]  (n x 4h),
//     W2 = [[wr_l, wi_l, wr_o, wi_o], [-wi_l, wr_l, -wi_o, wr_o]]
//     a = e^{-w li - s^2 (lr^2 + li^2 + or^2 + oi^2)} [cos(w lr) | sin(w lr)]
//   y = a @ [fwr; -fwi] + fbr
// and the backward in activation form (wire2d_step.py:189-198): with
// da = (dar, dai), the layer's output a = (ar, ai), t1 = dar ar + dai ai,
// t2 = dai ar - dar ai:
//   dlr = -2 s^2 lr t1 + w t2,  dli = (-w - 2 s^2 li) t1,
//   dor = -2 s^2 or t1,         doi = -2 s^2 oi t1
// (the first layer: dlr1 and dor1 with w1; its li and oi are zero).
//
// What bounds it: operations.  At the denoise shape (n = 65,536 rows,
// d = 2, h = 150 units per head, L = 2, o = 3) a step is 142.3 GFLOP of
// fp32 multiply-adds, three (n x 300 x 600) products per hidden layer
// (forward, data gradient, weight gradient), against ~4 MB of inputs and
// outputs: 2.12 ms at the card's 67 TFLOP/s fp32 peak.  The CT pair
// (o = 1, no dcoords) is 142.0 GFLOP.
//
// What this design does about it: it is the simple, correct first version,
// on the same CUDA-core GEMM shape as the WIRE kernels (wire_gemm.cuh).
// - One tiled GEMM loop (64-row tiles, 16-deep k slices, a 4 x 4 register
//   block per thread, fp32 FMA) with two column gathers.  The forward
//   gathers the four columns (j, h + j, 2h + j, 3h + j) of one unit into a
//   thread's registers (16 units per tile), so its epilogue adds B2, keeps
//   z4 when a backward will want it, and writes the Gabor-2D activation
//   (n x 2h).  The data gradient dz4 (n x 4h) @ W2^T (4h x 2h) gathers the
//   column pair (j, h + j) (32 units per tile, as wire_gemm.cuh's
//   paired_gemm), so dar and dai meet the layer's z4 and a in its epilogue,
//   which writes dz4 (or, for the first layer, dz1 = [dlr1 | dor1]).
// - h = 150 stays 150, with masked tiles; the TPU kernel's 128-lane padding
//   to 256, its two-slot software pipeline, VMEM accumulators and phantom
//   grid step do not carry over: activations live in device memory
//   (acts (L + 1) n 2h, zs L n 4h, z1 n 2h floats; 630 MB at the denoise
//   shape), owned by the caller and reused across steps.
// - Weight and bias gradients [A | 1]^T dZ are gemm_common.cuh's fixed-order
//   2048-row chunk partials summed in chunk order; dcoords = dz1 w1^T is one
//   warp per row with a fixed butterfly.  No float atomics: two calls give
//   identical bits.  The final layer (alone or fused with the loss gradient
//   and SSE sums) is gemm_common.cuh's.
// - The pair's backward reads the forward's saved activations instead of
//   recomputing them as the TPU kernel does (a third of the pair's
//   operations against ~1.3 GB of reads); a forward with no gradient to
//   take runs through two ping-pong planes and keeps nothing.
// Tensor cores (TF32 wgmma) and TMA pipelines are later work.
//
// Accuracy: sincosf/expf, never the __sinf/__expf intrinsics (the phases
// w lr lie far outside [-pi, pi]); build without --use_fast_math.  The
// magnitude is one expf of -w li - s^2 arg, as the plain version and JAX
// take it: e^{-w li} alone can overflow where the Gaussian is 0.

#include <cuda_runtime.h>

#include <cstddef>

#include "gemm_common.cuh"

using namespace gemm_common;

namespace {

constexpr int kRows = 64;       // rows of an output tile
constexpr int kTileCols = 64;   // columns of an output tile (16 per ty row)
constexpr int kQuadUnits = 16;  // units of a forward tile: 4 columns each
constexpr int kPairUnits = 32;  // units of a data-gradient tile: 2 columns

enum Epilogue { kBwdHidden = 0, kBwdFirst = 1 };

// Column gathers of the GEMM loop: a thread tx (0 .. 15) owns the four
// output columns col(tx, 0 .. 3) of its 4 rows; -1 is a masked column.
// The forward: the four channels [lr, li, or, oi] of unit unit0 + tx of
// an (n x 4h) product.
struct QuadCols {
  int unit0, h;
  __device__ __forceinline__ int operator()(int tx, int c) const {
    const int u = unit0 + tx;
    return u < h ? c * h + u : -1;
  }
};

// The data gradient: [re u, re u + 1, im u, im u + 1] for the units
// u = unit0 + 2 tx, u + 1 of an (n x 2h) product.
struct PairCols {
  int unit0, h;
  __device__ __forceinline__ int operator()(int tx, int c) const {
    const int u = unit0 + 2 * tx + (c & 1);
    return u < h ? (c >> 1) * h + u : -1;
  }
};

// acc[i][c] = sum_k A[row0 + 4 ty + i, k] B[k, cols(tx, c)] over k < K, for
// A (n x K) and B (K x ldb) row-major; rows past n and masked columns give
// zeros.  256 threads: tx = tid % 16, ty = tid / 16.
template <class Cols>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ A,
                                          const float* __restrict__ B,
                                          int n, int K, int ldb, int row0,
                                          const Cols& cols,
                                          float (&acc)[4][4]) {
  __shared__ __align__(16) float As[kTileK][kRows + 4];
  __shared__ __align__(16) float Bs[kTileK][kTileCols];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  // this thread's B-tile column: (tx', c') = (oc % 16, oc / 16), so
  // neighbouring threads read neighbouring units
  const int oc = tid % kTileCols;
  const int bcol = cols(oc % 16, oc / 16);
  const int bslot = (oc % 16) * 4 + oc / 16;
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
      const int gk = k0 + k;
      Bs[k][bslot] =
          (bcol >= 0 && gk < K) ? B[(size_t)gk * ldb + bcol] : 0.f;
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
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
    __syncthreads();
  }
}

// The Gabor-2D activation of one unit: (ar, ai) from its four channels.
__device__ __forceinline__ void gabor2d(float lr, float li, float orr,
                                        float oi, float omega, float s2,
                                        float* ar, float* ai) {
  const float arg = lr * lr + li * li + orr * orr + oi * oi;
  const float m = expf(-omega * li - s2 * arg);
  float sn, cs;
  sincosf(omega * lr, &sn, &cs);
  *ar = m * cs;
  *ai = m * sn;
}

// First layer: z1 = c @ w1 + b1 = [lr | or] (n x 2h), kept unless z1 is
// null; a0 = Gabor-2D(lr, 0, or, 0) with omega = first_omega0 (n x 2h).
// One thread per (row, unit).
__global__ void __launch_bounds__(kThreads) gabor2d_first_kernel(
    const float* __restrict__ c, const float* __restrict__ w1,
    const float* __restrict__ b1, float* __restrict__ z1,
    float* __restrict__ a0, int n, int d, int h, float omega, float s2) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)n * h) return;
  const size_t r = idx / h;
  const int j = (int)(idx % h);
  const int h2 = 2 * h;
  float lr = 0.f, orr = 0.f;
  for (int k = 0; k < d; ++k) {
    const float x = c[r * d + k];
    lr = fmaf(x, w1[(size_t)k * h2 + j], lr);
    orr = fmaf(x, w1[(size_t)k * h2 + h + j], orr);
  }
  lr += b1[j];
  orr += b1[h + j];
  if (z1 != nullptr) {
    z1[r * h2 + j] = lr;
    z1[r * h2 + h + j] = orr;
  }
  gabor2d(lr, 0.f, orr, 0.f, omega, s2, &a0[r * h2 + j], &a0[r * h2 + h + j]);
}

// Hidden forward: z4 = a @ W2 + B2 (a n x 2h, W2 2h x 4h); z4 kept in zs
// (n x 4h) unless zs is null; a_out = Gabor-2D(z4) (n x 2h).
__global__ void __launch_bounds__(kThreads) gabor2d_fwd_kernel(
    const float* __restrict__ a, const float* __restrict__ W2,
    const float* __restrict__ B2, float* __restrict__ zs,
    float* __restrict__ a_out, int n, int h, float omega, float s2) {
  const int row0 = blockIdx.x * kRows;
  const QuadCols cols{(int)blockIdx.y * kQuadUnits, h};
  float acc[4][4];
  gemm_tile(a, W2, n, 2 * h, 4 * h, row0, cols, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int j = cols.unit0 + tx;
  if (j >= h) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= n) break;
    float z[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) z[c] = acc[i][c] + B2[c * h + j];
    if (zs != nullptr) {
      float* zr = zs + (size_t)r * 4 * h;
#pragma unroll
      for (int c = 0; c < 4; ++c) zr[c * h + j] = z[c];
    }
    float* ar = a_out + (size_t)r * 2 * h;
    gabor2d(z[0], z[1], z[2], z[3], omega, s2, &ar[j], &ar[h + j]);
  }
}

// Data gradient: da = D @ Bt (D n x K, Bt K x 2h) for the column pairs
// (j, h + j), followed by the activation-form Gabor-2D backward with the
// layer's output act (n x 2h):
//   kBwdHidden: zin = the layer's z4 (n x 4h); out = dz4 (n x 4h)
//   kBwdFirst:  zin = z1 (n x 2h); out = dz1 = [dlr1 | dor1] (n x 2h)
template <int kEpi>
__global__ void __launch_bounds__(kThreads) gabor2d_bwd_kernel(
    const float* __restrict__ D, const float* __restrict__ Bt,
    const float* __restrict__ act, const float* __restrict__ zin,
    float* __restrict__ out, int n, int K, int h, float omega, float s2) {
  const int row0 = blockIdx.x * kRows;
  const PairCols cols{(int)blockIdx.y * kPairUnits, h};
  float acc[4][4];
  gemm_tile(D, Bt, n, K, 2 * h, row0, cols, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float m2s2 = -2.f * s2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= n) break;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int j = cols.unit0 + 2 * tx + p;
      if (j >= h) continue;
      const float dar = acc[i][p], dai = acc[i][2 + p];
      const float* ap = act + (size_t)r * 2 * h;
      const float ar = ap[j], ai = ap[h + j];
      const float t1 = dar * ar + dai * ai;
      const float t2 = dai * ar - dar * ai;
      if (kEpi == kBwdHidden) {
        const float* z = zin + (size_t)r * 4 * h;
        float* o = out + (size_t)r * 4 * h;
        o[j] = m2s2 * z[j] * t1 + omega * t2;
        o[h + j] = (-omega + m2s2 * z[h + j]) * t1;
        o[2 * h + j] = m2s2 * z[2 * h + j] * t1;
        o[3 * h + j] = m2s2 * z[3 * h + j] * t1;
      } else {
        const float* z = zin + (size_t)r * 2 * h;
        float* o = out + (size_t)r * 2 * h;
        o[j] = m2s2 * z[j] * t1 + omega * t2;
        o[h + j] = m2s2 * z[h + j] * t1;
      }
    }
  }
}

// dcoords[r, k] = sum_j dz1[r, j] w1[k, j] over the 2h columns: one warp
// per row, lanes striding over the columns and meeting in a fixed
// butterfly.
__global__ void __launch_bounds__(kThreads) gabor2d_dcoords_kernel(
    const float* __restrict__ dz1, const float* __restrict__ w1,
    float* __restrict__ dc, int n, int d, int h2) {
  constexpr int kMaxIn = 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kWarps = kThreads / 32;
  for (int it = 0; it < kFinalRowsPerBlock / kWarps; ++it) {
    const int r = blockIdx.x * kFinalRowsPerBlock + it * kWarps + warp;
    if (r >= n) break;
    for (int k0 = 0; k0 < d; k0 += kMaxIn) {
      float acc[kMaxIn];
#pragma unroll
      for (int k = 0; k < kMaxIn; ++k) acc[k] = 0.f;
      for (int j = lane; j < h2; j += 32) {
        const float g = dz1[(size_t)r * h2 + j];
#pragma unroll
        for (int k = 0; k < kMaxIn; ++k)
          if (k0 + k < d)
            acc[k] = fmaf(g, w1[(size_t)(k0 + k) * h2 + j], acc[k]);
      }
#pragma unroll
      for (int k = 0; k < kMaxIn; ++k)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kMaxIn; ++k)
          if (k0 + k < d) dc[(size_t)r * d + k0 + k] = acc[k];
      }
    }
  }
}

// First layer and the L hidden layers: z1 (n x 2h), acts (L + 1, n, 2h),
// zs (L, n, 4h).  With `pingpong` (z1 and zs null, acts two (n x 2h)
// planes) nothing is kept for a backward: layer l writes plane (l + 1) % 2,
// so the last activation is plane L % 2.
cudaError_t forward_hidden(const float* coords, const float* w1,
                           const float* b1, const float* W2,
                           const float* B2, float* acts, float* zs,
                           float* z1, int n, int d, int h, int L,
                           float omega0, float s2, float first_omega0,
                           cudaStream_t st, bool pingpong) {
  const size_t act_sz = (size_t)n * 2 * h;
  const size_t z_sz = (size_t)n * 4 * h;
  const size_t w_sz = (size_t)2 * h * 4 * h;
  gabor2d_first_kernel<<<ceil_div((long long)n * h, kThreads), kThreads, 0,
                         st>>>(coords, w1, b1, z1, acts, n, d, h,
                               first_omega0, s2);
  GEMM_CHECK(cudaGetLastError());
  const dim3 grid(ceil_div(n, kRows), ceil_div(h, kQuadUnits));
  for (int l = 0; l < L; ++l) {
    const size_t in = pingpong ? l % 2 : l;
    const size_t out = pingpong ? (l + 1) % 2 : l + 1;
    gabor2d_fwd_kernel<<<grid, kThreads, 0, st>>>(
        acts + in * act_sz, W2 + l * w_sz, B2 + (size_t)l * 4 * h,
        pingpong ? nullptr : zs + l * z_sz, acts + out * act_sz, n, h,
        omega0, s2);
    GEMM_CHECK(cudaGetLastError());
  }
  return cudaSuccess;
}

// The backward from the output cotangent g (n x o) to every weight
// gradient: gfW (2h + 1, o) = [dfW; dfb], gW2 (L, 2h + 1, 4h) = [dW2; dB2],
// gw1 (d + 1, 2h) = [dw1; db1]; dz1 (n x 2h) is left holding dL/dz1.
// Scratch: dz (min(L, 2) planes of n x 4h), part (wire2d_part_floats).
cudaError_t backward(const float* coords, const float* g, const float* W2T,
                     const float* fWT, const float* acts, const float* zs,
                     const float* z1, float* gw1, float* gW2, float* gfW,
                     float* dz, float* dz1, float* part, int n, int d, int h,
                     int o, int L, float omega0, float s2,
                     float first_omega0, cudaStream_t st) {
  const int h2 = 2 * h, h4 = 4 * h;
  const size_t act_sz = (size_t)n * h2;
  const size_t z_sz = (size_t)n * h4;
  const size_t w_sz = (size_t)h4 * h2;
  const dim3 grid(ceil_div(n, kRows), ceil_div(h, kPairUnits));
  GEMM_CHECK(weight_grad(acts + L * act_sz, g, part, gfW, n, h2, o, st));
  const float* dsrc = g;
  const float* bt = fWT;
  int kdim = o;
  int cur = 0;
  for (int l = L - 1; l >= 0; --l) {
    float* dzl = dz + cur * z_sz;
    gabor2d_bwd_kernel<kBwdHidden><<<grid, kThreads, 0, st>>>(
        dsrc, bt, acts + (l + 1) * act_sz, zs + l * z_sz, dzl, n, kdim, h,
        omega0, s2);
    GEMM_CHECK(cudaGetLastError());
    GEMM_CHECK(weight_grad(acts + l * act_sz, dzl, part,
                           gW2 + (size_t)l * (h2 + 1) * h4, n, h2, h4, st));
    dsrc = dzl;
    bt = W2T + l * w_sz;
    kdim = h4;
    cur ^= 1;
  }
  gabor2d_bwd_kernel<kBwdFirst><<<grid, kThreads, 0, st>>>(
      dsrc, bt, acts, z1, dz1, n, kdim, h, first_omega0, s2);
  GEMM_CHECK(cudaGetLastError());
  return weight_grad(coords, dz1, part, gw1, n, d, h2, st);
}

}  // namespace

extern "C" {

// Floats of the `part` workspace (weight-gradient chunk partials, and the
// step's SSE partials) for shapes (n, d, h, o).
long long wire2d_part_floats(int n, int d, int h, int o) {
  long long e = (long long)(2 * h + 1) * 4 * h;
  const long long e_first = (long long)(d + 1) * 2 * h;
  const long long e_final = (long long)(2 * h + 1) * o;
  if (e_first > e) e = e_first;
  if (e_final > e) e = e_final;
  const long long need = (long long)ceil_div(n, kChunkRows) * e;
  const long long sse = 2LL * final_loss_blocks(n);
  return need > sse ? need : sse;
}

int wire2d_max_out() { return kMaxOut; }

const char* wire2d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One train step.  Weights in the stacked layout (ops/wire2d.py):
//   w1 (d, 2h), b1 (2h), W2 (L, 2h, 4h), W2T (L, 4h, 2h), B2 (L, 4h),
//   fW (2h, o), fWT (o, 2h), fb (o).
// Outputs: pred (n, o); gw1 (d + 1, 2h); gW2 (L, 2h + 1, 4h);
//   gfW (2h + 1, o); sse (2) = (sse_target, sse_gt) when want_metrics.
// Scratch: acts (L + 1, n, 2h), zs (L, n, 4h), z1 (n, 2h), g (n, o),
//   dz (min(L, 2), n, 4h), dz1 (n, 2h), part (wire2d_part_floats).
// Returns the first CUDA error of a launch (0 on success).  Launches on
// `stream` and does not synchronise.
int wire2d_step_run(const float* coords, const float* target,
                    const float* gt, const float* w1, const float* b1,
                    const float* W2, const float* W2T, const float* B2,
                    const float* fW, const float* fWT, const float* fb,
                    float* pred, float* gw1, float* gW2, float* gfW,
                    float* sse, float* acts, float* zs, float* z1, float* g,
                    float* dz, float* dz1, float* part, int n, int d, int h,
                    int o, int L, float omega0, float sigma0,
                    float first_omega0, int nvalid, float two_inv_denom,
                    int want_metrics, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float s2 = sigma0 * sigma0;
  GEMM_CHECK(forward_hidden(coords, w1, b1, W2, B2, acts, zs, z1, n, d, h, L,
                            omega0, s2, first_omega0, st, false));
  GEMM_CHECK(final_loss(acts + (size_t)L * n * 2 * h, fW, fb, target, gt,
                        pred, g, sse, part, n, 2 * h, o, nvalid,
                        two_inv_denom, want_metrics, st));
  return backward(coords, g, W2T, fWT, acts, zs, z1, gw1, gW2, gfW, dz, dz1,
                  part, n, d, h, o, L, omega0, s2, first_omega0, st);
}

// The pair's forward, keeping what the backward reads: pred (n, o);
// acts (L + 1, n, 2h), zs (L, n, 4h), z1 (n, 2h).
int wire2d_forward(const float* coords, const float* w1, const float* b1,
                   const float* W2, const float* B2, const float* fW,
                   const float* fb, float* pred, float* acts, float* zs,
                   float* z1, int n, int d, int h, int o, int L, float omega0,
                   float sigma0, float first_omega0, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float s2 = sigma0 * sigma0;
  GEMM_CHECK(forward_hidden(coords, w1, b1, W2, B2, acts, zs, z1, n, d, h, L,
                            omega0, s2, first_omega0, st, false));
  return final_forward(acts + (size_t)L * n * 2 * h, fW, fb, pred, n, 2 * h,
                       o, st);
}

// The forward alone, keeping nothing (no input needs a gradient): the chain
// runs through pingpong (2, n, 2h).
int wire2d_forward_nograd(const float* coords, const float* w1,
                          const float* b1, const float* W2, const float* B2,
                          const float* fW, const float* fb, float* pred,
                          float* pingpong, int n, int d, int h, int o, int L,
                          float omega0, float sigma0, float first_omega0,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float s2 = sigma0 * sigma0;
  GEMM_CHECK(forward_hidden(coords, w1, b1, W2, B2, pingpong, nullptr,
                            nullptr, n, d, h, L, omega0, s2, first_omega0, st,
                            true));
  return final_forward(pingpong + (size_t)(L % 2) * n * 2 * h, fW, fb, pred,
                       n, 2 * h, o, st);
}

// The pair's backward from g = dL/dpred (n, o), reading the forward's
// activations.  w1 (d, 2h) for dcoords; W2T (L, 4h, 2h); fWT (o, 2h).
// Outputs: gw1 (d + 1, 2h), gW2 (L, 2h + 1, 4h), gfW (2h + 1, o); dcoords
// (n, d), or null when no coordinate gradient is wanted (its kernel is then
// not launched).  Scratch: dz (min(L, 2), n, 4h), dz1 (n, 2h), part.
int wire2d_backward(const float* coords, const float* g, const float* w1,
                    const float* W2T, const float* fWT, const float* acts,
                    const float* zs, const float* z1, float* gw1, float* gW2,
                    float* gfW, float* dcoords, float* dz, float* dz1,
                    float* part, int n, int d, int h, int o, int L,
                    float omega0, float sigma0, float first_omega0,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float s2 = sigma0 * sigma0;
  GEMM_CHECK(backward(coords, g, W2T, fWT, acts, zs, z1, gw1, gW2, gfW, dz,
                      dz1, part, n, d, h, o, L, omega0, s2, first_omega0,
                      st));
  if (dcoords != nullptr) {
    gabor2d_dcoords_kernel<<<ceil_div(n, kFinalRowsPerBlock), kThreads, 0,
                             st>>>(dz1, w1, dcoords, n, d, 2 * h);
    GEMM_CHECK(cudaGetLastError());
  }
  return cudaSuccess;
}

}  // extern "C"
