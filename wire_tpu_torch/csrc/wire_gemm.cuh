// Shared pieces of the WIRE kernels (csrc/wire_step.cu, csrc/wire_mlp.cu):
// the paired complex GEMM with its Gabor forward/backward epilogues, the real
// first layer, and the forward and backward chains built from them and from
// gemm_common.cuh's fixed-order weight-gradient sums.  See wire_step.cu for
// the design note.
//
// The stacked complex layout (ops/wire_step.py:stack_params):
//   z1 = c @ w1 + b1;  a0 = [e^{-s^2 z1^2} cos(w1 z1) | e^{-s^2 z1^2} sin(w1 z1)]
//   per hidden layer: z = a @ [[wr, wi], [-wi, wr]] + [br | bi]
//                     a = e^{-w zi - s^2 (zr^2 + zi^2)} [cos(w zr) | sin(w zr)]
//   y = a @ [fwr; -fwi] + fbr
// Accuracy: sincosf/expf (not the __sinf/__expf intrinsics; phases w*z lie
// far outside [-pi, pi]).  Build without --use_fast_math.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "gemm_common.cuh"

namespace wire_gemm {

using namespace gemm_common;

constexpr int kTileRows = 64;     // rows of the output tile
constexpr int kTileUnits = 32;    // complex units per tile -> 64 real columns

enum Epilogue { kFwdGabor = 0, kBwdGabor = 1, kBwdFirst = 2 };

// out = A (n x K) @ B (K x 2h) for the column pairs (j, h + j) of the units j
// in this tile, followed by the epilogue:
//   kFwdGabor: z = out + bias; out0 = z (n x 2h), or nothing when out0 is
//              null (a forward that saves nothing); out1 = Gabor(z) (n x 2h)
//   kBwdGabor: out is dL/d(layer output act); out0 = dL/dz (n x 2h),
//              zin = the layer's pre-activation z (n x 2h)
//   kBwdFirst: as kBwdGabor for the real first layer; zin = z1 (n x h),
//              out0 = dL/dz1 (n x h)
template <int kEpi>
__global__ void __launch_bounds__(kThreads) paired_gemm_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ bias, const float* __restrict__ act,
    const float* __restrict__ zin, float* __restrict__ out0,
    float* __restrict__ out1, int n, int K, int h, float omega, float s2) {
  __shared__ __align__(16) float As[kTileK][kTileRows + 4];
  __shared__ __align__(16) float Bs[kTileK][2 * kTileUnits];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // units tx*2, tx*2+1 of the tile
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3 of the tile
  const int row0 = blockIdx.x * kTileRows;
  const int unit0 = blockIdx.y * kTileUnits;
  const int h2 = 2 * h;

  float acc[4][4];  // [row][re u0, re u1, im u0, im u1]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

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
      const int k = tid / (2 * kTileUnits) + q * (kThreads / (2 * kTileUnits));
      const int oc = tid % (2 * kTileUnits);
      const int unit = unit0 + oc % kTileUnits;
      const int gc = oc < kTileUnits ? unit : h + unit;
      const int gk = k0 + k;
      Bs[k][oc] = (unit < h && gk < K) ? B[(size_t)gk * h2 + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float2 br = *reinterpret_cast<const float2*>(&Bs[k][tx * 2]);
      const float2 bi =
          *reinterpret_cast<const float2*>(&Bs[k][kTileUnits + tx * 2]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {br.x, br.y, bi.x, bi.y};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= n) continue;
    const size_t base = (size_t)r * h2;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int j = unit0 + tx * 2 + p;
      if (j >= h) continue;
      const float xr = acc[i][p], xi = acc[i][2 + p];
      if (kEpi == kFwdGabor) {
        const float zr = xr + bias[j], zi = xi + bias[h + j];
        if (out0 != nullptr) {
          out0[base + j] = zr;
          out0[base + h + j] = zi;
        }
        const float m = expf(-omega * zi - s2 * (zr * zr + zi * zi));
        float sn, cs;
        sincosf(omega * zr, &sn, &cs);
        out1[base + j] = m * cs;
        out1[base + h + j] = m * sn;
      } else {
        // activation-form Gabor backward (wire_step.py:218-226):
        //   t1 = dar*ar + dai*ai, t2 = dai*ar - dar*ai
        //   dzr = -2 s^2 zr t1 + w t2,  dzi = (-w - 2 s^2 zi) t1
        const float ar = act[base + j], ai = act[base + h + j];
        const float t1 = xr * ar + xi * ai;
        const float t2 = xi * ar - xr * ai;
        if (kEpi == kBwdGabor) {
          const float zr = zin[base + j], zi = zin[base + h + j];
          out0[base + j] = (-2.f * s2) * zr * t1 + omega * t2;
          out0[base + h + j] = (-omega - (2.f * s2) * zi) * t1;
        } else {
          const size_t idx = (size_t)r * h + j;
          out0[idx] = (-2.f * s2) * zin[idx] * t1 + omega * t2;
        }
      }
    }
  }
}

// First (real) layer: z1 = c @ w1 + b1 (not stored when z1 is null),
// a0 = Gabor(z1); one thread per (row, unit).
__global__ void first_forward_kernel(const float* __restrict__ c,
                                     const float* __restrict__ w1,
                                     const float* __restrict__ b1,
                                     float* __restrict__ z1,
                                     float* __restrict__ a0, int n, int d,
                                     int h, float omega, float s2) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)n * h) return;
  const size_t r = idx / h;
  const int j = (int)(idx % h);
  float z = 0.f;
  for (int k = 0; k < d; ++k) z = fmaf(c[r * d + k], w1[(size_t)k * h + j], z);
  z += b1[j];
  if (z1 != nullptr) z1[idx] = z;
  const float m = expf(-s2 * (z * z));
  float sn, cs;
  sincosf(omega * z, &sn, &cs);
  a0[r * 2 * h + j] = m * cs;
  a0[r * 2 * h + h + j] = m * sn;
}

template <int kEpi>
cudaError_t paired_gemm(const float* A, const float* B, const float* bias,
                        const float* act, const float* zin, float* out0,
                        float* out1, int n, int K, int h, float omega,
                        float s2, cudaStream_t st) {
  const dim3 grid(ceil_div(n, kTileRows), ceil_div(h, kTileUnits));
  paired_gemm_kernel<kEpi><<<grid, kThreads, 0, st>>>(
      A, B, bias, act, zin, out0, out1, n, K, h, omega, s2);
  return cudaGetLastError();
}


// Floats needed by the `part` workspace of weight_grad (and, for the step,
// the SSE partials of final_loss_kernel) for shapes (n, d, h, o).
inline long long part_floats(int n, int d, int h, int o) {
  const long long chunks = ceil_div(n, kChunkRows);
  long long e = (long long)(2 * h + 1) * (2 * h);
  const long long e_first = (long long)(d + 1) * h;
  const long long e_final = (long long)(2 * h + 1) * o;
  if (e_first > e) e = e_first;
  if (e_final > e) e = e_final;
  long long need = chunks * e;
  const long long sse = 2LL * ceil_div(n, kFinalRowsPerBlock);
  return need > sse ? need : sse;
}

// First layer and the L hidden layers: z1 (n, h), acts (L + 1, n, 2h),
// zs (L, n, 2h).  The final layer is the caller's.  With `pingpong` (then
// z1 and zs are null and acts holds two (n, 2h) planes) nothing is kept for
// a backward: layer l writes plane l % 2, so the last activation is plane
// L % 2.
inline cudaError_t forward_hidden(const float* coords, const float* w1,
                                  const float* b1, const float* Wh,
                                  const float* Bh, float* acts, float* zs,
                                  float* z1, int n, int d, int h, int L,
                                  float omega0, float s2, float first_omega0,
                                  cudaStream_t st, bool pingpong = false) {
  const int h2 = 2 * h;
  const size_t act_sz = (size_t)n * h2;
  const size_t w_sz = (size_t)h2 * h2;
  first_forward_kernel<<<ceil_div((long long)n * h, kThreads), kThreads, 0,
                         st>>>(coords, w1, b1, z1, acts, n, d, h,
                               first_omega0, s2);
  GEMM_CHECK(cudaGetLastError());
  for (int l = 0; l < L; ++l) {
    const size_t in = pingpong ? l % 2 : l;
    const size_t out = pingpong ? (l + 1) % 2 : l + 1;
    GEMM_CHECK(paired_gemm<kFwdGabor>(
        acts + in * act_sz, Wh + l * w_sz, Bh + (size_t)l * h2, nullptr,
        nullptr, pingpong ? nullptr : zs + l * act_sz, acts + out * act_sz,
        n, h2, h, omega0, s2, st));
  }
  return cudaSuccess;
}

// The backward from the output cotangent g (n, o) to every weight gradient:
//   gfW (2h + 1, o) = [dfW; dfb], gWh (L, 2h + 1, 2h) = [dW; dB] per layer,
//   gw1 (d + 1, h) = [dw1; db1]; dz1 (n, h) is left holding dL/dz1.
// Scratch: dz (2, n, 2h), part (part_floats).
inline cudaError_t backward(const float* coords, const float* g,
                            const float* WhT, const float* fWT,
                            const float* acts, const float* zs,
                            const float* z1, float* gw1, float* gWh,
                            float* gfW, float* dz, float* dz1, float* part,
                            int n, int d, int h, int o, int L, float omega0,
                            float s2, float first_omega0, cudaStream_t st) {
  const int h2 = 2 * h;
  const size_t act_sz = (size_t)n * h2;
  const size_t w_sz = (size_t)h2 * h2;
  GEMM_CHECK(weight_grad(acts + L * act_sz, g, part, gfW, n, h2, o, st));
  const float* dsrc = g;
  const float* bt = fWT;
  int kdim = o;
  int cur = 0;
  for (int l = L - 1; l >= 0; --l) {
    float* dzl = dz + cur * act_sz;
    GEMM_CHECK(paired_gemm<kBwdGabor>(dsrc, bt, nullptr,
                                      acts + (l + 1) * act_sz,
                                      zs + l * act_sz, dzl, nullptr, n, kdim,
                                      h, omega0, s2, st));
    GEMM_CHECK(weight_grad(acts + l * act_sz, dzl, part,
                           gWh + (size_t)l * (h2 + 1) * h2, n, h2, h2, st));
    dsrc = dzl;
    bt = WhT + l * w_sz;
    kdim = h2;
    cur ^= 1;
  }
  GEMM_CHECK(paired_gemm<kBwdFirst>(dsrc, bt, nullptr, acts, z1, dz1, nullptr,
                                    n, kdim, h, first_omega0, s2, st));
  return weight_grad(coords, dz1, part, gw1, n, d, h, st);
}

}  // namespace wire_gemm
