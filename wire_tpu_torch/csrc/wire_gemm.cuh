// Shared pieces of the WIRE kernels (csrc/wire_step.cu, csrc/wire_mlp.cu):
// the real first layer, and the forward and backward chains of the stacked
// complex layout, whose hidden layers run on wire_tc.cuh's 3xTF32
// tensor-core loop (the Gabor forward/backward in its paired products'
// epilogues, the weight gradients as its fixed-order chunk partials) and
// whose first- and final-layer weight gradients take wire_tc.cuh's narrow
// kernel.  See wire_mlp.cu for the design note.
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
#include "wire_tc.cuh"

namespace wire_gemm {

using namespace gemm_common;

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

// Floats of the `part` workspace that backward_chain needs for shapes
// (n, d, h, o): the largest of its weight gradients' chunk partials (the
// hidden layers' 1,024-row chunks, the first and final layers' 512-row
// ones).
inline long long chain_part_floats(int n, int d, int h, int o) {
  const long long hidden = wire_tc::wgrad_part_floats(n, 2 * h, 2 * h);
  const long long first = wire_tc::narrow_part_floats(n, d, h);
  const long long final = wire_tc::narrow_part_floats(n, 2 * h, o);
  const long long need = hidden > first ? hidden : first;
  return need > final ? need : final;
}

// First layer and the L hidden layers: z1 (n, h), acts (L + 1, n, 2h),
// zs (L, n, 2h); the final layer is the caller's.  With `pingpong` (then
// z1 and zs are null and acts holds two (n, 2h) planes) nothing is kept
// for a backward: layer l writes plane (l + 1) % 2, so the last activation
// is plane L % 2.
inline cudaError_t forward_chain(const float* coords, const float* w1,
                                 const float* b1, const float* Wh,
                                 const float* Bh, float* acts, float* zs,
                                 float* z1, int n, int d, int h, int L,
                                 float omega0, float s2, float first_omega0,
                                 cudaStream_t st, bool pingpong) {
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
    GEMM_CHECK(wire_tc::paired<wire_tc::kFwd>(
        acts + in * act_sz, Wh + l * w_sz, Bh + (size_t)l * h2, nullptr,
        nullptr, pingpong ? nullptr : zs + l * act_sz, acts + out * act_sz,
        n, h2, h, omega0, s2, st));
  }
  return cudaSuccess;
}

// The backward from the output cotangent g (n, o) to every weight gradient:
//   gfW (2h + 1, o) = [dfW; dfb], gWh (L, 2h + 1, 2h) = [dW; dB] per layer,
//   gw1 (d + 1, h) = [dw1; db1]; dz1 (n, h) is left holding dL/dz1.
// Scratch: dz (2, n, 2h), part (chain_part_floats).
inline cudaError_t backward_chain(
    const float* coords, const float* g, const float* WhT, const float* fWT,
    const float* acts, const float* zs, const float* z1, float* gw1,
    float* gWh, float* gfW, float* dz, float* dz1, float* part, int n, int d,
    int h, int o, int L, float omega0, float s2, float first_omega0,
    cudaStream_t st) {
  const int h2 = 2 * h;
  const size_t act_sz = (size_t)n * h2;
  const size_t w_sz = (size_t)h2 * h2;
  GEMM_CHECK(
      wire_tc::narrow_weight_grad(acts + L * act_sz, g, part, gfW, n, h2, o,
                                  st));
  const float* dsrc = g;
  const float* bt = fWT;
  int kdim = o;
  int cur = 0;
  for (int l = L - 1; l >= 0; --l) {
    float* dzl = dz + cur * act_sz;
    GEMM_CHECK(wire_tc::paired<wire_tc::kBwd>(
        dsrc, bt, nullptr, acts + (l + 1) * act_sz, zs + l * act_sz, dzl,
        nullptr, n, kdim, h, omega0, s2, st));
    GEMM_CHECK(wire_tc::weight_grad(acts + l * act_sz, dzl, part,
                                    gWh + (size_t)l * (h2 + 1) * h2, n, h2,
                                    h2, st));
    dsrc = dzl;
    bt = WhT + l * w_sz;
    kdim = h2;
    cur ^= 1;
  }
  GEMM_CHECK(wire_tc::paired<wire_tc::kBwdFirst>(
      dsrc, bt, nullptr, acts, z1, dz1, nullptr, n, kdim, h, first_omega0,
      s2, st));
  return wire_tc::narrow_weight_grad(coords, dz1, part, gw1, n, d, h, st);
}

}  // namespace wire_gemm
