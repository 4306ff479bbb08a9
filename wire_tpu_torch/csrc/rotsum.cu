// Rotate-and-row-sum (the reference-exact spatial Radon operator) and its
// exact adjoint, as hand-written fp32 kernels for Hopper (sm_90a).
//
// Replaces: wire_tpu/ops/pallas/rotsum.py:rotate_project (the forward Pallas
// call and the adjoint Pallas call of its custom VJP).  Same math, for an
// (H, W) image, W output columns x and H integration rows t:
//   sino[a, x] = sum_t bilinear(plane[k_a], R_phi_a (x - cx, t - cy) + c)
// with c = (cx, cy) = ((W - 1) / 2, (H - 1) / 2), zero outside the plane,
//   sx = cos(phi) (x - cx) - sin(phi) (t - cy) + cx
//   sy = sin(phi) (x - cx) + cos(phi) (t - cy) + cy.
// A square image takes theta_a = 90 k_a + phi_a, |phi_a| <= 45 deg, and the
// lattice-exact plane[k] = rot90(img, k), as the TPU kernel does; a
// non-square image (rot90 would change its shape) takes its one plane and
// phi_a = theta_a.  The host side (ops/rotsum.py) splits the angles and
// builds and folds the planes.  The TPU's padded planes, one-hot MXU
// selectors and 128-lane column compaction are Mosaic workarounds and do
// not carry over: here every tap is bounds-checked, so the planes are the
// (H, W) images and nothing outside them is summed.
//
// What bounds it: operations, and those are few.  At the CT shape (256^2,
// A = 100) the forward is 6.6 M bilinear samples (~66 MFLOP) against
// ~0.4 MB of planes and sinogram, ~1 us at the fp32 peak; in practice the
// four dependent taps per sample (L1/L2 hits, the planes are 1 MB) set the
// time.
//
// What this design does about it:
// - forward: one warp per (angle, x); its lanes walk t in strides of 32 and
//   meet in a fixed butterfly, so the sum's order is fixed;
// - adjoint: a gather, not a scatter: one thread per plane pixel visits, for
//   each angle of its plane in order, the few (x, t) lattice points whose
//   bilinear footprint can cover it (|(x, t) - R^T (p - c) - c| <=
//   |cos| + |sin| per axis, at most 4 x 4 candidates) and adds
//   cot[a, x] times the forward's own tap weight.  No float atomics: the
//   result is identical run to run, and it is the exact transpose of the
//   forward because both compute each sample's position and weights with
//   the same device function.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 256;

struct Sample {
  int x0, y0;    // top-left tap
  float wx, wy;  // weights of the x0 + 1 / y0 + 1 taps
};

// Position of the sample of output column x at integration row t.
__device__ __forceinline__ Sample sample_at(int x, int t, float cphi,
                                            float sphi, float cx, float cy) {
  const float xr = (float)x - cx;
  const float yr = (float)t - cy;
  const float sx = cphi * xr - sphi * yr + cx;
  const float sy = sphi * xr + cphi * yr + cy;
  const float fx = floorf(sx), fy = floorf(sy);
  Sample s;
  s.x0 = (int)fx;
  s.y0 = (int)fy;
  s.wx = sx - fx;
  s.wy = sy - fy;
  return s;
}

__device__ __forceinline__ float tap(const float* __restrict__ plane, int H,
                                     int W, int y, int x) {
  return (x >= 0 && x < W && y >= 0 && y < H) ? plane[(size_t)y * W + x]
                                              : 0.f;
}

// sino (A, W); planes (P, H, W); per-angle cos phi, sin phi, plane index.
__global__ void __launch_bounds__(kThreads) rotsum_forward_kernel(
    const float* __restrict__ planes, const float* __restrict__ cphi,
    const float* __restrict__ sphi, const int* __restrict__ kidx,
    float* __restrict__ sino, int A, int H, int W) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= A * W) return;
  const int a = warp / W, x = warp % W;
  const float ca = cphi[a], sa = sphi[a];
  const float cx = 0.5f * (float)(W - 1), cy = 0.5f * (float)(H - 1);
  const float* plane = planes + (size_t)kidx[a] * H * W;
  float acc = 0.f;
  for (int t = lane; t < H; t += 32) {
    const Sample s = sample_at(x, t, ca, sa, cx, cy);
    const float top = tap(plane, H, W, s.y0, s.x0) * (1.f - s.wx) +
                      tap(plane, H, W, s.y0, s.x0 + 1) * s.wx;
    const float bot = tap(plane, H, W, s.y0 + 1, s.x0) * (1.f - s.wx) +
                      tap(plane, H, W, s.y0 + 1, s.x0 + 1) * s.wx;
    acc += top * (1.f - s.wy) + bot * s.wy;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) sino[(size_t)a * W + x] = acc;
}

// Weight of pixel p in the taps x0, x0 + 1 of a sample with fraction w.
__device__ __forceinline__ float tap_weight(int p, int x0, float w) {
  return p == x0 ? 1.f - w : (p == x0 + 1 ? w : 0.f);
}

// planes_bar (P, H, W) = the adjoint of the forward applied to cot (A, W).
__global__ void __launch_bounds__(kThreads) rotsum_adjoint_kernel(
    const float* __restrict__ cot, const float* __restrict__ cphi,
    const float* __restrict__ sphi, const int* __restrict__ kidx,
    float* __restrict__ planes_bar, int A, int P, int H, int W) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)P * H * W) return;
  const int v = (int)(idx / ((size_t)H * W));
  const int py = (int)((idx / W) % H);
  const int px = (int)(idx % W);
  const float cx = 0.5f * (float)(W - 1), cy = 0.5f * (float)(H - 1);
  const float dx = (float)px - cx, dy = (float)py - cy;
  float acc = 0.f;
  for (int a = 0; a < A; ++a) {
    if (kidx[a] != v) continue;
    const float ca = cphi[a], sa = sphi[a];
    // (x, t) with R (x - cx, t - cy) + c = p; samples within one pixel of p
    // per axis lie within r = |cos| + |sin| of it per axis
    const float ux = ca * dx + sa * dy + cx;
    const float ut = -sa * dx + ca * dy + cy;
    const float r = fabsf(ca) + fabsf(sa) + 1e-3f;
    const int x_lo = max(0, (int)ceilf(ux - r));
    const int x_hi = min(W - 1, (int)floorf(ux + r));
    const int t_lo = max(0, (int)ceilf(ut - r));
    const int t_hi = min(H - 1, (int)floorf(ut + r));
    for (int x = x_lo; x <= x_hi; ++x) {
      const float g = cot[(size_t)a * W + x];
      for (int t = t_lo; t <= t_hi; ++t) {
        const Sample s = sample_at(x, t, ca, sa, cx, cy);
        const float w = tap_weight(px, s.x0, s.wx) *
                        tap_weight(py, s.y0, s.wy);
        acc += g * w;
      }
    }
  }
  planes_bar[idx] = acc;
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

}  // namespace

extern "C" {

const char* rotsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// sino (A, W) from planes (P, H, W) and the angle parts cphi, sphi (A)
// float, kidx (A) int32 in 0 .. P - 1.  Returns the launch's CUDA error (0
// on success); launches on `stream` and does not synchronise.
int rotsum_forward(const float* planes, const float* cphi, const float* sphi,
                   const int* kidx, float* sino, int A, int P, int H, int W,
                   void* stream) {
  (void)P;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long threads = (long long)A * W * 32;
  rotsum_forward_kernel<<<ceil_div(threads, kThreads), kThreads, 0, st>>>(
      planes, cphi, sphi, kidx, sino, A, H, W);
  return cudaGetLastError();
}

// planes_bar (P, H, W) from cot (A, W), same angle parts.
int rotsum_adjoint(const float* cot, const float* cphi, const float* sphi,
                   const int* kidx, float* planes_bar, int A, int P, int H,
                   int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long threads = (long long)P * H * W;
  rotsum_adjoint_kernel<<<ceil_div(threads, kThreads), kThreads, 0, st>>>(
      cot, cphi, sphi, kidx, planes_bar, A, P, H, W);
  return cudaGetLastError();
}

}  // extern "C"
