// Rotate-and-row-sum (the reference-exact spatial Radon operator) and its
// exact adjoint, as hand-written fp32 kernels for Hopper (sm_90a).
//
// Replaces: wire_tpu/ops/pallas/rotsum.py:rotate_project (the forward Pallas
// call and the adjoint Pallas call of its custom VJP).  Same math, for an
// (H, W) image, W output columns x and H integration rows t:
//   sino[a, x] = sum_t bilinear(plane_a, R_phi_a (x - cx, t - cy) + c)
// with c = (cx, cy) = ((W - 1) / 2, (H - 1) / 2), zero outside the plane,
//   sx = cos(phi) (x - cx) - sin(phi) (t - cy) + cx
//   sy = sin(phi) (x - cx) + cos(phi) (t - cy) + cy.
// A square (S, S) image takes theta_a = 90 k_a + phi_a, |phi_a| <= 45 deg,
// and reads the lattice-exact plane_a = rot90(img, k_a), as the TPU kernel
// does; a non-square image (rot90 would change its shape) takes k_a = 0
// and phi_a = theta_a.  The host side (ops/rotsum.py) splits the angles
// once per operator into a (3, A) tensor on the device: cos phi, sin phi,
// k.  The TPU's padded planes, one-hot MXU selectors and 128-lane column
// compaction are Mosaic workarounds and do not carry over.
//
// What bounds it: operations, and those are few.  At the CT shape (256^2,
// A = 100) each direction is 6.6 M bilinear samples (~66 MFLOP) against
// ~0.4 MB of image and sinogram, ~1 us at the fp32 peak; in practice the
// dependent taps per sample (L1/L2 hits: the image is 256 KB) and the
// launch set the time.
//
// What this design does about it:
// - no planes in device memory: rot90(img, k) is an index map inside the
//   kernels (plane_k[i][j] = img[j][S-1-i], img[S-1-i][S-1-j],
//   img[S-1-j][i] for k = 1, 2, 3, torch.rot90's), so a call is one
//   forward and one adjoint kernel and nothing else;
// - forward: one block per (angle, 32 columns), threads along x (lanes
//   read neighbouring taps of a row), 8 segments of t per column summed in
//   t order and then combined in segment order, so the sum's order is
//   fixed;
// - adjoint: a gather, not a scatter: one thread per image pixel maps it
//   into each angle's plane with the inverse index map and visits, angle
//   by angle in order, the few (x, t) lattice points whose bilinear
//   footprint can cover it (|(x, t) - R^T (p - c) - c| <= |cos| + |sin|
//   per axis, at most 3 x 3 candidates) and adds cot[a, x] times the
//   forward's own tap weight.  The block stages the angle parts in shared
//   memory.  No float atomics: the result is identical run to run, and it
//   is the exact transpose of the forward because both compute each
//   sample's position and weights with the same device function.
// - replicas (the batched multi-fit's CT, wire_tpu vmapping this Pallas
//   call): `reps` images of one shape share the angle parts, replica r in
//   blockIdx.z reading and writing r times an image's (a sinogram's) size
//   past the start; its results are bit-equal to an unbatched call.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kCols = 32;     // forward: output columns per block
constexpr int kSegs = 8;      // forward: t segments per column
constexpr int kAdjTile = 16;  // adjoint: 16 x 16 pixels per block
constexpr int kPartChunk = 256;  // adjoint: angles staged at a time

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

// plane_k[y][x] = rot90(img, k)[y][x] (k = 0 for any H x W; k = 1..3 for a
// square image, H = W), zero outside the plane.
__device__ __forceinline__ float tap(const float* __restrict__ img, int k,
                                     int H, int W, int y, int x) {
  if (x < 0 || x >= W || y < 0 || y >= H) return 0.f;
  int r = y, c = x;
  if (k == 1) {
    r = x;
    c = W - 1 - y;
  } else if (k == 2) {
    r = H - 1 - y;
    c = W - 1 - x;
  } else if (k == 3) {
    r = H - 1 - x;
    c = y;
  }
  return __ldg(img + (size_t)r * W + c);
}

// sino (A, W) from img (H, W) and parts (3, A) = (cos phi, sin phi, k).
// Block (kCols, kSegs) over (32 columns, one angle).
__global__ void __launch_bounds__(kCols * kSegs) rotsum_forward_kernel(
    const float* __restrict__ img, const float* __restrict__ parts,
    float* __restrict__ sino, int A, int H, int W) {
  __shared__ float partial[kSegs][kCols];
  img += (size_t)blockIdx.z * H * W;
  sino += (size_t)blockIdx.z * A * W;
  const int lx = threadIdx.x, seg = threadIdx.y;
  const int a = blockIdx.y;
  const int x = blockIdx.x * kCols + lx;
  const float ca = parts[a], sa = parts[A + a];
  const int k = (int)parts[2 * A + a];
  const float cx = 0.5f * (float)(W - 1), cy = 0.5f * (float)(H - 1);
  const int len = (H + kSegs - 1) / kSegs;
  const int t_end = min(H, (seg + 1) * len);
  float acc = 0.f;
  if (x < W) {
    for (int t = seg * len; t < t_end; ++t) {
      const Sample s = sample_at(x, t, ca, sa, cx, cy);
      const float top = tap(img, k, H, W, s.y0, s.x0) * (1.f - s.wx) +
                        tap(img, k, H, W, s.y0, s.x0 + 1) * s.wx;
      const float bot = tap(img, k, H, W, s.y0 + 1, s.x0) * (1.f - s.wx) +
                        tap(img, k, H, W, s.y0 + 1, s.x0 + 1) * s.wx;
      acc += top * (1.f - s.wy) + bot * s.wy;
    }
  }
  partial[seg][lx] = acc;
  __syncthreads();
  if (seg == 0 && x < W) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kSegs; ++i) s += partial[i][lx];
    sino[(size_t)a * W + x] = s;
  }
}

// Weight of pixel p in the taps x0, x0 + 1 of a sample with fraction w.
__device__ __forceinline__ float tap_weight(int p, int x0, float w) {
  return p == x0 ? 1.f - w : (p == x0 + 1 ? w : 0.f);
}

// img_bar (H, W) = the adjoint of the forward applied to cot (A, W).
// Block kAdjTile x kAdjTile over image pixels.
__global__ void __launch_bounds__(kAdjTile * kAdjTile) rotsum_adjoint_kernel(
    const float* __restrict__ cot, const float* __restrict__ parts,
    float* __restrict__ img_bar, int A, int H, int W) {
  __shared__ float sc[kPartChunk], ss[kPartChunk];
  __shared__ int sk[kPartChunk];
  cot += (size_t)blockIdx.z * A * W;
  img_bar += (size_t)blockIdx.z * H * W;
  const int tid = threadIdx.y * kAdjTile + threadIdx.x;
  const int q = blockIdx.x * kAdjTile + threadIdx.x;  // image column
  const int p = blockIdx.y * kAdjTile + threadIdx.y;  // image row
  const bool live = p < H && q < W;
  const float cx = 0.5f * (float)(W - 1), cy = 0.5f * (float)(H - 1);
  float acc = 0.f;
  for (int a0 = 0; a0 < A; a0 += kPartChunk) {
    const int na = min(kPartChunk, A - a0);
    __syncthreads();
    for (int i = tid; i < na; i += kAdjTile * kAdjTile) {
      sc[i] = parts[a0 + i];
      ss[i] = parts[A + a0 + i];
      sk[i] = (int)parts[2 * A + a0 + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < na; ++i) {
      const int a = a0 + i;
      const float ca = sc[i], sa = ss[i];
      const int k = sk[i];
      // the pixel (py, px) of plane_k that holds img[p][q]
      int py = p, px = q;
      if (k == 1) {
        py = W - 1 - q;
        px = p;
      } else if (k == 2) {
        py = H - 1 - p;
        px = W - 1 - q;
      } else if (k == 3) {
        py = q;
        px = H - 1 - p;
      }
      const float dx = (float)px - cx, dy = (float)py - cy;
      // (x, t) with R (x - cx, t - cy) + c = (px, py); samples within one
      // pixel of it per axis lie within r = |cos| + |sin| of it per axis
      const float ux = ca * dx + sa * dy + cx;
      const float ut = -sa * dx + ca * dy + cy;
      const float r = fabsf(ca) + fabsf(sa) + 1e-3f;
      const int x_lo = max(0, (int)ceilf(ux - r));
      const int x_hi = min(W - 1, (int)floorf(ux + r));
      const int t_lo = max(0, (int)ceilf(ut - r));
      const int t_hi = min(H - 1, (int)floorf(ut + r));
      for (int x = x_lo; x <= x_hi; ++x) {
        const float g = __ldg(cot + (size_t)a * W + x);
        for (int t = t_lo; t <= t_hi; ++t) {
          const Sample s = sample_at(x, t, ca, sa, cx, cy);
          const float w = tap_weight(px, s.x0, s.wx) *
                          tap_weight(py, s.y0, s.wy);
          acc += g * w;
        }
      }
    }
  }
  if (live) img_bar[(size_t)p * W + q] = acc;
}

}  // namespace

extern "C" {

const char* rotsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// sino (reps, A, W) from img (reps, H, W) and the angle parts (3, A) float:
// cos phi, sin phi, k in 0..3 (k = 0 unless H = W).  Returns the launch's
// CUDA error (0 on success); launches on `stream` and does not synchronise.
int rotsum_forward(const float* img, const float* parts, float* sino, int A,
                   int H, int W, int reps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + kCols - 1) / kCols, A, reps);
  rotsum_forward_kernel<<<grid, dim3(kCols, kSegs), 0, st>>>(img, parts,
                                                             sino, A, H, W);
  return cudaGetLastError();
}

// img_bar (reps, H, W) from cot (reps, A, W), same angle parts.
int rotsum_adjoint(const float* cot, const float* parts, float* img_bar,
                   int A, int H, int W, int reps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + kAdjTile - 1) / kAdjTile,
                  (H + kAdjTile - 1) / kAdjTile, reps);
  rotsum_adjoint_kernel<<<grid, dim3(kAdjTile, kAdjTile), 0, st>>>(
      cot, parts, img_bar, A, H, W);
  return cudaGetLastError();
}

}  // extern "C"
