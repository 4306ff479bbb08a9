// Bilinear samples of the re/im spectrum planes along radial lines (the
// gather of the Fourier-slice Radon operator) and its adjoint scatter-add,
// as hand-written fp32 kernels for Hopper (sm_90a).
//
// Replaces: wire_tpu/ops/pallas/line_sample.py:sample_lines (the gather
// Pallas call and the scatter Pallas call of its custom VJP).  Same math:
//   s[a, k] = (1-wy)((1-wx) F[y0, x0] + wx F[y0, x0+1])
//           +   wy ((1-wx) F[y0+1, x0] + wx F[y0+1, x0+1])
// with y0 = floor(gy[a, k]), wy = gy - y0 (x likewise), for F = re and im,
// and the adjoint F_bar[y, x] += weight * s_bar[a, k] over the same taps.
// The caller (operators/radon.py) pads the fftshifted spectrum with 2
// periodic halo lines on the high side, so a sample on the Nyquist line
// (position P) reads rows/columns P and P + 1 of a (P + 2)^2 plane; the
// TPU's 128-line halo, one-hot MXU selectors and aligned blocks are Mosaic
// workarounds and do not carry over.  Taps outside the plane read and
// receive nothing.
//
// What bounds it: bytes.  At the CT shape (P = 1,024, A = 100, K = 513) the
// gather reads two (1,026)^2 planes (8.4 MB, of which it touches ~1.6 MB)
// and writes 0.4 MB; the scatter zeroes and writes the two planes.  The
// arithmetic (~18 flops per sample) is negligible.
//
// What this design does about it:
// - gather: one thread per (angle, k); neighbouring threads walk along one
//   radial line, so their taps share cache lines near the centre;
// - scatter: the same threads add their four weighted taps into the zeroed
//   planes with float atomics.  Many angles meet near the centre (all of
//   them at k = 0), so the order of those additions, and the last bits of
//   the result, vary from run to run; the deterministic gather form would
//   need the inverse of the caller's line geometry, which this kernel does
//   not know.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

struct Taps {
  int x0, y0;
  float wx, wy;
};

__device__ __forceinline__ Taps taps_at(float gy, float gx) {
  const float fy = floorf(gy), fx = floorf(gx);
  Taps t;
  t.y0 = (int)fy;
  t.x0 = (int)fx;
  t.wy = gy - fy;
  t.wx = gx - fx;
  return t;
}

__device__ __forceinline__ float read(const float* __restrict__ f, int ph,
                                      int y, int x) {
  return (x >= 0 && x < ph && y >= 0 && y < ph) ? f[(size_t)y * ph + x]
                                                : 0.f;
}

__device__ __forceinline__ void add(float* f, int ph, int y, int x, float v) {
  if (x >= 0 && x < ph && y >= 0 && y < ph)
    atomicAdd(f + (size_t)y * ph + x, v);
}

__global__ void __launch_bounds__(kThreads) line_gather_kernel(
    const float* __restrict__ fre, const float* __restrict__ fim,
    const float* __restrict__ gy, const float* __restrict__ gx,
    float* __restrict__ sre, float* __restrict__ sim, int n, int ph) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Taps t = taps_at(gy[i], gx[i]);
  const float ux = 1.f - t.wx, uy = 1.f - t.wy;
  const float* planes[2] = {fre, fim};
  float* outs[2] = {sre, sim};
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const float* f = planes[p];
    const float top = ux * read(f, ph, t.y0, t.x0) +
                      t.wx * read(f, ph, t.y0, t.x0 + 1);
    const float bot = ux * read(f, ph, t.y0 + 1, t.x0) +
                      t.wx * read(f, ph, t.y0 + 1, t.x0 + 1);
    outs[p][i] = uy * top + t.wy * bot;
  }
}

__global__ void __launch_bounds__(kThreads) line_scatter_kernel(
    const float* __restrict__ gre, const float* __restrict__ gim,
    const float* __restrict__ gy, const float* __restrict__ gx,
    float* __restrict__ fre_bar, float* __restrict__ fim_bar, int n, int ph) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Taps t = taps_at(gy[i], gx[i]);
  const float ux = 1.f - t.wx, uy = 1.f - t.wy;
  const float g[2] = {gre[i], gim[i]};
  float* planes[2] = {fre_bar, fim_bar};
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const float top = uy * g[p], bot = t.wy * g[p];
    add(planes[p], ph, t.y0, t.x0, ux * top);
    add(planes[p], ph, t.y0, t.x0 + 1, t.wx * top);
    add(planes[p], ph, t.y0 + 1, t.x0, ux * bot);
    add(planes[p], ph, t.y0 + 1, t.x0 + 1, t.wx * bot);
  }
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

}  // namespace

extern "C" {

const char* line_sample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// sre, sim (n) from planes fre, fim (ph, ph) at positions gy, gx (n).
// Returns the launch's CUDA error (0 on success); launches on `stream` and
// does not synchronise.
int line_sample_gather(const float* fre, const float* fim, const float* gy,
                       const float* gx, float* sre, float* sim, int n, int ph,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  line_gather_kernel<<<ceil_div(n, kThreads), kThreads, 0, st>>>(
      fre, fim, gy, gx, sre, sim, n, ph);
  return cudaGetLastError();
}

// fre_bar, fim_bar (ph, ph) = the adjoint applied to gre, gim (n); the
// planes are zeroed here first.
int line_sample_scatter(const float* gre, const float* gim, const float* gy,
                        const float* gx, float* fre_bar, float* fim_bar,
                        int n, int ph, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)ph * ph * sizeof(float);
  cudaError_t err = cudaMemsetAsync(fre_bar, 0, bytes, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(fim_bar, 0, bytes, st);
  if (err != cudaSuccess) return err;
  line_scatter_kernel<<<ceil_div(n, kThreads), kThreads, 0, st>>>(
      gre, gim, gy, gx, fre_bar, fim_bar, n, ph);
  return cudaGetLastError();
}

}  // extern "C"
