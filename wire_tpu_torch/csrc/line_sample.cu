// The Fourier-slice sampler on the complex spectrum itself: bilinear samples
// of the centred, fftshifted spectrum along radial lines (the gather of the
// Fourier-slice Radon operator) and its exact adjoint (the scatter), as
// hand-written fp32 kernels for Hopper (sm_90a).
//
// Replaces: wire_tpu/ops/pallas/line_sample.py:144 (the gather Pallas call)
// and :153 (the scatter Pallas call of its custom VJP), together with the
// plane-building around them in wire_tpu/operators/radon.py:_radon_fourier:
// the fftshift of the spectrum, the centring phase, the periodic halo, the
// split into re and im planes, and the un-centring phase after the samples.
// The gather reads F, the unshifted (P, P) complex64 output of
// torch.fft.fftn, as float2, and writes the (A, K) complex64 slice
//   s[a, k] = u[k] * sum_t w_t c[ym_t, xm_t] F[(ym_t - P/2) mod P,
//                                                (xm_t - P/2) mod P]
// over the four taps t = (y, x) of the bilinear stencil at (gy, gx)[a, k]:
// y0 = floor(gy), wy = gy - y0 (x likewise), y in {y0, y0 + 1}, ym = y mod P.
// The mod P is the periodic halo (a sample on the Nyquist line, position P,
// reads lines P and P + 1, which alias to 0 and 1); (i - P/2) mod P, with
// P/2 = floor(P / 2), is torch.fft.fftshift's map out[i] = in[(i - n/2) mod
// n], so P may be odd.  c is the centring phase, u the un-centring phase.
// The scatter is the adjoint in PyTorch's convention for a C-linear map,
// grad = M^H cot:
//   F_bar[(ym_t - P/2) mod P, (xm_t - P/2) mod P]
//       += conj(u[k]) w_t conj(c[ym_t, xm_t]) cot[a, k].
//
// The centring phase is read from the (P, P) table that operators/radon.py
// caches, at the taps, and not computed here.  Its phase reaches ~3,200 rad
// at P = 1,024, where one fp32 ulp is 2.4e-4 rad, so a phase rounded in any
// other order (the separable product e^{i t_y} e^{i t_x}, or 1-D
// frequencies divided where PyTorch's CUDA division by a scalar multiplies
// by its reciprocal) moves a sample by up to ~2e-4 x max, past the 1e-4 x
// max the kernels are held to.  The table gives the plain version's values
// bit for bit, for 8 more bytes a tap.
//
// What bounds it: bytes.  At the CT shape (P = 1,024, A = 100, K = 513) the
// gather touches ~1.6 MB of F's 8.4 MB and as much of the table, reads the
// positions (0.4 MB) and writes the 0.4 MB slice; the scatter reads the
// same taps of the table and the 0.4 MB cotangent, and zeroes and writes
// the 8.4 MB gradient plane, which is most of the pair's bytes.  The
// arithmetic (~50 flops a sample and direction) is negligible.
//
// What this design does about it:
// - one thread per (a, k); neighbouring threads walk along one radial line,
//   so their taps share cache lines near the centre; a tap is one 8-byte
//   load of F and one of the table, with no re/im planes, no halo-padded
//   plane, no staging and no scratch: the shift, the halo and both phases
//   are index arithmetic and a complex product in registers;
// - the scatter adds each tap with Hopper's vector atomicAdd(float2*,
//   float2) (compute capability 9.x, global memory), one atomic a tap where
//   re/im planes took two.  Many angles meet near the centre (all of them
//   at k = 0), so the order of those additions, and the last bits of the
//   gradient, vary from run to run; the deterministic gather form would need
//   the inverse of the caller's line geometry, which these kernels do not
//   know.  The halo taps fold into lines 0 and 1 through the same atomics;
// - one cudaMemsetAsync zeroes the gradient plane before the scatter;
// - replicas (the batched multi-fit's CT, wire_tpu vmapping these Pallas
//   calls): `reps` spectra of one P share the tables, replica r in
//   blockIdx.y reading and writing r times a plane's (a slice's) size past
//   the start.  Its gather is bit-equal to an unbatched call; its scatter,
//   like an unbatched one, adds in a varying order.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int wrap(int i, int p) {
  i %= p;
  return i < 0 ? i + p : i;
}

// a * b and a * conj(b)
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}
__device__ __forceinline__ float2 scale(float w, float2 a) {
  return make_float2(w * a.x, w * a.y);
}

// one tap of the scatter: Hopper's vector atomic on global memory (compute
// capability 9.x), one instruction where two float atomics were (timed
// against them by tools/exp_line_atomics.py)
__device__ __forceinline__ void add_tap(float2* p, float2 v) {
  atomicAdd(p, v);
}

// The bilinear stencil at (gy, gx): for each of its two rows and columns the
// offset of the tap in F (unshifted) and in the centring table (shifted
// frame, halo wrapped), and the weights of the second row and column.
struct Stencil {
  size_t frow[2], crow[2];
  int fcol[2], ccol[2];
  float wy, wx;
};

__device__ __forceinline__ Stencil stencil_at(float gy, float gx, int p) {
  const float fy = floorf(gy), fx = floorf(gx);
  const int y0 = (int)fy, x0 = (int)fx, half = p / 2;
  Stencil s;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const int ym = wrap(y0 + d, p), xm = wrap(x0 + d, p);
    s.crow[d] = (size_t)ym * p;
    s.ccol[d] = xm;
    s.frow[d] = (size_t)wrap(ym - half, p) * p;
    s.fcol[d] = wrap(xm - half, p);
  }
  s.wy = gy - fy;
  s.wx = gx - fx;
  return s;
}

__global__ void __launch_bounds__(kThreads) spectrum_gather_kernel(
    const float2* __restrict__ f, const float2* __restrict__ centre,
    const float* __restrict__ gy, const float* __restrict__ gx,
    const float2* __restrict__ uncentre, float2* __restrict__ out, int n,
    int k, int p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  f += (size_t)blockIdx.y * p * p;
  out += (size_t)blockIdx.y * n;
  const Stencil s = stencil_at(gy[i], gx[i], p);
  float2 v[2][2];
#pragma unroll
  for (int dy = 0; dy < 2; ++dy)
#pragma unroll
    for (int dx = 0; dx < 2; ++dx)
      v[dy][dx] = cmul(f[s.frow[dy] + s.fcol[dx]],
                       centre[s.crow[dy] + s.ccol[dx]]);
  const float ux = 1.f - s.wx, uy = 1.f - s.wy;
  const float2 top = make_float2(ux * v[0][0].x + s.wx * v[0][1].x,
                                 ux * v[0][0].y + s.wx * v[0][1].y);
  const float2 bot = make_float2(ux * v[1][0].x + s.wx * v[1][1].x,
                                 ux * v[1][0].y + s.wx * v[1][1].y);
  const float2 r = make_float2(uy * top.x + s.wy * bot.x,
                               uy * top.y + s.wy * bot.y);
  out[i] = cmul(r, uncentre[i % k]);
}

__global__ void __launch_bounds__(kThreads) spectrum_scatter_kernel(
    const float2* __restrict__ cot, const float2* __restrict__ centre,
    const float* __restrict__ gy, const float* __restrict__ gx,
    const float2* __restrict__ uncentre, float2* __restrict__ f_bar, int n,
    int k, int p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  cot += (size_t)blockIdx.y * n;
  f_bar += (size_t)blockIdx.y * p * p;
  const Stencil s = stencil_at(gy[i], gx[i], p);
  const float2 g = cmul_conj(cot[i], uncentre[i % k]);
  const float ux = 1.f - s.wx, uy = 1.f - s.wy;
  const float2 rows[2] = {scale(uy, g), scale(s.wy, g)};
  const float cols[2] = {ux, s.wx};
#pragma unroll
  for (int dy = 0; dy < 2; ++dy)
#pragma unroll
    for (int dx = 0; dx < 2; ++dx)
      add_tap(f_bar + s.frow[dy] + s.fcol[dx],
              cmul_conj(scale(cols[dx], rows[dy]),
                        centre[s.crow[dy] + s.ccol[dx]]));
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

}  // namespace

extern "C" {

const char* line_sample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out (reps, n = A k, complex64) = the slices of the unshifted (reps, p, p)
// spectra f at positions gy, gx (n), with the centring table centre (p, p)
// and the un-centring phase uncentre (k).  Returns the launch's CUDA error
// (0 on success); launches on `stream` and does not synchronise.
int spectrum_gather(const float2* f, const float2* centre, const float* gy,
                    const float* gx, const float2* uncentre, float2* out,
                    int n, int k, int p, int reps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  spectrum_gather_kernel<<<dim3(ceil_div(n, kThreads), reps), kThreads, 0,
                           st>>>(f, centre, gy, gx, uncentre, out, n, k, p);
  return cudaGetLastError();
}

// f_bar (reps, p, p, complex64) = the adjoint applied to cot (reps, n);
// the planes are zeroed here first.
int spectrum_scatter(const float2* cot, const float2* centre, const float* gy,
                     const float* gx, const float2* uncentre, float2* f_bar,
                     int n, int k, int p, int reps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      f_bar, 0, (size_t)reps * p * p * sizeof(float2), st);
  if (err != cudaSuccess) return err;
  spectrum_scatter_kernel<<<dim3(ceil_div(n, kThreads), reps), kThreads, 0,
                            st>>>(cot, centre, gy, gx, uncentre, f_bar, n, k,
                                  p);
  return cudaGetLastError();
}

}  // extern "C"
