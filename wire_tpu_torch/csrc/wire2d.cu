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
// outputs: 2.12 ms at the card's 67 TFLOP/s fp32 peak, 0.86 ms for three
// TF32 products each at the tensor cores' 495 TFLOP/s.  The CT pair
// (o = 1, no dcoords) is 142.0 GFLOP.
//
// What this design does about it: the three products of every hidden layer
// run on wire_tc.cuh's 3xTF32 mma.sync loop (tile_product) at fp32
// accuracy, as WIRE's do; this file adds only WIRE-2D's column use and
// epilogues.
// - The forward z4 = a @ W2 + B2 stages W2's columns through the quad map
//   (wire_tc.cuh:kQuad, 16 units per 128 x 64 tile), so one thread holds
//   the four channels (j, h + j, 2h + j, 3h + j) of units j, j + 1; its
//   epilogue adds B2, keeps z4 when a backward will want it, and writes the
//   Gabor-2D activation (n x 2h).
// - The data gradient dz4 (n x 4h) @ W2^T (4h x 2h) (and the top layer's,
//   g (n x o) @ fWT) stages the column pair (j, h + j) (the paired map, 32
//   units per tile), so dar and dai meet the layer's z4 and a in its
//   epilogue, which writes dz4 (or, for the first layer, dz1 = [dlr1 |
//   dor1]).
// - h = 150 stays 150: the loop zero-fills ragged tiles in shared memory.
//   16-byte copies of A need only K % 4 == 0 (true at h = 150: K = 300,
//   600); B's mapped columns need h % 4 == 0 and take 4-byte copies at 150.
//   The TPU kernel's 128-lane padding to 256, its two-slot software
//   pipeline, VMEM accumulators and phantom grid step do not carry over:
//   activations live in device memory (acts (L + 1) n 2h, zs L n 4h, z1
//   n 2h floats; 630 MB at the denoise shape), owned by the caller and
//   reused across steps.
// - Weight and bias gradients: gW2 = [a^T dz4; colsum(dz4)] on the same
//   loop (wire_tc.cuh:weight_grad, fixed-order 1,024-row chunk partials),
//   the first layer's (X = coords, d wide) and the final layer's (D = g, o
//   wide) in wire_tc.cuh's narrow kernel; dcoords = dz1 w1^T is one warp
//   per row with a fixed butterfly.  No float atomics: two calls give
//   identical bits.  The final layer (alone or fused with the loss
//   gradient and SSE sums) is gemm_common.cuh's.
// - The pair's backward reads the forward's saved activations instead of
//   recomputing them as the TPU kernel does (a third of the pair's
//   operations against ~1.3 GB of reads); a forward with no gradient to
//   take runs through two ping-pong planes and keeps nothing.
//
// Replicas (the batched multi-fit, `reps` models of one shape in one launch
// sequence): every launch takes the replica in a grid axis of its own
// (blockIdx.y of the first layer, blockIdx.z of the quad and paired
// products; wire_tc.cuh's weight gradients and gemm_common.cuh's final layer
// and sums fold it in as they say).  Every tensor holds reps of its own,
// laid out layer-major, replica r of a layer's slice at r times its size past
// the slice: w1 (reps, d, 2h), b1 (reps, 2h), W2 (L, reps, 2h, 4h), W2T (L,
// reps, 4h, 2h), B2 (L, reps, 4h), fW (reps, 2h, o), fWT (reps, o, 2h), fb
// (reps, o); acts (L + 1, reps, n, 2h), zs (L, reps, n, 4h), z1 (reps, n,
// 2h), dz (2, reps, n, 4h), dz1 (reps, n, 2h); gw1 (reps, d + 1, 2h), gW2
// (L, reps, 2h + 1, 4h), gfW (reps, 2h + 1, o); pred and g (reps, n, o), sse
// (reps, 2); the coordinates (reps, n, d), or one (n, d) shared by all when
// coords_shared, the target and gt likewise when t_shared; part reps x
// wire2d_part_floats.  A replica's blocks do what an unbatched launch does,
// so its results are bit-equal to one.  The replica is a template flag
// (kReps) of the three layer kernels: an unbatched launch takes the
// instances without the replica's offsets, whose code is the single
// model's.  No dcoords on the replica path.
//
// Accuracy: 3xTF32 products (wire_tc.cuh: fp32's own distance from
// float64); sincosf/expf, never the __sinf/__expf intrinsics (the phases
// w lr lie far outside [-pi, pi]); build without --use_fast_math.  The
// magnitude is one expf of -w li - s^2 arg, as the plain version and JAX
// take it: e^{-w li} alone can overflow where the Gaussian is 0.

#include <cuda_runtime.h>

#include <cstddef>

#include "gemm_common.cuh"
#include "wire_tc.cuh"

using namespace gemm_common;

namespace {

enum Epilogue { kBwdHidden = 0, kBwdFirst = 1 };

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
// One thread per (row, unit).  kReps: replica blockIdx.y (c shared by the
// replicas when c_shared).
template <bool kReps>
__global__ void __launch_bounds__(kThreads) gabor2d_first_kernel(
    const float* __restrict__ c, const float* __restrict__ w1,
    const float* __restrict__ b1, float* __restrict__ z1,
    float* __restrict__ a0, int n, int d, int h, float omega, float s2,
    int c_shared) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)n * h) return;
  if (kReps) {
    const size_t rep = blockIdx.y;
    if (!c_shared) c += rep * n * d;
    w1 += rep * d * 2 * h;
    b1 += rep * 2 * h;
    if (z1 != nullptr) z1 += rep * n * 2 * h;
    a0 += rep * n * 2 * h;
  }
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

// Hidden forward: z4 = a @ W2 + B2 (a n x 2h, W2 2h x 4h) over the quad
// tile of units unit0 .. unit0 + 15; z4 kept in zs (n x 4h) unless zs is
// null; a_out = Gabor-2D(z4) (n x 2h).  kVecA, kVecB, kPair:
// wire_tc.cuh:Access.  kReps: replica blockIdx.z, every operand at the
// replica's offsets.
template <bool kVecA, bool kVecB, bool kPair, bool kReps>
__global__ void __launch_bounds__(wire_tc::kThreads, 2) gabor2d_tc_fwd_kernel(
    const float* __restrict__ a, const float* __restrict__ W2,
    const float* __restrict__ B2, float* __restrict__ zs,
    float* __restrict__ a_out, int n, int h, float omega, float s2) {
  using namespace wire_tc;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int unit0 = blockIdx.x * kQuadUnits;
  const int row0 = blockIdx.y * kBM;
  if (kReps) {
    a += (size_t)blockIdx.z * n * 2 * h;
    W2 += (size_t)blockIdx.z * 2 * h * 4 * h;
  }
  float acc[kMT][kNT][4];
  tile_product<kQuad, kVecA, kVecB>(smem, a, W2, 4 * h, n, 2 * h, row0,
                                    unit0, h, acc);
  if (kReps) {
    const size_t rep = blockIdx.z;
    B2 += rep * 4 * h;
    if (zs != nullptr) zs += rep * n * 4 * h;
    a_out += rep * n * 2 * h;
  }

  // n8 tile c holds channel c; accumulators 2 hr, 2 hr + 1: row g + 8 hr,
  // units j, j + 1
  const int g = lane / 4, t = lane % 4;
  const int j = unit0 + wn * 8 + 2 * t;
  if (j >= h) return;
  const bool two = j + 1 < h;
  float2 b[kNT];
#pragma unroll
  for (int c = 0; c < kNT; ++c) b[c] = load2<kPair>(B2 + c * h + j, two);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = row0 + wm * (kMT * 16) + mt * 16 + g + hr * 8;
      if (r >= n) continue;
      float2 z[kNT];
#pragma unroll
      for (int c = 0; c < kNT; ++c)
        z[c] = make_float2(acc[mt][c][2 * hr] + b[c].x,
                           acc[mt][c][2 * hr + 1] + b[c].y);
      if (zs != nullptr) {
        float* zr = zs + (size_t)r * 4 * h;
#pragma unroll
        for (int c = 0; c < kNT; ++c) store2<kPair>(zr + c * h + j, z[c], two);
      }
      float2 ar, ai;
      gabor2d(z[0].x, z[1].x, z[2].x, z[3].x, omega, s2, &ar.x, &ai.x);
      gabor2d(z[0].y, z[1].y, z[2].y, z[3].y, omega, s2, &ar.y, &ai.y);
      float* ap = a_out + (size_t)r * 2 * h;
      store2<kPair>(ap + j, ar, two);
      store2<kPair>(ap + h + j, ai, two);
    }
}

// Data gradient: da = D @ Bt (D n x K, Bt K x 2h) over the paired tile of
// units unit0 .. unit0 + 31, followed by the activation-form Gabor-2D
// backward with the layer's output act (n x 2h):
//   kBwdHidden: zin = the layer's z4 (n x 4h); out = dz4 (n x 4h)
//   kBwdFirst:  zin = z1 (n x 2h); out = dz1 = [dlr1 | dor1] (n x 2h)
// kReps: replica blockIdx.z, every operand at the replica's offsets.
template <int kEpi, bool kVecA, bool kVecB, bool kPair, bool kReps>
__global__ void __launch_bounds__(wire_tc::kThreads, 2) gabor2d_tc_bwd_kernel(
    const float* __restrict__ D, const float* __restrict__ Bt,
    const float* __restrict__ act, const float* __restrict__ zin,
    float* __restrict__ out, int n, int K, int h, float omega, float s2) {
  using namespace wire_tc;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int unit0 = blockIdx.x * kUnits;
  const int row0 = blockIdx.y * kBM;
  if (kReps) {
    D += (size_t)blockIdx.z * n * K;
    Bt += (size_t)blockIdx.z * K * 2 * h;
  }
  float acc[kMT][kNT][4];
  tile_product<kPaired, kVecA, kVecB>(smem, D, Bt, 2 * h, n, K, row0, unit0,
                                      h, acc);
  if (kReps) {
    const size_t rep = blockIdx.z;
    const size_t wide = (size_t)n * (kEpi == kBwdHidden ? 4 : 2) * h;
    act += rep * n * 2 * h;
    zin += rep * wide;
    out += rep * wide;
  }

  const int g = lane / 4, t = lane % 4;
  constexpr int kHalf = kNT / 2;
  const float m2s2 = -2.f * s2;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kHalf; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        // n8 tiles nt, nt + kHalf: the re and im of units j, j + 1;
        // accumulators 2 hr, 2 hr + 1: row g + 8 hr
        const int r = row0 + wm * (kMT * 16) + mt * 16 + g + hr * 8;
        const int j = unit0 + wn * (kHalf * 8) + nt * 8 + 2 * t;
        if (r >= n || j >= h) continue;
        const bool two = j + 1 < h;
        const float2 dar = make_float2(acc[mt][nt][2 * hr],
                                       acc[mt][nt][2 * hr + 1]);
        const float2 dai = make_float2(acc[mt][nt + kHalf][2 * hr],
                                       acc[mt][nt + kHalf][2 * hr + 1]);
        const float* ap = act + (size_t)r * 2 * h;
        const float2 ar = load2<kPair>(ap + j, two);
        const float2 ai = load2<kPair>(ap + h + j, two);
        const float2 t1 = make_float2(dar.x * ar.x + dai.x * ai.x,
                                      dar.y * ar.y + dai.y * ai.y);
        const float2 t2 = make_float2(dai.x * ar.x - dar.x * ai.x,
                                      dai.y * ar.y - dar.y * ai.y);
        if (kEpi == kBwdHidden) {
          const float* z = zin + (size_t)r * 4 * h;
          float* o = out + (size_t)r * 4 * h;
          const float2 lr = load2<kPair>(z + j, two);
          const float2 li = load2<kPair>(z + h + j, two);
          const float2 orr = load2<kPair>(z + 2 * h + j, two);
          const float2 oi = load2<kPair>(z + 3 * h + j, two);
          store2<kPair>(o + j,
                        make_float2(m2s2 * lr.x * t1.x + omega * t2.x,
                                    m2s2 * lr.y * t1.y + omega * t2.y),
                        two);
          store2<kPair>(o + h + j,
                        make_float2((-omega + m2s2 * li.x) * t1.x,
                                    (-omega + m2s2 * li.y) * t1.y),
                        two);
          store2<kPair>(o + 2 * h + j,
                        make_float2(m2s2 * orr.x * t1.x, m2s2 * orr.y * t1.y),
                        two);
          store2<kPair>(o + 3 * h + j,
                        make_float2(m2s2 * oi.x * t1.x, m2s2 * oi.y * t1.y),
                        two);
        } else {
          const float* z = zin + (size_t)r * 2 * h;
          float* o = out + (size_t)r * 2 * h;
          const float2 lr = load2<kPair>(z + j, two);
          const float2 orr = load2<kPair>(z + h + j, two);
          store2<kPair>(o + j,
                        make_float2(m2s2 * lr.x * t1.x + omega * t2.x,
                                    m2s2 * lr.y * t1.y + omega * t2.y),
                        two);
          store2<kPair>(o + h + j,
                        make_float2(m2s2 * orr.x * t1.x, m2s2 * orr.y * t1.y),
                        two);
        }
      }
}

// The launches of the two: the kernel instance for the shapes' and
// pointers' accesses, with the loop's dynamic shared memory; kReps: `reps`
// replicas in blockIdx.z.
template <bool kReps>
auto fwd_instance(const wire_tc::Access& a) {
  return wire_tc::instance(a, [](auto va, auto vb, auto pr) {
    return &gabor2d_tc_fwd_kernel<decltype(va)::value, decltype(vb)::value,
                                  decltype(pr)::value, kReps>;
  });
}

cudaError_t tc_forward(const float* a, const float* W2, const float* B2,
                       float* zs, float* a_out, int n, int h, float omega,
                       float s2, cudaStream_t st, int reps) {
  const dim3 grid(ceil_div(h, wire_tc::kQuadUnits), ceil_div(n, wire_tc::kBM),
                  reps);
  const wire_tc::Access ac = wire_tc::access(a, W2, 2 * h, h, {B2, zs, a_out});
  auto kernel = reps > 1 ? fwd_instance<true>(ac) : fwd_instance<false>(ac);
  GEMM_CHECK(cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  wire_tc::kSmemBytes));
  kernel<<<grid, wire_tc::kThreads, wire_tc::kSmemBytes, st>>>(
      a, W2, B2, zs, a_out, n, h, omega, s2);
  return cudaGetLastError();
}

template <int kEpi, bool kReps>
auto bwd_instance(const wire_tc::Access& a) {
  return wire_tc::instance(a, [](auto va, auto vb, auto pr) {
    return &gabor2d_tc_bwd_kernel<kEpi, decltype(va)::value,
                                  decltype(vb)::value, decltype(pr)::value,
                                  kReps>;
  });
}

template <int kEpi>
cudaError_t tc_backward(const float* D, const float* Bt, const float* act,
                        const float* zin, float* out, int n, int K, int h,
                        float omega, float s2, cudaStream_t st, int reps) {
  const dim3 grid(ceil_div(h, wire_tc::kUnits), ceil_div(n, wire_tc::kBM),
                  reps);
  const wire_tc::Access ac = wire_tc::access(D, Bt, K, h, {act, zin, out});
  auto kernel = reps > 1 ? bwd_instance<kEpi, true>(ac)
                         : bwd_instance<kEpi, false>(ac);
  GEMM_CHECK(cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  wire_tc::kSmemBytes));
  kernel<<<grid, wire_tc::kThreads, wire_tc::kSmemBytes, st>>>(
      D, Bt, act, zin, out, n, K, h, omega, s2);
  return cudaGetLastError();
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
// zs (L, n, 4h) (for reps replicas, the layouts of the header comment).
// With `pingpong` (z1 and zs null, acts two (reps, n, 2h) planes) nothing
// is kept for a backward: layer l writes plane (l + 1) % 2, so the last
// activation is plane L % 2.
cudaError_t forward_hidden(const float* coords, const float* w1,
                           const float* b1, const float* W2,
                           const float* B2, float* acts, float* zs,
                           float* z1, int n, int d, int h, int L,
                           float omega0, float s2, float first_omega0,
                           cudaStream_t st, bool pingpong, int reps,
                           int coords_shared) {
  const size_t act_sz = (size_t)reps * n * 2 * h;
  const size_t z_sz = (size_t)reps * n * 4 * h;
  const size_t w_sz = (size_t)reps * 2 * h * 4 * h;
  auto first = reps > 1 ? gabor2d_first_kernel<true>
                        : gabor2d_first_kernel<false>;
  first<<<dim3(ceil_div((long long)n * h, kThreads), reps), kThreads, 0,
          st>>>(coords, w1, b1, z1, acts, n, d, h, first_omega0, s2,
                coords_shared);
  GEMM_CHECK(cudaGetLastError());
  for (int l = 0; l < L; ++l) {
    const size_t in = pingpong ? l % 2 : l;
    const size_t out = pingpong ? (l + 1) % 2 : l + 1;
    GEMM_CHECK(tc_forward(acts + in * act_sz, W2 + l * w_sz,
                          B2 + (size_t)l * reps * 4 * h,
                          pingpong ? nullptr : zs + l * z_sz,
                          acts + out * act_sz, n, h, omega0, s2, st, reps));
  }
  return cudaSuccess;
}

// The backward from the output cotangent g (n x o) to every weight
// gradient: gfW (2h + 1, o) = [dfW; dfb], gW2 (L, 2h + 1, 4h) = [dW2; dB2],
// gw1 (d + 1, 2h) = [dw1; db1]; dz1 (n x 2h) is left holding dL/dz1.
// Scratch: dz (min(L, 2) planes of n x 4h), part (wire2d_part_floats).  For
// reps replicas, the layouts of the header comment.
cudaError_t backward(const float* coords, const float* g, const float* W2T,
                     const float* fWT, const float* acts, const float* zs,
                     const float* z1, float* gw1, float* gW2, float* gfW,
                     float* dz, float* dz1, float* part, int n, int d, int h,
                     int o, int L, float omega0, float s2,
                     float first_omega0, cudaStream_t st, int reps,
                     int coords_shared) {
  const int h2 = 2 * h, h4 = 4 * h;
  const size_t act_sz = (size_t)reps * n * h2;
  const size_t z_sz = (size_t)reps * n * h4;
  const size_t w_sz = (size_t)reps * h4 * h2;
  GEMM_CHECK(wire_tc::narrow_weight_grad(acts + L * act_sz, g, part, gfW, n,
                                         h2, o, st, nullptr, reps));
  const float* dsrc = g;
  const float* bt = fWT;
  int kdim = o;
  int cur = 0;
  for (int l = L - 1; l >= 0; --l) {
    float* dzl = dz + cur * z_sz;
    GEMM_CHECK(tc_backward<kBwdHidden>(dsrc, bt, acts + (l + 1) * act_sz,
                                       zs + l * z_sz, dzl, n, kdim, h, omega0,
                                       s2, st, reps));
    GEMM_CHECK(wire_tc::weight_grad(
        acts + l * act_sz, dzl, part,
        gW2 + (size_t)l * reps * (h2 + 1) * h4, n, h2, h4, st, nullptr,
        reps));
    dsrc = dzl;
    bt = W2T + l * w_sz;
    kdim = h4;
    cur ^= 1;
  }
  GEMM_CHECK(tc_backward<kBwdFirst>(dsrc, bt, acts, z1, dz1, n, kdim, h,
                                    first_omega0, s2, st, reps));
  return wire_tc::narrow_weight_grad(coords, dz1, part, gw1, n, d, h2, st,
                                     nullptr, reps, coords_shared);
}

}  // namespace

extern "C" {

// Floats of the `part` workspace for shapes (n, d, h, o): the largest of
// the weight gradients' chunk partials (the hidden layers' 1,024-row
// chunks, the first and final layers' 512-row ones) and the step's SSE
// partials (they use it one after the other).
long long wire2d_part_floats(int n, int d, int h, int o) {
  long long need = wire_tc::wgrad_part_floats(n, 2 * h, 4 * h);
  const long long first = wire_tc::narrow_part_floats(n, d, 2 * h);
  const long long final = wire_tc::narrow_part_floats(n, 2 * h, o);
  const long long sse = 2LL * final_loss_blocks(n);
  for (const long long e : {first, final, sse})
    if (e > need) need = e;
  return need;
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
// For reps replicas every tensor holds reps (the layouts of the header
// comment; part reps x wire2d_part_floats); coords_shared: one (n, d)
// coordinate tensor for all, t_shared: one (n, o) target and gt for all.
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
                    int want_metrics, int reps, int coords_shared,
                    int t_shared, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float s2 = sigma0 * sigma0;
  GEMM_CHECK(forward_hidden(coords, w1, b1, W2, B2, acts, zs, z1, n, d, h, L,
                            omega0, s2, first_omega0, st, false, reps,
                            coords_shared));
  GEMM_CHECK(final_loss(acts + (size_t)L * reps * n * 2 * h, fW, fb, target,
                        gt, pred, g, sse, part, n, 2 * h, o, nvalid,
                        two_inv_denom, want_metrics, st, reps, t_shared));
  return backward(coords, g, W2T, fWT, acts, zs, z1, gw1, gW2, gfW, dz, dz1,
                  part, n, d, h, o, L, omega0, s2, first_omega0, st, reps,
                  coords_shared);
}

// The pair's forward, keeping what the backward reads: pred (n, o);
// acts (L + 1, n, 2h), zs (L, n, 4h), z1 (n, 2h).  For reps replicas as
// the step's.
int wire2d_forward(const float* coords, const float* w1, const float* b1,
                   const float* W2, const float* B2, const float* fW,
                   const float* fb, float* pred, float* acts, float* zs,
                   float* z1, int n, int d, int h, int o, int L, float omega0,
                   float sigma0, float first_omega0, int reps,
                   int coords_shared, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float s2 = sigma0 * sigma0;
  GEMM_CHECK(forward_hidden(coords, w1, b1, W2, B2, acts, zs, z1, n, d, h, L,
                            omega0, s2, first_omega0, st, false, reps,
                            coords_shared));
  return final_forward(acts + (size_t)L * reps * n * 2 * h, fW, fb, pred, n,
                       2 * h, o, st, reps);
}

// The forward alone, keeping nothing (no input needs a gradient): the chain
// runs through pingpong (2, n, 2h) ((2, reps, n, 2h) for reps replicas).
int wire2d_forward_nograd(const float* coords, const float* w1,
                          const float* b1, const float* W2, const float* B2,
                          const float* fW, const float* fb, float* pred,
                          float* pingpong, int n, int d, int h, int o, int L,
                          float omega0, float sigma0, float first_omega0,
                          int reps, int coords_shared, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float s2 = sigma0 * sigma0;
  GEMM_CHECK(forward_hidden(coords, w1, b1, W2, B2, pingpong, nullptr,
                            nullptr, n, d, h, L, omega0, s2, first_omega0, st,
                            true, reps, coords_shared));
  return final_forward(pingpong + (size_t)(L % 2) * reps * n * 2 * h, fW, fb,
                       pred, n, 2 * h, o, st, reps);
}

// The pair's backward from g = dL/dpred (n, o), reading the forward's
// activations.  w1 (d, 2h) for dcoords; W2T (L, 4h, 2h); fWT (o, 2h).
// Outputs: gw1 (d + 1, 2h), gW2 (L, 2h + 1, 4h), gfW (2h + 1, o); dcoords
// (n, d), or null when no coordinate gradient is wanted (its kernel is then
// not launched).  Scratch: dz (min(L, 2), n, 4h), dz1 (n, 2h), part.  For
// reps replicas as the step's; dcoords must then be null.
int wire2d_backward(const float* coords, const float* g, const float* w1,
                    const float* W2T, const float* fWT, const float* acts,
                    const float* zs, const float* z1, float* gw1, float* gW2,
                    float* gfW, float* dcoords, float* dz, float* dz1,
                    float* part, int n, int d, int h, int o, int L,
                    float omega0, float sigma0, float first_omega0, int reps,
                    int coords_shared, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float s2 = sigma0 * sigma0;
  if (dcoords != nullptr && reps != 1) return cudaErrorInvalidValue;
  GEMM_CHECK(backward(coords, g, W2T, fWT, acts, zs, z1, gw1, gW2, gfW, dz,
                      dz1, part, n, d, h, o, L, omega0, s2, first_omega0,
                      st, reps, coords_shared));
  if (dcoords != nullptr) {
    gabor2d_dcoords_kernel<<<ceil_div(n, kFinalRowsPerBlock), kThreads, 0,
                             st>>>(dz1, w1, dcoords, n, d, 2 * h);
    GEMM_CHECK(cudaGetLastError());
  }
  return cudaSuccess;
}

}  // extern "C"
