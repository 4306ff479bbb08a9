// The one-pass train step of bspline_mscale_2 under 'freq_combine', as
// hand-written fp32 kernels for Hopper (sm_90a).
//
// Replaces: wire_tpu/ops/pallas/mscale2_step.py:mscale2_step_fused (the
// Pallas call at :222): every scale's trunk, the freq_combine combiner, the
// masked-MSE loss gradient with nvalid and denom, the SSE sums against
// target and gt, and the whole backward, in one pass.  Same math.  The ns
// scales share one canonical trunk and differ by gamma_s = 1/s_s on every
// layer's v; the combiner mixes the scales per coordinate r:
//   u0 = f0 + sum_s y_s[r] F0_s;  u = relu(u0);  y = u F1 + f1;
//   e = (2 / denom) [r < nvalid] (y - t);
//   dF1 = u^T e, df1 = sum e;  du = (e F1^T) [u0 > 0];
//   dF0_s = y_s^T du, df0 = sum du;  dy_s = du F0_s^T,
// where F0_s are the o rows of F0 that scale s feeds ([scale 0's o rows |
// scale 1's | ...], the order of cat(y_1 .. y_ns)).  The trunk's gradients
// (W, alpha, beta, the final layer) sum over all ns n rows.
//
// What bounds it: operations.  At the path's shape (n = 65,536 coordinates,
// ns = 3, widths 2 -> 256 x 3 -> 3, combiner 9 -> 128 -> 3) a step is ns
// real_step trunks of 51.98 GFLOP each plus 0.60 GFLOP of combiner
// (3 x 2 n (ns o 128 + 128 o)): 156.5 GFLOP against ~5 MB of inputs and
// outputs, 2.34 ms at the card's 67 TFLOP/s fp32 peak, 0.95 ms as 3xTF32
// products at the tensor cores' 495 TFLOP/s.
//
// What this design does about it: three stages on one stream.
// (a) The trunk forward runs once over the ns n rows stacked scale by scale
//     (rows [s n, (s + 1) n) hold scale s) on real_tc.cuh's chain: the
//     hidden layers' products on wire_tc.cuh's 3xTF32 mma.sync loop with the
//     real epilogue in registers and a per-row gamma (a 128-row tile may
//     straddle two scales), the first layer (K = 2) on the CUDA cores,
//     keeping z and a of every layer (1.2 GB at the path's shape);
//     gemm_common.cuh's final layer gives y_stack (ns n x o).  No TPU
//     padding: no o -> 128 row blocks in F0, no lane-aligned widths.
// (b) combiner_kernel: one warp per coordinate row, its lanes over the 128
//     combiner units (four each), sums in a fixed shuffle butterfly.  It
//     writes pred, the SSE partials and dy_stack (ns n x o), the cotangent
//     of every scale's trunk, all from the masked e, so rows past nvalid
//     add nothing to any gradient of any scale block.  F0 and F1 sit in
//     shared memory.  The combiner's weight gradients are per-block partials
//     (warps meet in a fixed order in shared memory), summed in block order
//     by gemm_common.cuh's reduce_chunks: no float atomics.
// (c) The trunk backward from dy_stack, with the same gammas and without
//     dcoords, on real_tc.cuh's chain: the hidden data gradients on the
//     tensor-core loop, the top layer's (K = o = 3) on the CUDA cores, the
//     weight gradients as fixed-order chunk partials over all ns n rows.
// Keeping the scales' trunks on chip instead of round-tripping z and a
// through device memory is later work.

#include "real_tc.cuh"

using namespace gemm_common;

namespace {

constexpr int kHidden = 128;            // the combiner's hidden width
constexpr int kPerLane = kHidden / 32;  // hidden units per lane
constexpr int kMaxCat = 16;             // ns * o at most
constexpr int kCombMaxOut = 4;          // o at most
constexpr int kCombRows = 256;          // coordinate rows per block
constexpr int kCombWarps = kThreads / 32;
constexpr int kRowsPerWarp = kCombRows / kCombWarps;

// Floats of one block's weight-gradient partial: [dF0; df0] ((cat + 1) x
// 128), then [dF1; df1] ((128 + 1) x o).
inline int comb_grad_floats(int cat, int o) {
  return (cat + 1) * kHidden + (kHidden + 1) * o;
}

inline int comb_blocks(int n) { return ceil_div(n, kCombRows); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stage (b) over n coordinate rows: y_stack and dy_stack are (ns n x o);
// part receives this block's (cat + 1) x 128 + 129 x o gradient partial at
// blockIdx.x * comb_grad_floats, sse_part its two SSE sums.
__global__ void __launch_bounds__(kThreads) combiner_kernel(
    const float* __restrict__ ystack, const float* __restrict__ F0,
    const float* __restrict__ f0, const float* __restrict__ F1,
    const float* __restrict__ f1, const float* __restrict__ t,
    const float* __restrict__ gt, float* __restrict__ pred,
    float* __restrict__ dystack, float* __restrict__ part,
    float* __restrict__ sse_part, int n, int ns, int o, int nvalid,
    float two_inv_denom) {
  __shared__ float F0s[kMaxCat][kHidden];
  __shared__ float F1s[kHidden][kCombMaxOut];
  __shared__ float f0s[kHidden];
  __shared__ float f1s[kCombMaxOut];
  __shared__ float acc[(kMaxCat + 1) * kHidden + (kHidden + 1) * kCombMaxOut];
  __shared__ float warp_sse[kCombWarps][2];
  const int cat = ns * o;
  const int E0 = (cat + 1) * kHidden;
  const int E = E0 + (kHidden + 1) * o;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < cat * kHidden; i += kThreads)
    F0s[i / kHidden][i % kHidden] = F0[i];
  for (int i = threadIdx.x; i < kHidden * o; i += kThreads)
    F1s[i / o][i % o] = F1[i];
  for (int i = threadIdx.x; i < kHidden; i += kThreads) f0s[i] = f0[i];
  if ((int)threadIdx.x < o) f1s[threadIdx.x] = f1[threadIdx.x];
  for (int i = threadIdx.x; i < E; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  float gF0[kMaxCat][kPerLane], gF1[kPerLane][kCombMaxOut];
  float gf0[kPerLane], gf1[kCombMaxOut];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    gf0[q] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCat; ++c) gF0[c][q] = 0.f;
#pragma unroll
    for (int c = 0; c < kCombMaxOut; ++c) gF1[q][c] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < kCombMaxOut; ++c) gf1[c] = 0.f;
  float st = 0.f, sg = 0.f;

  for (int it = 0; it < kRowsPerWarp; ++it) {
    const int r = blockIdx.x * kCombRows + warp * kRowsPerWarp + it;
    if (r >= n) break;
    float ycat[kMaxCat];
#pragma unroll
    for (int c = 0; c < kMaxCat; ++c)
      ycat[c] = c < cat ? ystack[((size_t)(c / o) * n + r) * o + c % o]
                        : 0.f;
    float u0[kPerLane], u[kPerLane];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int j = lane + 32 * q;
      float a = f0s[j];
#pragma unroll
      for (int c = 0; c < kMaxCat; ++c)
        if (c < cat) a = fmaf(ycat[c], F0s[c][j], a);
      u0[q] = a;
      u[q] = fmaxf(a, 0.f);
    }
    const bool valid = r < nvalid;
    float e[kCombMaxOut];
#pragma unroll
    for (int c = 0; c < kCombMaxOut; ++c) {
      e[c] = 0.f;
      if (c >= o) continue;
      float a = 0.f;
#pragma unroll
      for (int q = 0; q < kPerLane; ++q)
        a = fmaf(u[q], F1s[lane + 32 * q][c], a);
      const float y = warp_sum(a) + f1s[c];
      const size_t idx = (size_t)r * o + c;
      const float et = valid ? y - t[idx] : 0.f;
      const float eg = valid ? y - gt[idx] : 0.f;
      e[c] = two_inv_denom * et;
      if (lane == 0) {
        pred[idx] = y;
        st += et * et;
        sg += eg * eg;
      }
    }
    float du[kPerLane];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int j = lane + 32 * q;
      float a = 0.f;
#pragma unroll
      for (int c = 0; c < kCombMaxOut; ++c)
        if (c < o) a = fmaf(e[c], F1s[j][c], a);
      du[q] = u0[q] > 0.f ? a : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kMaxCat; ++c) {
      if (c >= cat) break;
      float a = 0.f;
#pragma unroll
      for (int q = 0; q < kPerLane; ++q)
        a = fmaf(du[q], F0s[c][lane + 32 * q], a);
      a = warp_sum(a);
      if (lane == 0) dystack[((size_t)(c / o) * n + r) * o + c % o] = a;
    }
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      gf0[q] += du[q];
#pragma unroll
      for (int c = 0; c < kMaxCat; ++c)
        if (c < cat) gF0[c][q] = fmaf(ycat[c], du[q], gF0[c][q]);
#pragma unroll
      for (int c = 0; c < kCombMaxOut; ++c)
        if (c < o) gF1[q][c] = fmaf(u[q], e[c], gF1[q][c]);
    }
#pragma unroll
    for (int c = 0; c < kCombMaxOut; ++c) gf1[c] += e[c];
  }

  // the warps' partials meet in warp order
  for (int w = 0; w < kCombWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int j = lane + 32 * q;
#pragma unroll
        for (int c = 0; c < kMaxCat; ++c)
          if (c < cat) acc[c * kHidden + j] += gF0[c][q];
        acc[cat * kHidden + j] += gf0[q];
#pragma unroll
        for (int c = 0; c < kCombMaxOut; ++c)
          if (c < o) acc[E0 + j * o + c] += gF1[q][c];
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kCombMaxOut; ++c)
          if (c < o) acc[E0 + kHidden * o + c] += gf1[c];
        warp_sse[w][0] = st;
        warp_sse[w][1] = sg;
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < E; i += kThreads)
    part[(size_t)blockIdx.x * E + i] = acc[i];
  if (threadIdx.x == 0) {
    float s0 = 0.f, s1 = 0.f;
    for (int w = 0; w < kCombWarps; ++w) {
      s0 += warp_sse[w][0];
      s1 += warp_sse[w][1];
    }
    sse_part[2 * blockIdx.x] = s0;
    sse_part[2 * blockIdx.x + 1] = s1;
  }
}

}  // namespace

extern "C" {

int mscale2_max_cat() { return kMaxCat; }
int mscale2_max_out() { return kCombMaxOut; }
int mscale2_hidden() { return kHidden; }

const char* mscale2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of the trunk's `part` workspace for the ns n stacked rows.
long long mscale2_trunk_part_floats(int rows, int L, const int* widths) {
  return real_tc::part_floats(real_tc::Shape{rows, L, widths});
}

// Floats of the combiner's workspace: its per-block gradient partials,
// then two SSE partials per block.
long long mscale2_comb_part_floats(int n, int ns, int o) {
  return (long long)comb_blocks(n) * (comb_grad_floats(ns * o, o) + 2);
}

// One mscale_2 step over n coordinates and ns scales.  x (ns n x d): the
// coordinates stacked once per scale; gammas (ns): 1/s per scale; widths
// (L + 2): d, w_0 .. w_{L-1}, o; the trunk's W, WaT, alpha, beta, codes,
// Wf, WfT, bf as real_mlp.cu's real_step_run reads them; F0 (ns o x 128),
// f0 (128), F1 (128 x o), f1 (o); t, gt (n x o; gt may be null).  Outputs:
// pred (n x o), sse (2, when want_metrics), the trunk's gW, galpha, gWf as
// real_step_run's, gcomb = [dF0 (ns o x 128); df0 (128); dF1 (128 x o);
// df1 (o)].  Scratch: zs, acts (ns n x w_l each), ystack, dystack
// (ns n x o), dv (2, ns n, max w), zdv (ns n, max w), part
// (mscale2_trunk_part_floats), cpart (mscale2_comb_part_floats).  Pointer
// arrays on the host, tensors on the card.  Returns the first CUDA error of
// a launch (0 on success); launches on `stream`, does not synchronise.
int mscale2_step_run(int n, int ns, int L, const int* widths, const float* x,
                     const float* t, const float* gt, const float* const* W,
                     const float* const* WaT, const float* const* alpha,
                     const float* const* beta,
                     const unsigned char* const* codes, const float* Wf,
                     const float* WfT, const float* bf, const float* gammas,
                     const float* F0, const float* f0, const float* F1,
                     const float* f1, float* const* zs, float* const* acts,
                     float* ystack, float* dystack, float* pred, float* sse,
                     float* const* gW, float* const* galpha, float* gWf,
                     float* gcomb, float* cpart, float* dv, float* zdv,
                     float* part, int nvalid, float two_inv_denom,
                     int want_metrics, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = ns * n;
  real_tc::Shape s{rows, L, widths};
  const int o = s.o();
  if (n < 1 || ns < 1 || ns * o > kMaxCat || o > kCombMaxOut)
    return cudaErrorInvalidValue;
  // (a) every scale's trunk forward, then y_stack
  GEMM_CHECK(real_tc::forward(s, x, W, alpha, beta, codes, gammas, n, zs,
                              acts, st));
  GEMM_CHECK(final_forward(acts[L - 1], Wf, bf, ystack, rows, s.out(L - 1),
                           o, st));
  // (b) the combiner, the loss and the combiner's backward
  const int blocks = comb_blocks(n);
  const int E = comb_grad_floats(ns * o, o);
  float* sse_part = cpart + (size_t)blocks * E;
  combiner_kernel<<<blocks, kThreads, 0, st>>>(
      ystack, F0, f0, F1, f1, t, gt ? gt : t, pred, dystack, cpart, sse_part,
      n, ns, o, nvalid, two_inv_denom);
  GEMM_CHECK(cudaGetLastError());
  GEMM_CHECK(reduce_chunks(cpart, blocks, E, gcomb, st));
  if (want_metrics) {
    reduce_chunks_kernel<<<1, 32, 0, st>>>(sse_part, blocks, 2, sse, nullptr,
                                           1, 0);
    GEMM_CHECK(cudaGetLastError());
  }
  // (c) every scale's trunk backward, its gradients summed over all rows
  return real_tc::backward(s, x, dystack, WaT, alpha, beta, codes, WfT,
                           gammas, n, zs, acts, gW, galpha, gWf, nullptr,
                           dv, zdv, part, st);
}

}  // extern "C"
