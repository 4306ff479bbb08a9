// The canonical real MLP of every real INR family (siren, gauss, relu and
// posenc, the B-spline bases), as hand-written fp32 kernels for Hopper
// (sm_90a): the apply/VJP pair and the one-pass train step.
//
// Replaces: wire_tpu/ops/pallas/real_mlp.py:real_mlp_fused (the forward
// Pallas call and the recompute-backward Pallas call of its custom VJP,
// with dcoords and the optional per-row-block gamma of
// real_mlp_fused_scales) and real_step_fused (the one-pass step: forward,
// masked-MSE loss gradient with nvalid and denom, backward without dcoords,
// the SSE sums against target and gt).  Same math, per layer l:
//   z = a_prev @ W;  v = gamma (alpha z + beta);  a = B(v)   (gamma = 1
//   without row_gamma, else gammas[row / rows_per_block]); y = a @ Wf + bf;
// backward: dv = gamma dB(v) da;  dz = alpha dv;  dalpha = sum_rows z dv;
//   dbeta = sum_rows dv;  dW = a_prev^T dz;  da_prev = dz W^T.
// B and dB are _basis's functions with its explicit derivatives
// (real_mlp.py:47-105), chosen per column by a code byte, so one code path
// serves a uniform kind, lane segments (_basis_any) and columns past the
// segments (code 0: B = dB = 0).  The quadratic and cubic splines are
// evaluated in their piecewise-polynomial form, the same function as
// _basis's sums of shifted relu powers and exactly zero outside the
// support: the relu sums cancel terms of ~v^2/2 to zero for |v| > 1.5, and
// at the B-spline presets' alpha = 9.5 that leaves float32 rounding of
// ~1e-5 per unit, which two evaluation orders do not share.
//
// What bounds it: operations.  At the B-spline denoise shape (n = 65,536
// rows, widths 2 -> 256 -> 256 -> 256, o = 3) a step is 51.98 GFLOP of fp32
// multiply-adds (forward 17.35, weight gradients 17.35, data gradients of
// the hidden and final layers 17.28) against ~4 MB of inputs and outputs:
// 0.776 ms at the card's 67 TFLOP/s fp32 peak, 0.315 ms as 3xTF32 products
// at the tensor cores' 495 TFLOP/s.  The SISR pair (n = 28,224) is 22.41
// GFLOP with dcoords, 0.335 ms in fp32 and 0.136 ms as 3xTF32.
//
// What this design does about it: every chain runs real_tc.cuh's, the one
// mscale2_step.cu runs for its stacked trunks.
// - The hidden layers' products and data gradients (K = 256 on the paths;
//   every K > 8, posenc's first layer at d = 26 too) run wire_tc.cuh's
//   3xTF32 mma.sync loop on 128 x 64 tiles, each with its epilogue in
//   registers: the forward applies the affine, the per-row gamma and the
//   basis and writes z (unless the caller keeps nothing) and a; the data
//   gradient recomputes v from the saved z and writes dv and z dv.  The
//   first layer (K = d <= 8) and the top data gradient (K = o) run a narrow
//   CUDA-core kernel with the same epilogues.
// - dz = alpha dv is never stored: the next data gradient multiplies dv by
//   (W diag(alpha))^T, which the wrapper precomputes; the weight gradient
//   [a_prev | 1]^T dv comes out of wire_tc.cuh's fixed-order chunk partials
//   (the tensor cores where both sides are wider than 8, else the narrow
//   CUDA-core kernel) with its first rows scaled by alpha (dW) and its bias
//   row unscaled (dbeta); dalpha is real_chain.cuh's fixed-order column sum
//   of z dv; dcoords, where asked for, a fixed-order sum over the first
//   layer's columns.  No float atomics: results repeat run to run.
// - The final layer and the step's loss are gemm_common.cuh's (one warp per
//   row, a fixed butterfly), shared with the WIRE step.
// - Unlike the TPU kernels, nothing is recomputed: the pair's forward keeps
//   z and a of every layer for the backward (173 MB at the SISR shape) when
//   an input needs a gradient, and otherwise runs through two ping-pong
//   activation planes and keeps nothing; the step keeps them in scratch the
//   caller reuses (403 MB at the denoise shape).  The TPU's two-tile
//   software pipeline and VMEM accumulators do not carry over.
// This file holds the C entry points.
//
// Accuracy: 3xTF32 products (wire_tc.cuh); sincosf/expf (not the
// __sinf/__expf intrinsics: siren's phases are omega0 = 30 times z); the
// TPU kernel's fast_sincos polynomial was a Mosaic workaround.  Build
// without --use_fast_math.
//
// Replicas (wire_tpu's fit_pointwise_many, fit_operator_many and
// fit_frames_many, which vmap these Pallas calls): each entry point takes
// `reps` models of one shape, each on its own weights and its own or the
// shared coordinates (and targets), through the same launches with a
// replica grid axis (real_tc.cuh's layouts); nvalid and denom are shared.
// A replica's results are bit-equal to an unbatched call on its inputs;
// reps = 1 is that call, through the chains' single-model instances.  The
// replica backward computes no dcoords (the batched fits' coordinates are
// constants).

#include "real_tc.cuh"

using namespace gemm_common;
using namespace real_chain;

extern "C" {

int real_mlp_max_out() { return kMaxOut; }

const char* real_mlp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Basis code of each name, so the wrapper can check that it agrees.
int real_mlp_basis_code(const char* name) {
  const char* names[] = {"zero", "qspline", "cspline", "sine",
                         "gauss", "relu", "srelu", "identity"};
  for (int i = 0; i < 8; ++i) {
    const char* a = names[i];
    const char* b = name;
    while (*a && *a == *b) ++a, ++b;
    if (*a == 0 && *b == 0) return i;
  }
  return -1;
}

// Floats of the `part` workspace of the backward and the step, for n rows
// and widths (L + 2 entries: d, w_0 .. w_{L-1}, o), per replica: the
// backward's weight gradient and column sum partials, or the step's SSE
// partials where they are more.
long long real_mlp_part_floats(int n, int L, const int* widths) {
  const long long need = real_tc::part_floats(Shape{n, L, widths});
  const long long sse = 2LL * final_loss_blocks(n);  // the step's SSE
  return need > sse ? need : sse;
}

// Forward of the pair: pred (n x o) = final(chain(x)).  Per layer l: W[l]
// (in_l x w_l), alpha[l], beta[l] (w_l), codes[l] (w_l bytes); Wf (w x o),
// bf (o); gammas (one per block of rows_per_block rows) or null.  acts[l]
// (n x w_l) receive the activations and zs[l] the pre-activations z, or
// nothing where zs[l] is null; acts may alternate between two planes when
// nothing is kept (a forward without a gradient to take).  Pointer arrays
// live on the host, the tensors on the card.  For reps replicas each
// tensor but the codes and gammas holds reps (real_tc.cuh's layouts; Wf
// (reps, w, o), bf (reps, o), pred (reps, n, o)); x_shared: one (n, d)
// coordinate set for all.  Returns the first CUDA error of a launch (0 on
// success); launches on `stream`, does not synchronise.
int real_mlp_forward(int n, int L, const int* widths, const float* x,
                     const float* const* W, const float* const* alpha,
                     const float* const* beta,
                     const unsigned char* const* codes, const float* Wf,
                     const float* bf, const float* gammas,
                     int rows_per_block, float* const* zs,
                     float* const* acts, float* pred, int reps,
                     int x_shared, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Shape s{n, L, widths};
  GEMM_CHECK(reps > 1 ? real_tc::forward<true>(s, x, W, alpha, beta, codes,
                                               gammas, rows_per_block, zs,
                                               acts, st, reps, x_shared)
                      : real_tc::forward<false>(s, x, W, alpha, beta, codes,
                                                gammas, rows_per_block, zs,
                                                acts, st));
  return final_forward(acts[L - 1], Wf, bf, pred, n, s.out(L - 1), s.o(),
                       st, reps);
}

// Backward of the pair from g = dL/dpred (n x o), reading the forward's zs
// and acts; see real_tc::backward for the outputs and the scratch.  For
// reps replicas as the forward's (part reps x real_mlp_part_floats);
// dcoords must then be null.
int real_mlp_backward(int n, int L, const int* widths, const float* x,
                      const float* g, const float* const* WaT,
                      const float* const* alpha, const float* const* beta,
                      const unsigned char* const* codes, const float* WfT,
                      const float* gammas, int rows_per_block,
                      const float* const* zs, const float* const* acts,
                      float* const* gW, float* const* galpha, float* gWf,
                      float* dcoords, float* dv, float* zdv, float* part,
                      int reps, int x_shared, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Shape s{n, L, widths};
  if (reps > 1)
    return real_tc::backward<true>(s, x, g, WaT, alpha, beta, codes, WfT,
                                   gammas, rows_per_block, zs, acts, gW,
                                   galpha, gWf, dcoords, dv, zdv, part, st,
                                   reps, x_shared);
  return real_tc::backward<false>(s, x, g, WaT, alpha, beta, codes, WfT,
                                  gammas, rows_per_block, zs, acts, gW,
                                  galpha, gWf, dcoords, dv, zdv, part, st);
}

// One train step: the forward (zs, acts kept in the caller's scratch), the
// final layer with g = two_inv_denom * mask (pred - t), mask = row < nvalid,
// and the SSE sums (sse (2): against t and gt, when want_metrics), then the
// backward without dcoords.  Arguments as for the pair; g (n x o) scratch.
// For reps replicas as the pair's, with t, gt, g (reps, n, o) and sse
// (reps, 2); t_shared: one (n, o) target and gt for all.
int real_step_run(int n, int L, const int* widths, const float* x,
                  const float* t, const float* gt, const float* const* W,
                  const float* const* WaT, const float* const* alpha,
                  const float* const* beta,
                  const unsigned char* const* codes, const float* Wf,
                  const float* WfT, const float* bf, float* const* zs,
                  float* const* acts, float* pred, float* g, float* sse,
                  float* const* gW, float* const* galpha, float* gWf,
                  float* dv, float* zdv, float* part, int nvalid,
                  float two_inv_denom, int want_metrics, int reps,
                  int x_shared, int t_shared, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Shape s{n, L, widths};
  if (reps > 1)
    GEMM_CHECK(real_tc::forward<true>(s, x, W, alpha, beta, codes, nullptr,
                                      1, zs, acts, st, reps, x_shared));
  else
    GEMM_CHECK(real_tc::forward<false>(s, x, W, alpha, beta, codes, nullptr,
                                       1, zs, acts, st));
  GEMM_CHECK(final_loss(acts[L - 1], Wf, bf, t, gt, pred, g, sse, part, n,
                        s.out(L - 1), s.o(), nvalid, two_inv_denom,
                        want_metrics, st, reps, t_shared));
  if (reps > 1)
    return real_tc::backward<true>(s, x, g, WaT, alpha, beta, codes, WfT,
                                   nullptr, 1, zs, acts, gW, galpha, gWf,
                                   nullptr, dv, zdv, part, st, reps,
                                   x_shared);
  return real_tc::backward<false>(s, x, g, WaT, alpha, beta, codes, WfT,
                                  nullptr, 1, zs, acts, gW, galpha, gWf,
                                  nullptr, dv, zdv, part, st);
}

}  // extern "C"
