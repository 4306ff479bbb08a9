// One WIRE train step (forward, masked-MSE loss gradient, backward, SSE
// metrics) for the complex-Gabor MLP, as a short sequence of hand-written
// fp32 kernels for Hopper (sm_90a).
//
// Replaces: wire_tpu/ops/pallas/wire_step.py:wire_step_fused (the one-pass
// Pallas train step).  Same math, same stacked complex layout:
//   z1 = c @ w1 + b1;  a0 = [e^{-s^2 z1^2} cos(w1 z1) | e^{-s^2 z1^2} sin(w1 z1)]
//   per hidden layer: z = a @ [[wr, wi], [-wi, wr]] + [br | bi]
//                     a = e^{-w zi - s^2 (zr^2 + zi^2)} [cos(w zr) | sin(w zr)]
//   y = a @ [fwr; -fwi] + fbr;  g = 2 mask (y - t) / denom,  mask = row < nvalid
// and the backward in activation form (wire_step.py:218-226), with weight
// and bias gradients summed over all rows and no dcoords.
//
// What bounds it: at the WIRE-300 shape (n = 65,536 rows, h = 212, L = 2)
// a step is ~142 GFLOP of fp32 multiply-adds in three (n x 424 x 424)
// products per hidden layer, against ~10 MB of inputs and outputs; it is
// bound by operations: ~2.1 ms at the card's 67 TFLOP/s fp32 peak on the
// CUDA cores, ~0.86 ms for the three TF32 products of each of them at the
// tensor cores' 495 TFLOP/s.
//
// What this design does about it: the step is wire_mlp.cu's forward and
// backward chains (wire_gemm.cuh) with the final layer, the loss gradient
// and the SSE sums fused between them (gemm_common.cuh:final_loss, one warp
// per row, a fixed butterfly).  The three products of every hidden layer
// run on the tensor cores at fp32 accuracy through wire_tc.cuh's 3xTF32
// mma.sync loop, the Gabor forward/backward in the paired products'
// epilogues, so activations are never re-read for a separate elementwise
// pass; the final layer's data gradient (a K of o) is a paired product on
// the same loop.  Weight gradients are fixed-order per-chunk partials
// summed in chunk order by a second pass, the bias gradient summed from the
// staged dz tiles (the first and final layers' in wire_tc.cuh's narrow
// kernel): no float atomics, so results are identical run to run.  The
// TPU kernel's sequential grid, VMEM accumulators and two-slot software
// pipeline do not carry over; live activations go to device scratch owned
// by the caller.  The step has no dcoords.
//
// Accuracy: 3xTF32 products (wire_tc.cuh: fp32's own distance from
// float64); sincosf/expf (not the __sinf/__expf intrinsics; phases w*z lie
// far outside [-pi, pi]).  Build without --use_fast_math.

#include "wire_gemm.cuh"

using namespace wire_gemm;

extern "C" {

// Floats needed by the `part` workspace for shapes (n, d, h, o): the
// backward chain's chunk partials or final_loss's SSE partials, whichever
// is larger (they use it one after the other).
long long wire_step_part_floats(int n, int d, int h, int o) {
  const long long need = chain_part_floats(n, d, h, o);
  const long long sse = 2LL * final_loss_blocks(n);
  return need > sse ? need : sse;
}

int wire_step_max_out() { return kMaxOut; }

const char* wire_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One train step.  Weights in the stacked layout (see wire_step.py):
//   w1 (d, h), b1 (h), Wh (L, 2h, 2h), WhT (L, 2h, 2h) = Wh transposed,
//   Bh (L, 2h), fW (2h, o), fWT (o, 2h), fb (o).
// Outputs: pred (n, o); gw1 (d + 1, h) = [dw1; db1];
//   gWh (L, 2h + 1, 2h) = [dW; dB] per layer; gfW (2h + 1, o) = [dfW; dfb];
//   sse (2) = (sse_target, sse_gt) when want_metrics.
// Scratch: acts (L + 1, n, 2h), zs (L, n, 2h), z1 (n, h), g (n, o),
//   dz (2, n, 2h), dz1 (n, h), part (wire_step_part_floats).
// Returns the first CUDA error of a launch (0 on success).  Launches on
// `stream` and does not synchronise.
int wire_step_run(const float* coords, const float* target, const float* gt,
                  const float* w1, const float* b1, const float* Wh,
                  const float* WhT, const float* Bh, const float* fW,
                  const float* fWT, const float* fb, float* pred, float* gw1,
                  float* gWh, float* gfW, float* sse, float* acts, float* zs,
                  float* z1, float* g, float* dz, float* dz1, float* part,
                  int n, int d, int h, int o, int L, int nvalid,
                  float two_inv_denom, float omega0, float sigma0,
                  float first_omega0, int want_metrics, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t act_sz = (size_t)n * 2 * h;
  const float s2 = sigma0 * sigma0;

  GEMM_CHECK(forward_chain(coords, w1, b1, Wh, Bh, acts, zs, z1, n, d, h, L,
                           omega0, s2, first_omega0, st, /*pingpong=*/false));
  GEMM_CHECK(final_loss(acts + L * act_sz, fW, fb, target, gt, pred, g, sse,
                        part, n, 2 * h, o, nvalid, two_inv_denom,
                        want_metrics, st));
  return backward_chain(coords, g, WhT, fWT, acts, zs, z1, gw1, gWh, gfW, dz,
                        dz1, part, n, d, h, o, L, omega0, s2, first_omega0,
                        st);
}

}  // extern "C"
