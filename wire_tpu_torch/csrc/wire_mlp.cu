// WIRE apply and its VJP (forward; backward from an external output
// cotangent, with dcoords) for the complex-Gabor MLP, as hand-written fp32
// kernels for Hopper (sm_90a).
//
// Replaces: wire_tpu/ops/pallas/wire_mlp.py:wire_mlp_fused (the forward
// Pallas call and the recompute-backward Pallas call of its custom VJP).
// Same math, stacked layout and chains as wire_step.cu (wire_gemm.cuh's
// forward_chain and backward_chain, shared by both):
//   forward:  y = real part of the complex final layer (n, o)
//   backward: from g = dL/dy (n, o) to every parameter gradient, with
//             dfinal.bi = 0 (the imaginary output is discarded), and
//             dcoords = dz1 @ w1^T (n, d), which the step kernel omits.
//
// What bounds it: operations.  At the CT shape (n = 65,536 rows, h = 212,
// L = 2, o = 1) forward + backward are ~142 GFLOP of fp32 multiply-adds
// (three n x 424 x 424 products per hidden layer) against ~3 MB of inputs
// and outputs: ~2.1 ms at the card's 67 TFLOP/s fp32 peak on the CUDA
// cores, ~0.86 ms for the three TF32 products of each of them at the
// tensor cores' 495 TFLOP/s.
//
// What this design does about it: the three products of every hidden
// layer (forward, data gradient, weight gradient) run on the tensor cores
// at fp32 accuracy through wire_tc.cuh's 3xTF32 mma.sync loop, with the
// Gabor forward/backward in the paired products' epilogues and the
// weight gradients as fixed-order per-chunk partials with the bias
// gradient summed from the staged dz tiles (no float atomics, so results
// repeat run to run).  The final layer's data gradient (a K of o) is a
// paired product on the same loop.  The first layer's forward (a K of
// d = 2) and the final layer's (o <= kMaxOut columns) stay on
// wire_gemm.cuh's and gemm_common.cuh's small CUDA-core kernels, and
// their weight gradients, one operand at most 8 wide, take wire_tc.cuh's
// memory-bound narrow kernel.  Unlike the TPU kernel, the backward does
// not recompute the forward: the forward keeps its activations (acts, zs,
// z1: (2L + 1.5) n 2h floats, 0.61 GB at the CT shape) in tensors the
// caller saves for the backward.  Recomputing would cost a third of the
// pair's FLOPs; writing and reading the saved activations moves ~1.2 GB
// (~0.4 ms at 3.35 TB/s) and the card has the memory.
//
// Without a gradient to take (inference, a render) the forward runs through
// two ping-pong activation planes and keeps nothing: 2 n 2h floats, 0.22 GB
// at the CT shape, instead of the 0.61 GB a backward needs.
//
// Accuracy: 3xTF32 products (wire_tc.cuh); sincosf/expf, no
// --use_fast_math.

#include "wire_gemm.cuh"

using namespace wire_gemm;

namespace {

// dcoords[r, k] = sum_j dz1[r, j] w1[k, j], j in order; one thread per
// (row, input feature).
__global__ void dcoords_kernel(const float* __restrict__ dz1,
                               const float* __restrict__ w1,
                               float* __restrict__ dc, int n, int d, int h) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)n * d) return;
  const size_t r = idx / d;
  const int k = (int)(idx % d);
  const float* row = dz1 + r * h;
  const float* w = w1 + (size_t)k * h;
  float s = 0.f;
  for (int j = 0; j < h; ++j) s = fmaf(row[j], w[j], s);
  dc[idx] = s;
}

}  // namespace

extern "C" {

// Floats needed by the backward's `part` workspace for shapes (n, d, h, o).
long long wire_mlp_part_floats(int n, int d, int h, int o) {
  return chain_part_floats(n, d, h, o);
}

int wire_mlp_max_out() { return kMaxOut; }

const char* wire_mlp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Forward.  Weights in the stacked layout (ops/wire_step.py:stack_params):
//   w1 (d, h), b1 (h), Wh (L, 2h, 2h), Bh (L, 2h), fW (2h, o), fb (o).
// Outputs: pred (n, o) and the activations the backward reads:
//   acts (L + 1, n, 2h), zs (L, n, 2h), z1 (n, h).
// Returns the first CUDA error of a launch (0 on success).  Launches on
// `stream` and does not synchronise.
int wire_mlp_forward(const float* coords, const float* w1, const float* b1,
                     const float* Wh, const float* Bh, const float* fW,
                     const float* fb, float* pred, float* acts, float* zs,
                     float* z1, int n, int d, int h, int o, int L,
                     float omega0, float sigma0, float first_omega0,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float s2 = sigma0 * sigma0;
  GEMM_CHECK(forward_chain(coords, w1, b1, Wh, Bh, acts, zs, z1, n, d, h, L,
                           omega0, s2, first_omega0, st, /*pingpong=*/false));
  return final_forward(acts + (size_t)L * n * 2 * h, fW, fb, pred, n, 2 * h,
                       o, st);
}

// Forward that keeps nothing for a backward (no input needs a gradient):
// the chain runs through two ping-pong planes, pingpong (2, n, 2h), instead
// of acts, zs and z1.  Same arguments and result otherwise.
int wire_mlp_forward_nograd(const float* coords, const float* w1,
                            const float* b1, const float* Wh, const float* Bh,
                            const float* fW, const float* fb, float* pred,
                            float* pingpong, int n, int d, int h, int o,
                            int L, float omega0, float sigma0,
                            float first_omega0, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float s2 = sigma0 * sigma0;
  GEMM_CHECK(forward_chain(coords, w1, b1, Wh, Bh, pingpong, nullptr,
                           nullptr, n, d, h, L, omega0, s2, first_omega0, st,
                           /*pingpong=*/true));
  return final_forward(pingpong + (size_t)(L % 2) * n * 2 * h, fW, fb, pred,
                       n, 2 * h, o, st);
}

// Backward from g = dL/dpred (n, o), reading the forward's activations.
//   WhT (L, 2h, 2h) = Wh transposed per layer, fWT (o, 2h) = fW transposed,
//   w1 (d, h) for dcoords.
// Outputs: gw1 (d + 1, h) = [dw1; db1]; gWh (L, 2h + 1, 2h) = [dW; dB];
//   gfW (2h + 1, o) = [dfW; dfb]; dcoords (n, d), or null when the caller
//   needs no coordinate gradient (dcoords_kernel is then not launched).
// Scratch: dz (2, n, 2h), dz1 (n, h), part (wire_mlp_part_floats).
int wire_mlp_backward(const float* coords, const float* g, const float* w1,
                      const float* WhT, const float* fWT, const float* acts,
                      const float* zs, const float* z1, float* gw1,
                      float* gWh, float* gfW, float* dcoords, float* dz,
                      float* dz1, float* part, int n, int d, int h, int o,
                      int L, float omega0, float sigma0, float first_omega0,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float s2 = sigma0 * sigma0;
  GEMM_CHECK(backward_chain(coords, g, WhT, fWT, acts, zs, z1, gw1, gWh, gfW,
                            dz, dz1, part, n, d, h, o, L, omega0, s2,
                            first_omega0, st));
  if (dcoords != nullptr)
    dcoords_kernel<<<ceil_div((long long)n * d, kThreads), kThreads, 0,
                     st>>>(dz1, w1, dcoords, n, d, h);
  return cudaGetLastError();
}

}  // extern "C"
