// The canonical real trunk on wire_tc.cuh's 3xTF32 tensor-core loop: the
// forward and backward chains of real_mlp.cu (the apply/VJP pair and the
// one-pass step) and of mscale2_step.cu (every scale's trunk in one pass
// over the ns n rows stacked scale by scale), with a per-row gamma.
//
// Layer l (real_mlp.cu's header comment says what it computes):
//   z = a_prev W;  v = gamma_row (alpha z + beta);  a = B(v)
// and, backward from da = dL/da,
//   dv = gamma_row dB(v) da;  dW = a_prev^T (dv diag alpha);
//   dbeta = colsum(dv);  dalpha = colsum(z dv);  da_prev = dv (W diag alpha)^T
// with the bases and their explicit derivatives of real_chain.cuh.
//
// Which products run where:
// - every product of depth K > kNarrowK (the hidden layers' forward and data
//   gradients, K = 256 at the path's shape) runs wire_tc.cuh:tile_product
//   under the plain column map, and its epilogue works on the 128 x 64
//   accumulator tile in registers (real_tc_kernel): thread (warp, lane) holds
//   rows row0 + wm 64 + mt 16 + g + 8 hr and columns col0 + wn 32 + nt 8 +
//   2t + {0, 1} (ops/mscale2_step.py:epilogue_map models it), so a row's
//   gamma is read per row, gammas[r / rows_per_block]: a 128-row tile may
//   straddle two scales at ragged n;
// - the first layer's forward (K = d = 2) and the top layer's data gradient
//   (K = o = 3) fill under half of one k8 slice, so they run on the CUDA
//   cores (real_narrow_kernel: a lane per column, its weights in
//   registers), with the same epilogues, their products fp32 FMAs in k
//   order; both are memory-bound, and the K = 3 data gradient on the
//   tensor-core kernel takes about as long (tools/exp_real_tc.py);
// - the weight gradients: wire_tc::weight_grad (the tensor cores, fixed-
//   order 1,024-row chunk partials) where both sides are wider than
//   kNarrowK, else wire_tc::narrow_weight_grad (the first layer's, X = the
//   coordinates; the final layer's, D = the output cotangent); both scale
//   dW's rows by alpha after the chunk sums and give dbeta as their bias
//   row; dalpha is real_chain.cuh's fixed-order column sum of z dv.
// - dcoords = dv_0 (W_0 diag alpha_0)^T (n x d), the pair's coordinate
//   gradient, where asked for: dcoords_kernel on the CUDA cores, a thread per
//   (row, input feature) summing over the layer's columns in order (d is 2
//   on the B-spline paths, 26 under posenc).
// No float atomics: two calls give the same bits.  Accurate expf/sinf/cosf
// in the bases; build without --use_fast_math.
//
// Replicas (the batched multi-fit, `reps` models of one shape in one launch
// sequence): forward<true> and backward<true> take the replica in a grid
// axis of every launch (blockIdx.z of the layer kernels and the column
// sums; wire_tc.cuh's weight gradients and gemm_common.cuh's sums fold it
// in as they say).  Every per-layer tensor holds reps of its own, replica r
// at r times its size past the start: W[l] (reps, in_l, w_l), WaT[l] (reps,
// w_l, in_l), alpha[l] and beta[l] (reps, w_l), zs[l] and acts[l] (reps, n,
// w_l), gW[l] (reps, in_l + 1, w_l), galpha[l] (reps, w_l), g (reps, n, o),
// gWf (reps, w + 1, o), dv (2, reps, n, max w), zdv (reps, n, max w), part
// reps x part_floats; the coordinates x are (reps, n, d), or one (n, d)
// shared by all when x_shared; the codes and gammas are shared.  A replica's
// blocks do what an unbatched launch does, so its results are bit-equal to
// one.  The replica is a template flag (kReps) of the layer kernels: the
// unbatched chains (forward<false>, backward<false>, mscale2_step.cu's)
// take instances without the replica's offsets, whose code is the single
// model's.  No dcoords on the replica path.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "gemm_common.cuh"
#include "real_chain.cuh"
#include "wire_tc.cuh"

namespace real_tc {

using gemm_common::ceil_div;
using real_chain::Layer;
using real_chain::Shape;

// Products of depth at most kNarrowK, and weight gradients with a side at
// most that wide, run on the narrow CUDA-core kernels.
constexpr int kNarrowK = wire_tc::kNarrowMax;

// The epilogues' two modes (real_chain.cuh's): forward, data gradient.
using real_chain::kBwd;
using real_chain::kFwd;

__device__ __forceinline__ float row_gamma(const Layer& lay, int r) {
  return lay.gammas != nullptr ? lay.gammas[r / lay.rows_per_block] : 1.f;
}

// The bases of real_chain.cuh in the epilogues.  A thread's epilogue
// evaluates one per accumulator register (64 of them); with the whole basis
// switch (sinf's, cosf's and expf's slow paths among it) inlined at each,
// the tensor-core kernels were 12,000-14,000 SASS instructions long against
// 2,500-5,000 without a basis, and took twice the time (instruction fetch;
// tools/exp_real_tc.py).  So the code is chosen once per thread
// (with_basis): where all of a thread's columns share one piecewise basis
// (one basis kind per layer, as mscale_2's trunk has), its epilogue is an
// instance with that basis alone inlined; otherwise (sine, gauss, lane
// segments) each output calls its basis out of line, one copy each.
__device__ __noinline__ float far_value(int code, float v) {
  return real_chain::basis_value(code, v);
}

__device__ __noinline__ float far_deriv(int code, float v) {
  return real_chain::basis_deriv(code, v);
}

// B(v) (kFwd) or dB(v) (kBwd): basis kCode inlined, or with kCode = -1
// the basis `code` out of line.
template <int kMode, int kCode>
__device__ __forceinline__ float basis(int code, float v) {
  if constexpr (kCode >= 0)
    return kMode == kFwd ? real_chain::basis_value(kCode, v)
                         : real_chain::basis_deriv(kCode, v);
  return kMode == kFwd ? far_value(code, v) : far_deriv(code, v);
}

// f(std::integral_constant<int, code>) for the piecewise bases,
// f(std::integral_constant<int, -1>) for the rest (and code -1: mixed).
template <class F>
__device__ __forceinline__ void with_basis(int code, F&& f) {
  using namespace real_chain;
  switch (code) {
#define REAL_TC_INLINE(c)                   \
  case c:                                   \
    f(std::integral_constant<int, c>());    \
    return;
    REAL_TC_INLINE(kZero)
    REAL_TC_INLINE(kQspline)
    REAL_TC_INLINE(kCspline)
    REAL_TC_INLINE(kRelu)
    REAL_TC_INLINE(kSrelu)
    REAL_TC_INLINE(kIdentity)
#undef REAL_TC_INLINE
    default:
      f(std::integral_constant<int, -1>());
  }
}

// The epilogue of one output (row r, column c) of acc = A @ B:
//   kFwd: z = acc; v = gamma (alpha z + beta); out0 = z (unless null),
//         out1 = B(v)
//   kBwd: acc = da; z = zin; v as above; dv = gamma dB(v) da; out0 = dv,
//         out1 = z dv
template <int kMode, int kCode>
__device__ __forceinline__ void epilogue(float acc, float z_in, float al,
                                         float be, int code, float gm,
                                         float& o0, float& o1) {
  const float z = kMode == kFwd ? acc : z_in;
  const float v = gm * (al * z + be);
  if (kMode == kFwd) {
    o0 = z;
    o1 = basis<kFwd, kCode>(code, v);
  } else {
    const float dv = gm * (basis<kBwd, kCode>(code, v) * acc);
    o0 = dv;
    o1 = z * dv;
  }
}

// This thread's share of a 128 x 64 tile's epilogue: n8 tile nt holds
// columns j, j + 1 (j = col0 + wn 32 + nt 8 + 2t), its accumulators 2 hr,
// 2 hr + 1 row row0 + wm 64 + mt 16 + g + 8 hr.
template <int kMode, int kCode, bool kPair>
__device__ __forceinline__ void tile_epilogue(
    const float (&acc)[wire_tc::kMT][wire_tc::kNT][4],
    const float2 (&al)[wire_tc::kNT], const float2 (&be)[wire_tc::kNT],
    const int (&code)[wire_tc::kNT][2], const Layer& lay,
    const float* __restrict__ zin, float* __restrict__ out0,
    float* __restrict__ out1, int row0, int col0, int n, int N) {
  using namespace wire_tc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    // the backward's z of m16 tile mt's 16 outputs, all loaded before the
    // first is used
    float2 z[2][kNT];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int r = row0 + wm * (kMT * 16) + mt * 16 + g + hr * 8;
        const int j = col0 + tile_col<kPlain>(wn, nt) + 2 * t;
        z[hr][nt] = kMode == kBwd && r < n && j < N
                        ? load2<kPair>(zin + (size_t)r * N + j, j + 1 < N)
                        : make_float2(0.f, 0.f);
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = row0 + wm * (kMT * 16) + mt * 16 + g + hr * 8;
      if (r >= n) continue;
      const float gm = row_gamma(lay, r);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int j = col0 + tile_col<kPlain>(wn, nt) + 2 * t;
        if (j >= N) continue;
        const bool two = j + 1 < N;
        const size_t idx = (size_t)r * N + j;
        float2 o0, o1;
        epilogue<kMode, kCode>(acc[mt][nt][2 * hr], z[hr][nt].x, al[nt].x,
                               be[nt].x, code[nt][0], gm, o0.x, o1.x);
        epilogue<kMode, kCode>(acc[mt][nt][2 * hr + 1], z[hr][nt].y,
                               al[nt].y, be[nt].y, code[nt][1], gm, o0.y,
                               o1.y);
        if (out0 != nullptr) store2<kPair>(out0 + idx, o0, two);
        store2<kPair>(out1 + idx, o1, two);
      }
    }
  }
}

// The layer kernels' operands of replica blockIdx.z: A (n x K) unless
// a_shared, B (K x N).
__device__ __forceinline__ void replica_operands(
    const float* __restrict__& A, const float* __restrict__& B, int n, int K,
    int N, int a_shared) {
  const size_t rep = blockIdx.z;
  if (!a_shared) A += rep * n * K;
  B += rep * K * N;
}

// The epilogue's tensors of replica blockIdx.z: alpha and beta (N), zin,
// out0 and out1 (n x N).
__device__ __forceinline__ void replica_epilogue(
    Layer& lay, const float* __restrict__& zin, float* __restrict__& out0,
    float* __restrict__& out1, int n, int N) {
  const size_t rep = blockIdx.z;
  lay.alpha += rep * N;
  lay.beta += rep * N;
  if (zin != nullptr) zin += rep * n * N;
  if (out0 != nullptr) out0 += rep * n * N;
  out1 += rep * n * N;
}

// acc = A (n x K) @ B (K x N) over the 128 x 64 tile at (blockIdx.y kBM,
// blockIdx.x kBN) on the tensor cores, then the epilogue on the registers.
// kVecA, kVecB, kPair: wire_tc.cuh:Access.  kReps: replica blockIdx.z,
// every operand at the replica's offsets (A shared when a_shared).
template <int kMode, bool kVecA, bool kVecB, bool kPair, bool kReps>
__global__ void __launch_bounds__(wire_tc::kThreads, 2) real_tc_kernel(
    const float* __restrict__ A, const float* __restrict__ B, Layer lay,
    const float* __restrict__ zin, float* __restrict__ out0,
    float* __restrict__ out1, int n, int K, int N, int a_shared) {
  using namespace wire_tc;
  extern __shared__ __align__(16) float smem[];
  const int wn = (threadIdx.x / 32) % kWarpsN, t = threadIdx.x % 4;
  const int col0 = blockIdx.x * kBN;
  const int row0 = blockIdx.y * kBM;
  if (kReps) replica_operands(A, B, n, K, N, a_shared);
  float acc[kMT][kNT][4];
  tile_product<kPlain, kVecA, kVecB>(smem, A, B, N, n, K, row0, col0, N,
                                     acc);
  if (kReps) replica_epilogue(lay, zin, out0, out1, n, N);

  // this thread's 8 columns: their affine and basis codes; `one` the code
  // they all share (-1: none or mixed)
  float2 al[kNT], be[kNT];
  int code[kNT][2];
  int one = -2;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int j = col0 + tile_col<kPlain>(wn, nt) + 2 * t;
    const bool live = j < N, two = j + 1 < N;
    al[nt] = live ? load2<kPair>(lay.alpha + j, two) : make_float2(0.f, 0.f);
    be[nt] = live ? load2<kPair>(lay.beta + j, two) : make_float2(0.f, 0.f);
    code[nt][0] = live ? lay.codes[j] : 0;
    code[nt][1] = two ? lay.codes[j + 1] : 0;
    for (int e = 0; e < 2; ++e)
      if (j + e < N) one = one == -2 || one == code[nt][e] ? code[nt][e] : -1;
  }
  with_basis(one, [&](auto c) {
    tile_epilogue<kMode, decltype(c)::value, kPair>(
        acc, al, be, code, lay, zin, out0, out1, row0, col0, n, N);
  });
}

// acc = A (n x K) @ B (K x N) for a small K (<= kNarrowK), then the
// epilogue, on the CUDA cores: a warp takes 32 consecutive columns of
// kNarrowRows rows, one column per lane, and keeps the column's B, alpha,
// beta and basis code in registers; fp32 FMAs in k order.
constexpr int kNarrowRows = 64;

// kReps: as real_tc_kernel's.
template <int kMode, bool kReps>
__global__ void __launch_bounds__(gemm_common::kThreads) real_narrow_kernel(
    const float* __restrict__ A, const float* __restrict__ B, Layer lay,
    const float* __restrict__ zin, float* __restrict__ out0,
    float* __restrict__ out1, int n, int K, int N, int a_shared) {
  constexpr int kWarps = gemm_common::kThreads / 32;
  if (kReps) {
    replica_operands(A, B, n, K, N, a_shared);
    replica_epilogue(lay, zin, out0, out1, n, N);
  }
  const int c = blockIdx.x * 32 + threadIdx.x % 32;
  if (c >= N) return;
  float b[kNarrowK];
#pragma unroll
  for (int k = 0; k < kNarrowK; ++k)
    b[k] = k < K ? B[(size_t)k * N + c] : 0.f;
  const float al = lay.alpha[c], be = lay.beta[c];
  const int code = lay.codes[c];
  const int r0 = blockIdx.y * kNarrowRows + threadIdx.x / 32;
  const int r_end = min(n, (int)(blockIdx.y + 1) * kNarrowRows);
  with_basis(code, [&](auto cc) {
    for (int r = r0; r < r_end; r += kWarps) {
      const float* a = A + (size_t)r * K;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kNarrowK; ++k)
        if (k < K) acc = fmaf(a[k], b[k], acc);
      const size_t idx = (size_t)r * N + c;
      float o0, o1;
      epilogue<kMode, decltype(cc)::value>(
          acc, kMode == kBwd ? zin[idx] : 0.f, al, be, code,
          row_gamma(lay, r), o0, o1);
      if (out0 != nullptr) out0[idx] = o0;
      out1[idx] = o1;
    }
  });
}

// One layer's product and epilogue: the narrow kernel for K <= kNarrowK,
// else the tensor-core kernel instance for the shapes' and pointers'
// accesses; kReps: `reps` replicas in blockIdx.z (A shared when a_shared).
template <int kMode, bool kReps = false>
cudaError_t layer(const float* A, const float* B, const Layer& lay,
                  const float* zin, float* out0, float* out1, int n, int K,
                  int N, cudaStream_t st, int reps = 1, int a_shared = 0) {
  if (K <= kNarrowK) {
    const dim3 grid(ceil_div(N, 32), ceil_div(n, kNarrowRows), reps);
    real_narrow_kernel<kMode, kReps><<<grid, gemm_common::kThreads, 0, st>>>(
        A, B, lay, zin, out0, out1, n, K, N, a_shared);
    return cudaGetLastError();
  }
  const dim3 grid(ceil_div(N, wire_tc::kBN), ceil_div(n, wire_tc::kBM),
                  reps);
  auto kernel = wire_tc::instance(
      wire_tc::access(A, B, K, N, {lay.alpha, lay.beta, zin, out0, out1}),
      [](auto va, auto vb, auto pr) {
        return &real_tc_kernel<kMode, decltype(va)::value,
                               decltype(vb)::value, decltype(pr)::value,
                               kReps>;
      });
  GEMM_CHECK(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      wire_tc::kSmemBytes));
  kernel<<<grid, wire_tc::kThreads, wire_tc::kSmemBytes, st>>>(
      A, B, lay, zin, out0, out1, n, K, N, a_shared);
  return cudaGetLastError();
}

inline bool narrow_wgrad(int M, int N) {
  return M <= kNarrowK || N <= kNarrowK;
}

// [X^T D; colsum(D)] (the first M rows scaled by colscale when given) over
// n rows into out ((M + 1) x N), on the narrow or the tensor-core kernel;
// for `reps` replicas X (unless x_shared), D, part, out and colscale hold
// reps of their own.
inline cudaError_t weight_grad(const float* X, const float* D, float* part,
                               float* out, int n, int M, int N,
                               cudaStream_t st,
                               const float* colscale = nullptr,
                               int reps = 1, int x_shared = 0) {
  if (narrow_wgrad(M, N))
    return wire_tc::narrow_weight_grad(X, D, part, out, n, M, N, st,
                                       colscale, reps, x_shared);
  return wire_tc::weight_grad(X, D, part, out, n, M, N, st, colscale, reps,
                              x_shared);
}

inline long long wgrad_part_floats(int n, int M, int N) {
  return narrow_wgrad(M, N) ? wire_tc::narrow_part_floats(n, M, N)
                            : wire_tc::wgrad_part_floats(n, M, N);
}

// Floats of the `part` workspace that backward() needs: the largest of
// the weight gradients' chunk partials and the column sums'.
inline long long part_floats(const Shape& s) {
  const int n = s.n;
  long long need = wgrad_part_floats(n, s.out(s.L - 1), s.o());
  for (int l = 0; l < s.L; ++l) {
    const long long w = wgrad_part_floats(n, s.in(l), s.out(l));
    const long long c =
        (long long)ceil_div(n, gemm_common::kChunkRows) * s.out(l);
    need = w > need ? w : need;
    need = c > need ? c : need;
  }
  return need;
}

// dcoords[r, k] = sum_j dv[r, j] WaT[j, k] over the w columns, j in order:
// one thread per (row, input feature), fp32 FMAs on the CUDA cores.  WaT =
// (W_0 diag alpha_0)^T (w x d).  Any d; memory-bound (one read of dv).
__global__ void __launch_bounds__(gemm_common::kThreads) dcoords_kernel(
    const float* __restrict__ dv, const float* __restrict__ WaT,
    float* __restrict__ dc, int n, int d, int w) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)n * d) return;
  const size_t r = idx / d;
  const int k = (int)(idx % d);
  const float* row = dv + r * w;
  float s = 0.f;
  for (int j = 0; j < w; ++j) s = fmaf(row[j], WaT[(size_t)j * d + k], s);
  dc[idx] = s;
}

// Forward through the L activation layers: zs[l] and acts[l] (n x w_l).
// The final layer is the caller's.  kReps: `reps` replicas (the layouts of
// the header comment).
template <bool kReps = false>
inline cudaError_t forward(const Shape& s, const float* x,
                           const float* const* W, const float* const* alpha,
                           const float* const* beta,
                           const unsigned char* const* codes,
                           const float* gammas, int rows_per_block,
                           float* const* zs, float* const* acts,
                           cudaStream_t st, int reps = 1, int x_shared = 0) {
  for (int l = 0; l < s.L; ++l) {
    const float* a_prev = l == 0 ? x : acts[l - 1];
    GEMM_CHECK((layer<kFwd, kReps>(
        a_prev, W[l],
        real_chain::layer_of(alpha, beta, codes, gammas, rows_per_block, l),
        nullptr, zs[l], acts[l], s.n, s.in(l), s.out(l), st, reps,
        l == 0 ? x_shared : 0)));
  }
  return cudaSuccess;
}

// Backward from g = dL/dy (n x o) through the saved zs and acts:
//   gWf ((w_{L-1} + 1) x o) = [dWf; dbf];
//   gW[l] ((in_l + 1) x w_l) = [dW; dbeta];  galpha[l] (w_l);
//   dcoords (n x d) = dv_0 WaT[0] when not null.
// WaT[l] = (W_l diag(alpha_l))^T (w_l x in_l), WfT = Wf^T (o x w_{L-1}).
// Scratch: dv (2, n, max w), zdv (n, max w), part (part_floats).  kReps:
// `reps` replicas (the layouts of the header comment); dcoords must then be
// null.
template <bool kReps = false>
inline cudaError_t backward(const Shape& s, const float* x, const float* g,
                            const float* const* WaT,
                            const float* const* alpha,
                            const float* const* beta,
                            const unsigned char* const* codes,
                            const float* WfT, const float* gammas,
                            int rows_per_block, const float* const* zs,
                            const float* const* acts, float* const* gW,
                            float* const* galpha, float* gWf,
                            float* dcoords, float* dv, float* zdv,
                            float* part, cudaStream_t st, int reps = 1,
                            int x_shared = 0) {
  const int n = s.n, L = s.L;
  if (dcoords != nullptr && reps != 1) return cudaErrorInvalidValue;
  const size_t plane = (size_t)reps * n * s.max_width();
  GEMM_CHECK(weight_grad(acts[L - 1], g, part, gWf, n, s.out(L - 1), s.o(),
                         st, nullptr, reps));
  const float* src = g;
  const float* bt = WfT;
  int kdim = s.o();
  int cur = 0;
  for (int l = L - 1; l >= 0; --l) {
    float* dvl = dv + cur * plane;
    GEMM_CHECK((layer<kBwd, kReps>(
        src, bt,
        real_chain::layer_of(alpha, beta, codes, gammas, rows_per_block, l),
        zs[l], dvl, zdv, n, kdim, s.out(l), st, reps)));
    const float* a_prev = l == 0 ? x : acts[l - 1];
    GEMM_CHECK(weight_grad(a_prev, dvl, part, gW[l], n, s.in(l), s.out(l),
                           st, alpha[l], reps, l == 0 ? x_shared : 0));
    GEMM_CHECK(real_chain::column_sum(zdv, part, galpha[l], n, s.out(l), st,
                                      reps));
    src = dvl;
    bt = WaT[l];
    kdim = s.out(l);
    cur ^= 1;
  }
  if (dcoords != nullptr) {
    const long long outs = (long long)n * s.in(0);
    dcoords_kernel<<<ceil_div(outs, gemm_common::kThreads),
                     gemm_common::kThreads, 0, st>>>(src, bt, dcoords, n,
                                                     s.in(0), kdim);
    GEMM_CHECK(cudaGetLastError());
  }
  return cudaSuccess;
}

}  // namespace real_tc
