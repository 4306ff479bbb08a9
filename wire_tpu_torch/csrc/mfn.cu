// The Gabor multiplicative filter network (MFN) as hand-written fp32
// kernels for Hopper (sm_90a): the apply/VJP pair and the one-pass train
// step.
//
// Replaces: wire_tpu/ops/pallas/mfn_step.py:mfn_mlp_fused (the forward
// Pallas call and the recompute-backward Pallas call of its custom VJP,
// with dcoords) and mfn_step_fused (the one-pass step: forward, masked-MSE
// loss gradient with nvalid and denom, backward without dcoords, the SSE
// sums against target and gt).  Same math, with k filters and x (n x d):
//   g_j(x) = E S,  E = exp(-gamma_j/2 nrm),  S = sin q,  C = cos q,
//   q = x w_j + b_j,  nrm = |x|^2 + |mu_j|^2 - 2 x mu_j^T (expanded form);
//   z_0 = g_0;  l_j = z_{j-1} W_{j-1} + c_{j-1};  z_j = l_j g_j;
//   y = z_{k-1} W_f + b_f.
// Backward from gy = dL/dy: dz_{k-1} = gy W_f^T; for j = k-1 .. 1:
//   dl_j = dz_j g_j, dg_j = dz_j l_j, [dW; dc]_{j-1} = [z_{j-1} | 1]^T dl_j,
//   dz_{j-1} = dl_j W_{j-1}^T; dg_0 = dz_0.  Per filter, from dg:
//   dq = dg E C, ges = dg E S, dn = -(gamma/2) ges;
//   db = colsum dq, dw = x^T dq, dgamma = -1/2 colsum(ges nrm),
//   dmu = 2 colsum(dn) mu - 2 dn^T x;
//   dcoords += dq w^T + 2 rowsum(dn) x - 2 dn mu.
//
// What bounds it: operations.  At the denoise shape (n = 65,536, d = 2,
// h = 300, k = 3, o = 3) a step is 72.07 GFLOP of fp32 multiply-adds: the
// two links' forward, weight-gradient and data-gradient products (70.78),
// the final layer's (0.35) and the filters' d-contractions (0.94), against
// ~4 MB of inputs and outputs: 1.08 ms at the card's 67 TFLOP/s fp32 peak,
// 0.44 ms as 3xTF32 products at the tensor cores' 495 TFLOP/s.  The SISR
// pair (n = 65,536, h = 256, dcoords) is 53.05 GFLOP, 0.32 ms as 3xTF32.
//
// What this design does about it:
// - Every link product of depth K > kNarrowK (the links' forward z W and
//   data gradient dl W^T, K = h) runs wire_tc.cuh:tile_product under the
//   plain column map (3xTF32 mma.sync at fp32 accuracy; h kept exact with
//   zero-filled tiles, not the TPU kernel's padding of 300 to 384) in
//   mfn_tc_kernel, whose epilogue works on the 128 x 64 accumulator tile
//   in registers: thread (warp, lane) holds rows row0 + wm 64 + mt 16 + g
//   + 8 hr and columns col0 + wn 32 + nt 8 + 2t + {0, 1}.  The forward
//   adds c and writes l_j (when kept) and z_j = l_j g_j; the backward
//   reads l_j per m16 tile before its first use and writes dl_j and dg_j.
// - g_j needs one expf and one sincosf per output, slow paths included (q
//   reaches the hundreds).  Inlined at each of a thread's 64 accumulator
//   registers that code would make the kernel several times longer (a
//   basis switch inlined so doubled mscale2_step's kernels,
//   tools/exp_real_tc.py), so each output calls one out-of-line function,
//   filter_g, with the thread's 8 columns' w, mu, b, gamma and |mu|^2
//   loaded into registers once and each row's x and |x|^2 once per row (a
//   loop that is not unrolled, evaluating g into shared memory from a
//   per-block column table, made the forward link 8% slower:
//   tools/exp_mfn_tc.py).
// - The link gradient of j = k - 1 (K = o) and any product with K <=
//   kNarrowK fill under one k8 slice: mfn_narrow_kernel runs them on the
//   CUDA cores, a lane per column with its B column and filter in
//   registers, fp32 FMAs in k order, the same epilogues.
// - Weight gradients: wire_tc::weight_grad (the tensor cores, fixed-order
//   1,024-row chunk partials) for the links, wire_tc::narrow_weight_grad
//   for the final layer (N = o) and for links no wider than kNarrowK; the
//   bias gradients are their column sums.
// - Bytes against recompute: the backward recomputes E, S and C from the
//   coordinates (one expf and one sincosf per element) rather than keeping
//   E, S, C and nrm from the forward: those are 4 k planes of n h floats
//   (0.94 GB written and read back per step at the denoise shape, 3.8 GB of
//   memory at the CT sweep's 512^2), while the recompute is a few percent
//   of the step's time.  The forward keeps z_j (k planes) and l_j (k - 1),
//   5 planes of 78.6 MB at the denoise shape; the backward's scratch is 3
//   more.  A forward with no gradient to take runs through two ping-pong
//   planes and keeps nothing.
// - The per-filter sums are column sums over the rows: a filter-gradient
//   kernel recomputes the filter from dg and x, accumulates the nine sums
//   (dq, dq x_0..2, ges, ges x_0..2, ges nrm) per 512-row chunk in a fixed
//   order (1,280 blocks at the denoise shape: the card is full);
//   reduce_chunks adds the chunks in chunk order, a thread per sum and
//   column, and a finish kernel forms dw, db, dmu and dgamma.  dcoords is
//   a row reduction over h: one warp per row, lanes striding over the
//   columns and meeting in a fixed butterfly, filters added in a fixed
//   order.  No float atomics: two calls give identical bits.
// - The first filter z_0 = g_0 takes a lane per column with its filter in
//   registers, rows strided by warp.  The final layer and the step's loss
//   and SSE sums are gemm_common.cuh's.
//
// Accuracy: the phase q reaches the hundreds at init (w = U 128 sqrt(gamma)),
// so sincosf/expf, never the __sinf/__expf intrinsics; build without
// --use_fast_math.  q, nrm and the exponent are formed with explicitly
// rounded ops (__fmul_rn, __fmaf_rn, __fadd_rn) as the plain version's ops
// round them (nn/models.py:mfn_gabor: x w a matmul, x_0 w_0 then one fma
// per further term), so no contraction the compiler picks moves q by a
// rounding step (~3e-5 at |q| ~ 300, ~5e-4 at the 8,000 of the
// extreme-phase check) between the two.  The 3xTF32 link products lie as
// close to float64 as fp32 SGEMMs do (csrc/wire_tc.cuh).
//
// Replicas (wire_tpu's fit_pointwise_many, fit_operator_many and
// fit_frames_many, which vmap these Pallas calls): each entry point takes
// `reps` models of one shape, each on its own weights and its own or the
// shared coordinates (and targets), through the same launches with a
// replica grid axis (blockIdx.z of the filter, link and filter-gradient
// kernels, blockIdx.y of the finish kernel; wire_tc.cuh's weight gradients
// and gemm_common.cuh's sums fold it in as they say); nvalid and denom are
// shared.  Every tensor holds reps of its own, replica r at r times its
// size past the start: each filter's w (reps, d, h), b (reps, h), mu
// (reps, h, d) and gamma (reps, h), the links' W and WT (reps, h, h) and c
// (reps, h), Wf (reps, h, o), WfT (reps, o, h), bf (reps, o); zs[j], ls[j]
// and dg (reps, n, h), dl (2, reps, n, h), pred and g (reps, n, o), the
// gradients likewise, part reps x mfn_part_floats; x (reps, n, d), or one
// (n, d) shared by all when x_shared.  A replica's blocks do what an
// unbatched launch does, so its results are bit-equal to one; reps = 1 is
// that call, through the kernels' single-model instances (the replica is a
// template flag, kReps, of the filter, link and filter-gradient kernels).
// The replica backward computes no dcoords (filter_dcoords_kernel is not
// launched): the batched fits' coordinates are constants.

#include "gemm_common.cuh"
#include "wire_tc.cuh"

using namespace gemm_common;

namespace {

constexpr int kMaxIn = 3;  // coordinate dimensions d = 1 .. 3
constexpr int kSums = 3 + 2 * kMaxIn;  // per-column sums of one filter
// products of depth at most kNarrowK run on the narrow CUDA-core kernel
constexpr int kNarrowK = wire_tc::kNarrowMax;
constexpr int kNarrowRows = 64;  // rows of one block of the lane-per-column
                                 // kernels
constexpr int kWarps = kThreads / 32;

// One Gabor filter: w (d x h), b (h), mu (h x d), gamma (h).
struct Filter {
  const float* w;
  const float* b;
  const float* mu;
  const float* gamma;
};

// Replica rep's filter, each tensor rep times its size past f's.
__device__ __forceinline__ Filter replica_filter(const Filter& f, size_t rep,
                                                 int d, int h) {
  return Filter{f.w + rep * d * h, f.b + rep * h, f.mu + rep * h * d,
                f.gamma + rep * h};
}

// One column's filter: w and mu (0 past d), b, gamma, and |mu|^2 rounded
// as the plain version rounds it (products, then sums).
struct Col {
  float w[kMaxIn], mu[kMaxIn];
  float b, gamma, mu2;
};

__device__ __forceinline__ Col load_col(const Filter& f, int d, int h,
                                        int c) {
  Col col;
#pragma unroll
  for (int k = 0; k < kMaxIn; ++k) {
    col.w[k] = k < d ? f.w[(size_t)k * h + c] : 0.f;
    col.mu[k] = k < d ? f.mu[(size_t)c * d + k] : 0.f;
  }
  col.mu2 = __fmul_rn(col.mu[0], col.mu[0]);
#pragma unroll
  for (int k = 1; k < kMaxIn; ++k)
    if (k < d) col.mu2 = __fadd_rn(col.mu2, __fmul_rn(col.mu[k], col.mu[k]));
  col.b = f.b[c];
  col.gamma = f.gamma[c];
  return col;
}

struct Terms {
  float E, S, C, nrm;
};

// The row's coordinates and |x|^2.
struct Row {
  float x[kMaxIn];
  float xx;
};

__device__ __forceinline__ Row load_row(const float* __restrict__ x, int r,
                                        int d) {
  Row row;
#pragma unroll
  for (int k = 0; k < kMaxIn; ++k)
    row.x[k] = k < d ? x[(size_t)r * d + k] : 0.f;
  row.xx = __fmul_rn(row.x[0], row.x[0]);
#pragma unroll
  for (int k = 1; k < kMaxIn; ++k)
    if (k < d) row.xx = __fadd_rn(row.xx, __fmul_rn(row.x[k], row.x[k]));
  return row;
}

// E, S, C and nrm of a column's filter at a row, rounded as the plain
// version's ops round them: the contractions x w and x mu^T as a matmul
// accumulates (x_0 w_0, then one fma per further term), the squared norms
// as products then sums.
__device__ __forceinline__ Terms filter_terms(const Col& col, const Row& row,
                                              int d) {
  float q = __fmul_rn(row.x[0], col.w[0]);
  float xm = __fmul_rn(row.x[0], col.mu[0]);
#pragma unroll
  for (int k = 1; k < kMaxIn; ++k) {
    if (k < d) {
      q = __fmaf_rn(row.x[k], col.w[k], q);
      xm = __fmaf_rn(row.x[k], col.mu[k], xm);
    }
  }
  q = __fadd_rn(q, col.b);
  Terms t;
  t.nrm = __fsub_rn(__fadd_rn(row.xx, col.mu2), __fmul_rn(2.f, xm));
  t.E = expf(__fmul_rn(__fmul_rn(-0.5f, col.gamma), t.nrm));
  sincosf(q, &t.S, &t.C);
  return t;
}

// g = E S of a column's filter at a row, out of line: the link epilogues
// call it at each of a thread's 64 accumulator registers, and one copy of
// expf's and sincosf's slow paths keeps their kernels short.
__device__ __noinline__ float filter_g(Col col, Row row, int d) {
  const Terms t = filter_terms(col, row, d);
  return t.E * t.S;
}

// z_0[r, c] = g_0(x_r)[c]: a lane per column, its filter in registers; the
// block's kNarrowRows rows strided by warp.  kReps: replica blockIdx.z (x
// shared when x_shared).
template <bool kReps>
__global__ void __launch_bounds__(kThreads) filter_forward_kernel(
    const float* __restrict__ x, Filter f, float* __restrict__ z, int n,
    int d, int h, int x_shared) {
  const int c = blockIdx.x * 32 + threadIdx.x % 32;
  if (c >= h) return;
  if (kReps) {
    const size_t rep = blockIdx.z;
    if (!x_shared) x += rep * n * d;
    f = replica_filter(f, rep, d, h);
    z += rep * n * h;
  }
  const Col col = load_col(f, d, h, c);
  const int r_end = min(n, (int)(blockIdx.y + 1) * kNarrowRows);
  for (int r = blockIdx.y * kNarrowRows + threadIdx.x / 32; r < r_end;
       r += kWarps) {
    const Terms t = filter_terms(col, load_row(x, r, d), d);
    z[(size_t)r * h + c] = t.E * t.S;
  }
}

enum LinkMode { kLinkFwd = 0, kLinkBwd = 1, kPlainOut = 2 };

// A link epilogue's tensors of replica blockIdx.z: x (n x d) unless
// x_shared, the filter, bias (N), lin, out0 and out1 (n x N), each where
// the mode has it (not null).
__device__ __forceinline__ void replica_link(
    const float* __restrict__& x, Filter& f, const float* __restrict__& bias,
    const float* __restrict__& lin, float* __restrict__& out0,
    float* __restrict__& out1, int n, int N, int d, int x_shared) {
  const size_t rep = blockIdx.z;
  if (x != nullptr) {
    if (!x_shared) x += rep * n * d;
    f = replica_filter(f, rep, d, N);
  }
  if (bias != nullptr) bias += rep * N;
  if (lin != nullptr) lin += rep * n * N;
  if (out0 != nullptr) out0 += rep * n * N;
  if (out1 != nullptr) out1 += rep * n * N;
}

// One output of acc = A @ B, g the column's filter at the row:
//   kLinkFwd:  l = acc + bias; o0 = l, o1 = l g            (l_j, z_j)
//   kLinkBwd:  acc is dz_j; o0 = dz g, o1 = dz lin          (dl_j, dg_j)
//   kPlainOut: o0 = acc
template <int kMode>
__device__ __forceinline__ void link_out(float acc, float g, float bias,
                                         float lin, float& o0, float& o1) {
  if (kMode == kLinkFwd) {
    o0 = acc + bias;
    o1 = o0 * g;
  } else if (kMode == kLinkBwd) {
    o0 = acc * g;
    o1 = acc * lin;
  } else {
    o0 = acc;
    o1 = 0.f;
  }
}

// acc = A (n x K) @ B (K x N = h) over the 128 x 64 tile at (blockIdx.y
// kBM, blockIdx.x kBN) on the tensor cores, then link_out<kMode> on the
// registers with filter f at the coordinates x (n x d); bias (kLinkFwd)
// and lin (kLinkBwd) are the link's c and l_j; out0 may be null in
// kLinkFwd.  kVecA, kVecB, kPair: wire_tc.cuh:Access.  kReps: replica
// blockIdx.z, every operand at the replica's offsets (x shared when
// x_shared).
template <int kMode, bool kVecA, bool kVecB, bool kPair, bool kReps>
__global__ void __launch_bounds__(wire_tc::kThreads, 2) mfn_tc_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ x, Filter f, const float* __restrict__ bias,
    const float* __restrict__ lin, float* __restrict__ out0,
    float* __restrict__ out1, int n, int K, int N, int d, int x_shared) {
  constexpr int kMT = wire_tc::kMT, kNT = wire_tc::kNT;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / wire_tc::kWarpsN, wn = warp % wire_tc::kWarpsN;
  const int g = lane / 4, t = lane % 4;
  const int col0 = blockIdx.x * wire_tc::kBN;
  const int row0 = blockIdx.y * wire_tc::kBM;
  if (kReps) {
    A += (size_t)blockIdx.z * n * K;
    B += (size_t)blockIdx.z * K * N;
  }
  float acc[kMT][kNT][4];
  wire_tc::tile_product<wire_tc::kPlain, kVecA, kVecB>(
      smem, A, B, N, n, K, row0, col0, N, acc);
  if (kReps) replica_link(x, f, bias, lin, out0, out1, n, N, d, x_shared);

  // this thread's 8 columns: their bias (forward) and filter
  float2 cb[kNT];
  Col cols[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int j = col0 + wire_tc::tile_col<wire_tc::kPlain>(wn, nt) + 2 * t;
    cb[nt] = kMode == kLinkFwd && j < N
                 ? wire_tc::load2<kPair>(bias + j, j + 1 < N)
                 : make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cols[nt][i] = Col{};
      if (kMode != kPlainOut && j + i < N)
        cols[nt][i] = load_col(f, d, N, j + i);
    }
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    // the backward's l_j of m16 tile mt's 16 outputs, all loaded before the
    // first is used
    float2 lv[2][kNT];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int r = row0 + wm * (kMT * 16) + mt * 16 + g + hr * 8;
        const int j =
            col0 + wire_tc::tile_col<wire_tc::kPlain>(wn, nt) + 2 * t;
        lv[hr][nt] = kMode == kLinkBwd && r < n && j < N
                         ? wire_tc::load2<kPair>(lin + (size_t)r * N + j,
                                                 j + 1 < N)
                         : make_float2(0.f, 0.f);
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = row0 + wm * (kMT * 16) + mt * 16 + g + hr * 8;
      if (r >= n) continue;
      Row row{};
      if (kMode != kPlainOut) row = load_row(x, r, d);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int j =
            col0 + wire_tc::tile_col<wire_tc::kPlain>(wn, nt) + 2 * t;
        if (j >= N) continue;
        const bool two = j + 1 < N;
        const size_t idx = (size_t)r * N + j;
        float2 gg = make_float2(0.f, 0.f);
        if (kMode != kPlainOut) {
          gg.x = filter_g(cols[nt][0], row, d);
          if (two) gg.y = filter_g(cols[nt][1], row, d);
        }
        float2 o0, o1;
        link_out<kMode>(acc[mt][nt][2 * hr], gg.x, cb[nt].x, lv[hr][nt].x,
                        o0.x, o1.x);
        link_out<kMode>(acc[mt][nt][2 * hr + 1], gg.y, cb[nt].y,
                        lv[hr][nt].y, o0.y, o1.y);
        if (out0 != nullptr) wire_tc::store2<kPair>(out0 + idx, o0, two);
        if (kMode != kPlainOut) wire_tc::store2<kPair>(out1 + idx, o1, two);
      }
    }
  }
}

// acc = A (n x K) @ B (K x N) for a small K (<= kNarrowK), then
// link_out<kMode>, on the CUDA cores: a warp takes 32 consecutive columns
// of kNarrowRows rows, one column per lane, and keeps the column's B, bias
// and filter in
// registers; fp32 FMAs in k order.  kReps: as mfn_tc_kernel's.
template <int kMode, bool kReps>
__global__ void __launch_bounds__(kThreads) mfn_narrow_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ x, Filter f, const float* __restrict__ bias,
    const float* __restrict__ lin, float* __restrict__ out0,
    float* __restrict__ out1, int n, int K, int N, int d, int x_shared) {
  const int c = blockIdx.x * 32 + threadIdx.x % 32;
  if (c >= N) return;
  if (kReps) {
    A += (size_t)blockIdx.z * n * K;
    B += (size_t)blockIdx.z * K * N;
    replica_link(x, f, bias, lin, out0, out1, n, N, d, x_shared);
  }
  float b[kNarrowK];
#pragma unroll
  for (int k = 0; k < kNarrowK; ++k)
    b[k] = k < K ? B[(size_t)k * N + c] : 0.f;
  Col col{};
  if (kMode != kPlainOut) col = load_col(f, d, N, c);
  const float cb = kMode == kLinkFwd ? bias[c] : 0.f;
  const int r_end = min(n, (int)(blockIdx.y + 1) * kNarrowRows);
  for (int r = blockIdx.y * kNarrowRows + threadIdx.x / 32; r < r_end;
       r += kWarps) {
    const float* a = A + (size_t)r * K;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kNarrowK; ++k)
      if (k < K) acc = fmaf(a[k], b[k], acc);
    const size_t idx = (size_t)r * N + c;
    float gg = 0.f;
    if (kMode != kPlainOut) {
      const Terms tm = filter_terms(col, load_row(x, r, d), d);
      gg = tm.E * tm.S;
    }
    float o0, o1;
    link_out<kMode>(acc, gg, cb, kMode == kLinkBwd ? lin[idx] : 0.f, o0,
                    o1);
    if (out0 != nullptr) out0[idx] = o0;
    if (kMode != kPlainOut) out1[idx] = o1;
  }
}

// One link product and its epilogue (link_out<kMode>): the narrow kernel
// for K <= kNarrowK, else the tensor-core kernel instance for the shapes'
// and pointers' accesses; kReps: `reps` replicas in blockIdx.z.
template <int kMode, bool kReps>
cudaError_t link(const float* A, const float* B, const float* x,
                 const Filter& f, const float* bias, const float* lin,
                 float* out0, float* out1, int n, int K, int N, int d,
                 cudaStream_t st, int reps, int x_shared) {
  if (K <= kNarrowK) {
    const dim3 grid(ceil_div(N, 32), ceil_div(n, kNarrowRows), reps);
    mfn_narrow_kernel<kMode, kReps><<<grid, kThreads, 0, st>>>(
        A, B, x, f, bias, lin, out0, out1, n, K, N, d, x_shared);
    return cudaGetLastError();
  }
  const dim3 grid(ceil_div(N, wire_tc::kBN), ceil_div(n, wire_tc::kBM),
                  reps);
  auto kernel = wire_tc::instance(
      wire_tc::access(A, B, K, N, {bias, lin, out0, out1}),
      [](auto va, auto vb, auto pr) {
        return &mfn_tc_kernel<kMode, decltype(va)::value,
                              decltype(vb)::value, decltype(pr)::value,
                              kReps>;
      });
  GEMM_CHECK(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      wire_tc::kSmemBytes));
  kernel<<<grid, wire_tc::kThreads, wire_tc::kSmemBytes, st>>>(
      A, B, x, f, bias, lin, out0, out1, n, K, N, d, x_shared);
  return cudaGetLastError();
}

// A link's [dW; dc] = [z_{j-1} | 1]^T dl_j ((h + 1) x h) over n rows; for
// `reps` replicas X, D, part and out hold reps of their own.
cudaError_t link_weight_grad(const float* X, const float* D, float* part,
                             float* out, int n, int h, cudaStream_t st,
                             int reps) {
  if (h <= kNarrowK)
    return wire_tc::narrow_weight_grad(X, D, part, out, n, h, h, st, nullptr,
                                       reps);
  return wire_tc::weight_grad(X, D, part, out, n, h, h, st, nullptr, reps);
}

constexpr int kCols = 32;                  // columns of one filter-grad block
constexpr int kGroups = kThreads / kCols;  // row groups of one block
constexpr int kFilterChunkRows = 512;      // rows of one filter-grad block

inline int filter_chunks(int n) { return ceil_div(n, kFilterChunkRows); }

// Per-chunk partial column sums of filter f's gradient terms from dg
// (n x h), the cotangent of g_f: part[(chunk * kSums + s) * h + c], s in
// [dq, dq x_0, dq x_1, dq x_2, ges, ges x_0, ges x_1, ges x_2, ges nrm]
// (slots past d stay 0).  Thread (c, g) walks rows g, g + 8, ... of the
// chunk in order with its column's filter in registers; the 8 groups then
// meet in order in shared memory.  kReps: replica blockIdx.z (x shared when
// x_shared), its chunk partials after its predecessors'.
template <bool kReps>
__global__ void __launch_bounds__(kThreads) filter_grad_partial_kernel(
    const float* __restrict__ x, const float* __restrict__ dg, Filter f,
    float* __restrict__ part, int n, int d, int h, int x_shared) {
  __shared__ float sums[kSums][kGroups][kCols];
  if (kReps) {
    const size_t rep = blockIdx.z;
    if (!x_shared) x += rep * n * d;
    dg += rep * n * h;
    f = replica_filter(f, rep, d, h);
    part += rep * gridDim.y * kSums * h;
  }
  const int cx = threadIdx.x % kCols, g = threadIdx.x / kCols;
  const int c = blockIdx.x * kCols + cx;
  const int chunk = blockIdx.y;
  const int r_end = min(n, (chunk + 1) * kFilterChunkRows);
  float sdq = 0.f, sges = 0.f, sgn = 0.f;
  float sdqx[kMaxIn], sgx[kMaxIn];
#pragma unroll
  for (int k = 0; k < kMaxIn; ++k) sdqx[k] = sgx[k] = 0.f;
  if (c < h) {
    const Col col = load_col(f, d, h, c);
    for (int r = chunk * kFilterChunkRows + g; r < r_end; r += kGroups) {
      const Row row = load_row(x, r, d);
      const Terms t = filter_terms(col, row, d);
      const float es = dg[(size_t)r * h + c] * t.E;
      const float dq = es * t.C, ges = es * t.S;
      sdq += dq;
      sges += ges;
      sgn = fmaf(ges, t.nrm, sgn);
#pragma unroll
      for (int k = 0; k < kMaxIn; ++k) {
        sdqx[k] = fmaf(dq, row.x[k], sdqx[k]);
        sgx[k] = fmaf(ges, row.x[k], sgx[k]);
      }
    }
  }
  sums[0][g][cx] = sdq;
  sums[1 + kMaxIn][g][cx] = sges;
  sums[2 + 2 * kMaxIn][g][cx] = sgn;
#pragma unroll
  for (int k = 0; k < kMaxIn; ++k) {
    sums[1 + k][g][cx] = sdqx[k];
    sums[2 + kMaxIn + k][g][cx] = sgx[k];
  }
  __syncthreads();
  if (g == 0 && c < h) {
    for (int s = 0; s < kSums; ++s) {
      float t = 0.f;
      for (int q = 0; q < kGroups; ++q) t += sums[s][q][cx];
      part[((size_t)chunk * kSums + s) * h + c] = t;
    }
  }
}

// Filter f's gradients from its nine column sums (kSums x h, the chunk
// partials added in chunk order by reduce_chunks): gw (d x h), gb (h),
// gmu (h x d), ggamma (h); replica blockIdx.y, each tensor at its offset.
__global__ void filter_grad_finish_kernel(const float* __restrict__ sums,
                                          Filter f, float* __restrict__ gw,
                                          float* __restrict__ gb,
                                          float* __restrict__ gmu,
                                          float* __restrict__ ggamma, int d,
                                          int h) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= h) return;
  const size_t rep = blockIdx.y;
  sums += rep * kSums * h;
  f = replica_filter(f, rep, d, h);
  gw += rep * d * h;
  gb += rep * h;
  gmu += rep * h * d;
  ggamma += rep * h;
  float s[kSums];
#pragma unroll
  for (int q = 0; q < kSums; ++q) s[q] = sums[(size_t)q * h + c];
  gb[c] = s[0];
  ggamma[c] = -0.5f * s[2 + 2 * kMaxIn];
  const float hg = -0.5f * f.gamma[c];  // dn = hg ges
  const float sdn = hg * s[1 + kMaxIn];
#pragma unroll
  for (int k = 0; k < kMaxIn; ++k) {
    if (k < d) {
      gw[(size_t)k * h + c] = s[1 + k];
      gmu[(size_t)c * d + k] = 2.f * sdn * f.mu[(size_t)c * d + k] -
                               2.f * (hg * s[2 + kMaxIn + k]);
    }
  }
}

// dcoords[r, :] (+)= sum_c dq w^T + 2 rowsum(dn) x - 2 dn mu for filter f:
// with 2 dn = -gamma ges, sum_c (dq w_kc + gamma ges mu_ck) - x_k
// sum_c gamma ges.  One warp per row; its lanes stride over the columns
// and meet in a fixed butterfly; `accumulate` 0 writes, 1 adds.
__global__ void __launch_bounds__(kThreads) filter_dcoords_kernel(
    const float* __restrict__ x, const float* __restrict__ dg, Filter f,
    float* __restrict__ dc, int n, int d, int h, int accumulate) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kWarps = kThreads / 32;
  for (int it = 0; it < kFinalRowsPerBlock / kWarps; ++it) {
    const int r = blockIdx.x * kFinalRowsPerBlock + it * kWarps + warp;
    if (r >= n) break;
    const Row row = load_row(x, r, d);
    float aw[kMaxIn], am[kMaxIn], ag = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxIn; ++k) aw[k] = am[k] = 0.f;
    for (int c = lane; c < h; c += 32) {
      const Col col = load_col(f, d, h, c);
      const Terms t = filter_terms(col, row, d);
      const float es = dg[(size_t)r * h + c] * t.E;
      const float dq = es * t.C;
      const float gg = col.gamma * (es * t.S);
      ag += gg;
#pragma unroll
      for (int k = 0; k < kMaxIn; ++k) {
        if (k < d) {
          aw[k] = fmaf(dq, col.w[k], aw[k]);
          am[k] = fmaf(gg, col.mu[k], am[k]);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ag += __shfl_xor_sync(0xffffffffu, ag, off);
#pragma unroll
      for (int k = 0; k < kMaxIn; ++k) {
        aw[k] += __shfl_xor_sync(0xffffffffu, aw[k], off);
        am[k] += __shfl_xor_sync(0xffffffffu, am[k], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kMaxIn; ++k) {
        if (k < d) {
          const float v = aw[k] + am[k] - row.x[k] * ag;
          float* out = dc + (size_t)r * d + k;
          *out = accumulate ? *out + v : v;
        }
      }
    }
  }
}

// The network's shape and weights; pointer arrays live on the host.  reps
// replicas (the layouts of the header comment), x shared when x_shared.
struct Net {
  int n, d, h, o, k;
  const float* x;                  // (n x d)
  const float* const* filters;     // per filter: w, b, mu, gamma
  const float* const* W;           // k - 1 links (h x h)
  const float* const* WT;          // their transposes
  const float* const* c;           // their biases (h)
  const float* Wf;                 // (h x o)
  const float* WfT;                // (o x h)
  const float* bf;                 // (o)
  int reps, x_shared;
  Filter filter(int j) const {
    return Filter{filters[4 * j], filters[4 * j + 1], filters[4 * j + 2],
                  filters[4 * j + 3]};
  }
};

// Floats of the `part` workspace of the backward and the step: the
// largest of the link and final weight gradients' chunk partials, the
// filter sums' (their chunk partials, then the sums) and the step's SSE
// partials; per replica.
long long part_floats(int n, int h, int o) {
  long long need = h <= kNarrowK ? wire_tc::narrow_part_floats(n, h, h)
                                 : wire_tc::wgrad_part_floats(n, h, h);
  const long long fin = wire_tc::narrow_part_floats(n, h, o);
  const long long filt = (filter_chunks(n) + 1LL) * kSums * h;
  const long long sse = 2LL * final_loss_blocks(n);
  need = fin > need ? fin : need;
  need = filt > need ? filt : need;
  return sse > need ? sse : need;
}

// The forward chain: zs[j] (n x h) for every filter and, where ls[j] is
// not null, ls[j] = l_j (j >= 1).  zs may alternate between two planes
// when nothing is kept.  The final layer is the caller's.  kReps: net.reps
// replicas.
template <bool kReps>
cudaError_t forward_chain(const Net& net, float* const* zs,
                          float* const* ls, cudaStream_t st) {
  const int n = net.n, h = net.h;
  filter_forward_kernel<kReps>
      <<<dim3(ceil_div(h, 32), ceil_div(n, kNarrowRows), net.reps), kThreads,
         0, st>>>(net.x, net.filter(0), zs[0], n, net.d, h, net.x_shared);
  GEMM_CHECK(cudaGetLastError());
  for (int j = 1; j < net.k; ++j) {
    GEMM_CHECK((link<kLinkFwd, kReps>(
        zs[j - 1], net.W[j - 1], net.x, net.filter(j), net.c[j - 1], nullptr,
        ls[j], zs[j], n, h, h, net.d, st, net.reps, net.x_shared)));
  }
  return cudaSuccess;
}

// Filter j's gradients (and its dcoords term, when dcoords is not null)
// from dg (n x h).
template <bool kReps>
cudaError_t filter_grads(const Net& net, int j, const float* dg,
                         float* const* gf, float* dcoords, float* part,
                         cudaStream_t st) {
  const int n = net.n, d = net.d, h = net.h;
  const Filter f = net.filter(j);
  const int chunks = filter_chunks(n);
  float* sums = part + (size_t)net.reps * chunks * kSums * h;
  const dim3 grid(ceil_div(h, kCols), chunks, net.reps);
  filter_grad_partial_kernel<kReps><<<grid, kThreads, 0, st>>>(
      net.x, dg, f, part, n, d, h, net.x_shared);
  GEMM_CHECK(cudaGetLastError());
  // the chunks in chunk order, one thread per sum and column
  GEMM_CHECK(reduce_chunks(part, chunks, kSums * h, sums, st, nullptr, 1, 0,
                           net.reps));
  filter_grad_finish_kernel<<<dim3(ceil_div(h, kThreads), net.reps),
                              kThreads, 0, st>>>(
      sums, f, gf[4 * j], gf[4 * j + 1], gf[4 * j + 2], gf[4 * j + 3], d,
      h);
  GEMM_CHECK(cudaGetLastError());
  if (dcoords != nullptr) {
    // filters run k - 1 .. 0: the first writes, the rest add
    filter_dcoords_kernel<<<ceil_div(n, kFinalRowsPerBlock), kThreads, 0,
                            st>>>(net.x, dg, f, dcoords, n, d, h,
                                  j != net.k - 1);
    GEMM_CHECK(cudaGetLastError());
  }
  return cudaSuccess;
}

// The backward chain from g = dL/dy (n x o) through the kept zs and ls:
// gf (per filter gw, gb, gmu, ggamma), gW[j] ((h + 1) x h) = [dW; dc] of
// link j, gWf ((h + 1) x o) = [dW_f; db_f], and dcoords (n x d) when not
// null.  Scratch: dl (2 planes of n x h), dg (n x h), part.  kReps:
// net.reps replicas; dcoords must then be null.
template <bool kReps>
cudaError_t backward_chain(const Net& net, const float* g,
                           const float* const* zs, const float* const* ls,
                           float* const* gf, float* const* gW, float* gWf,
                           float* dcoords, float* dl, float* dg, float* part,
                           cudaStream_t st) {
  const int n = net.n, h = net.h, k = net.k;
  if (dcoords != nullptr && net.reps != 1) return cudaErrorInvalidValue;
  const size_t plane = (size_t)net.reps * n * h;
  GEMM_CHECK(wire_tc::narrow_weight_grad(zs[k - 1], g, part, gWf, n, h,
                                         net.o, st, nullptr, net.reps));
  const float* src = g;
  const float* bt = net.WfT;
  int kdim = net.o;
  int cur = 0;
  for (int j = k - 1; j >= 1; --j) {
    float* dlj = dl + cur * plane;
    GEMM_CHECK((link<kLinkBwd, kReps>(src, bt, net.x, net.filter(j), nullptr,
                                      ls[j], dlj, dg, n, kdim, h, net.d, st,
                                      net.reps, net.x_shared)));
    GEMM_CHECK(filter_grads<kReps>(net, j, dg, gf, dcoords, part, st));
    GEMM_CHECK(link_weight_grad(zs[j - 1], dlj, part, gW[j - 1], n, h, st,
                                net.reps));
    src = dlj;
    bt = net.WT[j - 1];
    kdim = h;
    cur ^= 1;
  }
  GEMM_CHECK((link<kPlainOut, kReps>(src, bt, nullptr, Filter{}, nullptr,
                                     nullptr, dg, nullptr, n, kdim, h, net.d,
                                     st, net.reps, net.x_shared)));
  return filter_grads<kReps>(net, 0, dg, gf, dcoords, part, st);
}

// One train step's launches: the forward chain, the final layer with the
// loss gradient and SSE sums, the backward chain without dcoords.
template <bool kReps>
cudaError_t step_chain(const Net& net, const float* t, const float* gt,
                       float* const* zs, float* const* ls, float* pred,
                       float* g, float* sse, float* const* gf,
                       float* const* gW, float* gWf, float* dl, float* dg,
                       float* part, int nvalid, float two_inv_denom,
                       int want_metrics, int t_shared, cudaStream_t st) {
  GEMM_CHECK(forward_chain<kReps>(net, zs, ls, st));
  GEMM_CHECK(final_loss(zs[net.k - 1], net.Wf, net.bf, t, gt, pred, g, sse,
                        part, net.n, net.h, net.o, nvalid, two_inv_denom,
                        want_metrics, st, net.reps, t_shared));
  return backward_chain<kReps>(net, g, zs, ls, gf, gW, gWf, nullptr, dl, dg,
                               part, st);
}

}  // namespace

#define MFN_NET_ARGS                                                       \
  int n, int d, int h, int o, int k, const float *x,                       \
      const float *const *filters, const float *const *W,                  \
      const float *const *WT, const float *const *c, const float *Wf,     \
      const float *WfT, const float *bf, int reps, int x_shared
#define MFN_NET \
  Net { n, d, h, o, k, x, filters, W, WT, c, Wf, WfT, bf, reps, x_shared }

extern "C" {

int mfn_max_out() { return kMaxOut; }

int mfn_max_in() { return kMaxIn; }

const char* mfn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of the `part` workspace of the backward and the step, per
// replica.
long long mfn_part_floats(int n, int d, int h, int o) {
  (void)d;
  return part_floats(n, h, o);
}

// Forward of the pair: pred (n x o).  The network (MFN_NET_ARGS): k
// filters, filters[4 j .. 4 j + 3] = w (d x h), b (h), mu (h x d), gamma
// (h); k - 1 links W (h x h), their transposes WT and biases c (h); the
// final layer Wf (h x o), WfT (o x h), bf (o).  zs[j] (n x h) receive z_j
// and ls[j] l_j (j >= 1) where not null; zs may alternate between two
// planes when nothing is kept.  Pointer arrays live on the host, tensors
// on the card.  For reps replicas each tensor holds reps (the layouts of
// the header comment; pred (reps, n, o)); x_shared: one (n, d) coordinate
// set for all.  Returns the first CUDA error of a launch (0 on success);
// launches on `stream`, does not synchronise.
int mfn_forward(MFN_NET_ARGS, float* const* zs, float* const* ls,
                float* pred, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Net net = MFN_NET;
  GEMM_CHECK(reps > 1 ? forward_chain<true>(net, zs, ls, st)
                      : forward_chain<false>(net, zs, ls, st));
  return final_forward(zs[k - 1], Wf, bf, pred, n, h, o, st, reps);
}

// Backward of the pair from g = dL/dpred (n x o), reading the forward's
// zs and ls; see backward_chain for the outputs and the scratch.  For reps
// replicas as the forward's (part reps x mfn_part_floats); dcoords must
// then be null.
int mfn_backward(MFN_NET_ARGS, const float* g, const float* const* zs,
                 const float* const* ls, float* const* gf, float* const* gW,
                 float* gWf, float* dcoords, float* dl, float* dg,
                 float* part, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Net net = MFN_NET;
  if (reps > 1)
    return backward_chain<true>(net, g, zs, ls, gf, gW, gWf, dcoords, dl,
                                dg, part, st);
  return backward_chain<false>(net, g, zs, ls, gf, gW, gWf, dcoords, dl, dg,
                               part, st);
}

// One train step: the forward (zs, ls kept in the caller's scratch), the
// final layer with g = two_inv_denom * mask (pred - t), mask = row <
// nvalid, and the SSE sums (sse (2): against t and gt, when want_metrics),
// then the backward without dcoords.  Arguments as for the pair; g
// (n x o) scratch.  For reps replicas as the pair's, with t, gt, g (reps,
// n, o) and sse (reps, 2); t_shared: one (n, o) target and gt for all.
int mfn_step_run(MFN_NET_ARGS, const float* t, const float* gt,
                 float* const* zs, float* const* ls, float* pred, float* g,
                 float* sse, float* const* gf, float* const* gW, float* gWf,
                 float* dl, float* dg, float* part, int nvalid,
                 float two_inv_denom, int want_metrics, int t_shared,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Net net = MFN_NET;
  auto run = reps > 1 ? step_chain<true> : step_chain<false>;
  return run(net, t, gt, zs, ls, pred, g, sse, gf, gW, gWf, dl, dg, part,
             nvalid, two_inv_denom, want_metrics, t_shared, st);
}

}  // extern "C"
