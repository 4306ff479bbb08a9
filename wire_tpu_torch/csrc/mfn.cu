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
// ~4 MB of inputs and outputs: 1.08 ms at the card's 67 TFLOP/s fp32 peak.
// The SISR pair (n = 65,536, h = 256, dcoords) is 53.05 GFLOP, 0.79 ms.
//
// What this design does about it: it is the simple, correct first version.
// - The links run on real_chain.cuh's tiled GEMM loop (64 x 64 output tile,
//   16-deep k slices, 4 x 4 per thread, fp32 FMA on the CUDA cores; h kept
//   exact with masked tiles, not the TPU kernel's 128-lane padding of 300
//   to 384) with MFN epilogues: the forward adds c, forms g_j in place from
//   the row's d coordinates and the column's w, b, mu and gamma, and writes
//   l_j and z_j; the backward reads l_j, recomputes g_j and writes dl_j and
//   dg_j.
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
//   (dq, dq x_0..2, ges, ges x_0..2, ges nrm) per 2048-row chunk in a fixed
//   order, and a finish kernel adds the chunks in chunk order and forms
//   dw, db, dmu and dgamma.  Weight gradients take gemm_common.cuh's
//   fixed-order chunk sums, the bias as the ones row.  dcoords is a row
//   reduction over h: one warp per row, lanes striding over the columns
//   and meeting in a fixed butterfly, filters added in a fixed order.  No
//   float atomics: two calls give identical bits.
// - The final layer and the step's loss and SSE sums are gemm_common.cuh's.
// Tensor cores (TF32 wgmma) and TMA pipelines are later work.
//
// Accuracy: the phase q reaches the hundreds at init (w = U 128 sqrt(gamma)),
// so sincosf/expf, never the __sinf/__expf intrinsics; build without
// --use_fast_math.  q, nrm and the exponent are formed with explicitly
// rounded ops (__fmul_rn, __fmaf_rn, __fadd_rn) as the plain version's ops
// round them (nn/models.py:mfn_gabor: x w a matmul, x_0 w_0 then one fma
// per further term), so no contraction the compiler picks moves q by a
// rounding step (~3e-5 at |q| ~ 300, ~5e-4 at the 8,000 of the
// extreme-phase check) between the two.

#include "real_chain.cuh"

using namespace gemm_common;

namespace {

constexpr int kMaxIn = 3;  // coordinate dimensions d = 1 .. 3
constexpr int kSums = 3 + 2 * kMaxIn;  // per-column sums of one filter

// One Gabor filter: w (d x h), b (h), mu (h x d), gamma (h).
struct Filter {
  const float* w;
  const float* b;
  const float* mu;
  const float* gamma;
};

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

// E, S, C and nrm of filter f at row `row`, column c, rounded as the plain
// version's ops round them: the contractions x w and x mu^T as a matmul
// accumulates (x_0 w_0, then one fma per further term), the squared norms
// as products then sums.
__device__ __forceinline__ Terms filter_terms(const Filter& f, const Row& row,
                                              int d, int h, int c) {
  float q = __fmul_rn(row.x[0], f.w[c]);
  float m = f.mu[(size_t)c * d];
  float xm = __fmul_rn(row.x[0], m);
  float mu2 = __fmul_rn(m, m);
#pragma unroll
  for (int k = 1; k < kMaxIn; ++k) {
    if (k < d) {
      q = __fmaf_rn(row.x[k], f.w[(size_t)k * h + c], q);
      m = f.mu[(size_t)c * d + k];
      xm = __fmaf_rn(row.x[k], m, xm);
      mu2 = __fadd_rn(mu2, __fmul_rn(m, m));
    }
  }
  q = __fadd_rn(q, f.b[c]);
  Terms t;
  t.nrm = __fsub_rn(__fadd_rn(row.xx, mu2), __fmul_rn(2.f, xm));
  t.E = expf(__fmul_rn(__fmul_rn(-0.5f, f.gamma[c]), t.nrm));
  sincosf(q, &t.S, &t.C);
  return t;
}

// z_0[r, c] = g_0(x_r)[c], one thread per element.
__global__ void __launch_bounds__(kThreads) filter_forward_kernel(
    const float* __restrict__ x, Filter f, float* __restrict__ z, int n,
    int d, int h) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)n * h) return;
  const int r = (int)(idx / h), c = (int)(idx % h);
  const Terms t = filter_terms(f, load_row(x, r, d), d, h, c);
  z[idx] = t.E * t.S;
}

enum MfnEpilogue { kLinkFwd = 0, kLinkBwd = 1, kPlainOut = 2 };

// acc = A (n x K) @ B (K x N = h) for a 64 x 64 tile, then:
//   kLinkFwd:  l = acc + bias; out0 = l (skipped when null);
//              out1 = l g_f(x)                       (z_j)
//   kLinkBwd:  acc is dz_j; out0 = dz g_f(x) (dl_j); out1 = dz lin (dg_j)
//   kPlainOut: out0 = acc
template <int kEpi>
__global__ void __launch_bounds__(kThreads) mfn_gemm_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ x, Filter f, const float* __restrict__ bias,
    const float* __restrict__ lin, float* __restrict__ out0,
    float* __restrict__ out1, int n, int K, int N, int d) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * real_chain::kTileRows;
  const int col0 = blockIdx.y * real_chain::kTileCols;
  float acc[4][4];
  real_chain::gemm_tile(A, B, n, K, N, row0, col0, acc);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= n) continue;
    Row row;
    if (kEpi != kPlainOut) row = load_row(x, r, d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c >= N) continue;
      const size_t idx = (size_t)r * N + c;
      if (kEpi == kPlainOut) {
        out0[idx] = acc[i][j];
        continue;
      }
      const Terms t = filter_terms(f, row, d, N, c);
      const float g = t.E * t.S;
      if (kEpi == kLinkFwd) {
        const float l = acc[i][j] + bias[c];
        if (out0 != nullptr) out0[idx] = l;
        out1[idx] = l * g;
      } else {
        out0[idx] = acc[i][j] * g;
        out1[idx] = acc[i][j] * lin[idx];
      }
    }
  }
}

template <int kEpi>
cudaError_t mfn_gemm(const float* A, const float* B, const float* x,
                     const Filter& f, const float* bias, const float* lin,
                     float* out0, float* out1, int n, int K, int N, int d,
                     cudaStream_t st) {
  const dim3 grid(ceil_div(n, real_chain::kTileRows),
                  ceil_div(N, real_chain::kTileCols));
  mfn_gemm_kernel<kEpi><<<grid, kThreads, 0, st>>>(A, B, x, f, bias, lin,
                                                   out0, out1, n, K, N, d);
  return cudaGetLastError();
}

constexpr int kCols = 32;                  // columns of one filter-grad block
constexpr int kGroups = kThreads / kCols;  // row groups of one block

// Per-chunk partial column sums of filter f's gradient terms from dg
// (n x h), the cotangent of g_f: part[(chunk * kSums + s) * h + c], s in
// [dq, dq x_0, dq x_1, dq x_2, ges, ges x_0, ges x_1, ges x_2, ges nrm]
// (slots past d stay 0).  Thread (c, g) walks rows g, g + 8, ... of the
// chunk in order; the 8 groups then meet in order in shared memory.
__global__ void __launch_bounds__(kThreads) filter_grad_partial_kernel(
    const float* __restrict__ x, const float* __restrict__ dg, Filter f,
    float* __restrict__ part, int n, int d, int h) {
  __shared__ float sums[kSums][kGroups][kCols];
  const int cx = threadIdx.x % kCols, g = threadIdx.x / kCols;
  const int c = blockIdx.x * kCols + cx;
  const int chunk = blockIdx.y;
  const int r_end = min(n, (chunk + 1) * kChunkRows);
  float sdq = 0.f, sges = 0.f, sgn = 0.f;
  float sdqx[kMaxIn], sgx[kMaxIn];
#pragma unroll
  for (int k = 0; k < kMaxIn; ++k) sdqx[k] = sgx[k] = 0.f;
  if (c < h) {
    for (int r = chunk * kChunkRows + g; r < r_end; r += kGroups) {
      const Row row = load_row(x, r, d);
      const Terms t = filter_terms(f, row, d, h, c);
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

// Filter f's gradients from the chunk partials, added in chunk order:
// gw (d x h), gb (h), gmu (h x d), ggamma (h).
__global__ void filter_grad_finish_kernel(const float* __restrict__ part,
                                          int chunks, Filter f,
                                          float* __restrict__ gw,
                                          float* __restrict__ gb,
                                          float* __restrict__ gmu,
                                          float* __restrict__ ggamma, int d,
                                          int h) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= h) return;
  float s[kSums];
#pragma unroll
  for (int q = 0; q < kSums; ++q) s[q] = 0.f;
  for (int ch = 0; ch < chunks; ++ch) {
#pragma unroll
    for (int q = 0; q < kSums; ++q)
      s[q] += part[((size_t)ch * kSums + q) * h + c];
  }
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
      const Terms t = filter_terms(f, row, d, h, c);
      const float es = dg[(size_t)r * h + c] * t.E;
      const float dq = es * t.C;
      const float gg = f.gamma[c] * (es * t.S);
      ag += gg;
#pragma unroll
      for (int k = 0; k < kMaxIn; ++k) {
        if (k < d) {
          aw[k] = fmaf(dq, f.w[(size_t)k * h + c], aw[k]);
          am[k] = fmaf(gg, f.mu[(size_t)c * d + k], am[k]);
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

// The network's shape and weights; pointer arrays live on the host.
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
  Filter filter(int j) const {
    return Filter{filters[4 * j], filters[4 * j + 1], filters[4 * j + 2],
                  filters[4 * j + 3]};
  }
};

inline int chunks_of(int n) { return ceil_div(n, kChunkRows); }

long long part_floats(int n, int h, int o) {
  long long need = wgrad_part_floats(n, h, h);
  const long long fin = wgrad_part_floats(n, h, o);
  const long long filt = (long long)chunks_of(n) * kSums * h;
  const long long sse = 2LL * final_loss_blocks(n);
  need = fin > need ? fin : need;
  need = filt > need ? filt : need;
  return sse > need ? sse : need;
}

// The forward chain: zs[j] (n x h) for every filter and, where ls[j] is
// not null, ls[j] = l_j (j >= 1).  zs may alternate between two planes
// when nothing is kept.  The final layer is the caller's.
cudaError_t forward_chain(const Net& net, float* const* zs,
                          float* const* ls, cudaStream_t st) {
  const int n = net.n, h = net.h;
  filter_forward_kernel<<<ceil_div((long long)n * h, kThreads), kThreads, 0,
                          st>>>(net.x, net.filter(0), zs[0], n, net.d, h);
  GEMM_CHECK(cudaGetLastError());
  for (int j = 1; j < net.k; ++j) {
    GEMM_CHECK(mfn_gemm<kLinkFwd>(zs[j - 1], net.W[j - 1], net.x,
                                  net.filter(j), net.c[j - 1], nullptr,
                                  ls[j], zs[j], n, h, h, net.d, st));
  }
  return cudaSuccess;
}

// Filter j's gradients (and its dcoords term, when dcoords is not null)
// from dg (n x h).
cudaError_t filter_grads(const Net& net, int j, const float* dg,
                         float* const* gf, float* dcoords, float* part,
                         cudaStream_t st) {
  const int n = net.n, d = net.d, h = net.h;
  const Filter f = net.filter(j);
  const dim3 grid(ceil_div(h, kCols), chunks_of(n));
  filter_grad_partial_kernel<<<grid, kThreads, 0, st>>>(net.x, dg, f, part,
                                                        n, d, h);
  GEMM_CHECK(cudaGetLastError());
  filter_grad_finish_kernel<<<ceil_div(h, kThreads), kThreads, 0, st>>>(
      part, chunks_of(n), f, gf[4 * j], gf[4 * j + 1], gf[4 * j + 2],
      gf[4 * j + 3], d, h);
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
// null.  Scratch: dl (2 planes of n x h), dg (n x h), part.
cudaError_t backward_chain(const Net& net, const float* g,
                           const float* const* zs, const float* const* ls,
                           float* const* gf, float* const* gW, float* gWf,
                           float* dcoords, float* dl, float* dg, float* part,
                           cudaStream_t st) {
  const int n = net.n, h = net.h, k = net.k;
  const size_t plane = (size_t)n * h;
  GEMM_CHECK(weight_grad(zs[k - 1], g, part, gWf, n, h, net.o, st));
  const float* src = g;
  const float* bt = net.WfT;
  int kdim = net.o;
  int cur = 0;
  for (int j = k - 1; j >= 1; --j) {
    float* dlj = dl + cur * plane;
    GEMM_CHECK(mfn_gemm<kLinkBwd>(src, bt, net.x, net.filter(j), nullptr,
                                  ls[j], dlj, dg, n, kdim, h, net.d, st));
    GEMM_CHECK(filter_grads(net, j, dg, gf, dcoords, part, st));
    GEMM_CHECK(weight_grad(zs[j - 1], dlj, part, gW[j - 1], n, h, h, st));
    src = dlj;
    bt = net.WT[j - 1];
    kdim = h;
    cur ^= 1;
  }
  GEMM_CHECK(mfn_gemm<kPlainOut>(src, bt, nullptr, Filter{}, nullptr,
                                 nullptr, dg, nullptr, n, kdim, h, net.d,
                                 st));
  return filter_grads(net, 0, dg, gf, dcoords, part, st);
}

}  // namespace

#define MFN_NET_ARGS                                                       \
  int n, int d, int h, int o, int k, const float *x,                       \
      const float *const *filters, const float *const *W,                  \
      const float *const *WT, const float *const *c, const float *Wf,     \
      const float *WfT, const float *bf
#define MFN_NET Net{n, d, h, o, k, x, filters, W, WT, c, Wf, WfT, bf}

extern "C" {

int mfn_max_out() { return kMaxOut; }

int mfn_max_in() { return kMaxIn; }

const char* mfn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of the `part` workspace of the backward and the step.
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
// on the card.  Returns the first CUDA error of a launch (0 on success);
// launches on `stream`, does not synchronise.
int mfn_forward(MFN_NET_ARGS, float* const* zs, float* const* ls,
                float* pred, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Net net = MFN_NET;
  GEMM_CHECK(forward_chain(net, zs, ls, st));
  return final_forward(zs[k - 1], Wf, bf, pred, n, h, o, st);
}

// Backward of the pair from g = dL/dpred (n x o), reading the forward's
// zs and ls; see backward_chain for the outputs and the scratch.
int mfn_backward(MFN_NET_ARGS, const float* g, const float* const* zs,
                 const float* const* ls, float* const* gf, float* const* gW,
                 float* gWf, float* dcoords, float* dl, float* dg,
                 float* part, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return backward_chain(MFN_NET, g, zs, ls, gf, gW, gWf, dcoords, dl, dg,
                        part, st);
}

// One train step: the forward (zs, ls kept in the caller's scratch), the
// final layer with g = two_inv_denom * mask (pred - t), mask = row <
// nvalid, and the SSE sums (sse (2): against t and gt, when want_metrics),
// then the backward without dcoords.  Arguments as for the pair; g
// (n x o) scratch.
int mfn_step_run(MFN_NET_ARGS, const float* t, const float* gt,
                 float* const* zs, float* const* ls, float* pred, float* g,
                 float* sse, float* const* gf, float* const* gW, float* gWf,
                 float* dl, float* dg, float* part, int nvalid,
                 float two_inv_denom, int want_metrics, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Net net = MFN_NET;
  GEMM_CHECK(forward_chain(net, zs, ls, st));
  GEMM_CHECK(final_loss(zs[k - 1], Wf, bf, t, gt, pred, g, sse, part, n, h,
                        o, nvalid, two_inv_denom, want_metrics, st));
  return backward_chain(net, g, zs, ls, gf, gW, gWf, nullptr, dl, dg, part,
                        st);
}

}  // extern "C"
