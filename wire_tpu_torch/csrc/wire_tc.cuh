// The tensor-core GEMM loop of the WIRE kernels (csrc/wire_mlp.cu and
// csrc/wire_step.cu, through wire_gemm.cuh's chains), of WIRE-2D
// (csrc/wire2d.cu), of mscale2_step's real trunk (csrc/real_tc.cuh, the
// plain column map) and of the MFN's links (csrc/mfn.cu, the plain column
// map): fp32 products on Hopper's tensor cores at fp32
// accuracy (3xTF32), for the three product classes of a hidden layer:
//   forward        z = a @ W + b, with the layer's activation epilogue
//   data gradient  da = dz @ W^T, with the activation-form backward
//                  epilogue (to dz of the layer below, or to dz1)
//   weight grad.   [dW; db] = [a^T dz; colsum(dz)] over n rows, as
//                  fixed-order per-chunk partials
//
// 3xTF32 (CUTLASS's OpMultiplyAddFastF32 scheme): each fp32 operand x is
// split in registers into big = tf32(x) and small = tf32(x - big), both
// rounded as cvt.rna rounds (tf32_split), and the product is formed as
// small*big + big*small + big*big, small terms first; small*small (~2^-22
// relative) is dropped.
// Plain TF32 keeps ~3 decimal digits, which over a K of 424 misses the port's
// 1e-4 x max kernel-vs-plain bound; 3xTF32 stays at fp32's own error
// (ops/wire_mlp.py:matmul_3xtf32_plain models it, tests/test_torch_tf32x3.py
// holds it there).
//
// The loop (tile_product): mma.sync.aligned.m16n8k8 (tf32 in, fp32
// accumulate), 128 x 64 block tiles, 4 warps of 64 x 32, 32-deep slices
// staged through a 3-stage cp.async ring in dynamic shared memory (83 KB,
// 2 blocks per SM; 16-byte copies of A where its rows are 4-float aligned,
// of B where its mapped column blocks are, each decided apart, else 4-byte
// ones; out-of-range rows, columns and depth are zero-filled in shared
// memory, never padded in device memory, so any h, n and K work).  Each
// slice's products are summed in registers of their own and then added to
// the running fp32 sums (slice_product: the tensor cores' accumulation
// truncates).  wgmma is not used: on tf32 it takes only K-major
// shared-memory operands, which the weight gradient's a^T is not, and the
// 3xTF32 split of a shared-memory operand would double its tiles.
//
// The epilogues need a unit's channels in one thread, so the B columns are
// staged through a column map (ColMap).  kPaired (WIRE's forward and every
// data gradient): a unit's re and im (columns j and h + j of 2h); the tile
// stages the re columns of its 32 units in shared-memory columns 0..31 and
// their im columns in 32..63 (ops/wire_mlp.py:paired_tile_columns); warp
// wn's n8 tiles are re columns wn*16 + {0, 8} and im columns 32 + wn*16 +
// {0, 8} (tile_col), so the accumulator registers of n8 tiles nt and nt + 2
// hold the re and im of the same units.  kQuad (WIRE-2D's forward): a
// unit's four channels [lr | li | or | oi] (columns j, h + j, 2h + j and
// 3h + j of 4h); staged column 16c + u holds channel c of the tile's unit u
// (ops/wire2d.py:quad_tile_columns), and warp wn's n8 tile nt is channel nt
// of units wn*8 .. wn*8 + 7, so the accumulator registers of n8 tiles 0..3
// hold the four channels of the same units.  kPlain: columns in order.
//
// The mma and the cp.async ring are the only inline PTX; they and the TF32
// split each live in one small function (tf32_split, mma_tf32,
// cp_async_*), so a host build for rehearsal can replace them.
//
// Replicas (the batched multi-fit, `reps` models of one shape in one
// launch): the paired product takes the replica in blockIdx.z, the weight
// gradient folds it into the chunk axis (blockIdx.z = replica x chunks +
// chunk), the narrow kernels take it in their free grid axis.  Every
// operand of replica r lies r times its own size past its tensor's start
// (the callers stack weights layer-major, (L, reps, ...), so that holds
// for a layer's slice too), the coordinates optionally shared; the
// partials of replica r follow those of r - 1.  A replica's blocks do what
// an unbatched launch does, so its results are bit-equal to one.  The
// replica is a template flag (kReps) of these three kernels: an unbatched
// launch takes an instance without the replica's offsets, whose code is the
// single model's as it was (the offsets cost the main loop registers).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "gemm_common.cuh"

namespace wire_tc {

constexpr int kWarpsM = 2, kWarpsN = 2;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;  // 128
constexpr int kMT = 4;                  // m16 tiles per warp: 64 rows
constexpr int kNT = 4;                  // n8 tiles per warp: 32 columns
constexpr int kBM = kWarpsM * kMT * 16;  // 128 rows per block tile
constexpr int kBN = kWarpsN * kNT * 8;   // 64 columns per block tile
constexpr int kUnits = kBN / 2;          // complex units per paired tile
constexpr int kQuadUnits = kBN / 4;      // units per quad tile (WIRE-2D)
constexpr int kBK = 32;                  // depth of one staged slice
constexpr int kStages = 3;
constexpr int kLdMK = kBK + 4;  // [m][k] tiles (rows of A): 36 floats
constexpr int kLdKM = kBM + 8;  // [k][m] tiles (a^T of the weight grad.)
constexpr int kLdKN = kBN + 8;  // [k][n] tiles (B, dz): 72 floats
constexpr int kStageA = kBM * kLdMK > kBK * kLdKM ? kBM * kLdMK : kBK * kLdKM;
constexpr int kStageB = kBK * kLdKN;
constexpr int kSmemBytes = kStages * (kStageA + kStageB) * 4;  // dynamic
constexpr int kChunkRows = 1024;  // rows summed by one weight-grad. block

enum Mode { kFwd = 0, kBwd = 1, kBwdFirst = 2 };
enum ColMap { kPlain = 0, kPaired = 1, kQuad = 2 };

using gemm_common::ceil_div;

// A null pointer counts as aligned (it is never accessed).
inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// ---- the inline PTX ------------------------------------------------------

// big = tf32(x) rounded to nearest, ties away, as cvt.rna.tf32.f32 rounds
// a finite value: half a TF32 ulp (bit 12) added to the magnitude bits,
// the 13 low bits cleared (two integer ops; cvt.rna's NaN and infinity
// handling costs three more, and the operands here are finite).  small =
// the residual x - big (exact in fp32), rounded the same way.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
}

// d += a (16 x 8, row) * b (8 x 8, col), tf32 in, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 (or, with vec = false, 4) bytes from gmem to smem; zero-filled when
// !valid (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async(float* smem, const float* gmem,
                                         bool valid, bool vec) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
                 "l"(gmem), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
                 "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most kStages - 2 groups are still in flight.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 2) : "memory");
}

// ---- staging ---------------------------------------------------------------
//
// A thread's share of one staged tile is fixed for the whole k loop: one
// column (of kStep floats: 4 with 16-byte copies, else 1) in rows first,
// first + kRowStep, ...  Its source address, smem offset and which of its
// rows and columns exist are worked out once; a tile only adds its depth.

// s[m][k] (stride kLdMK) = X[row0 + m][k0 + k] for a row-major X (n x K).
template <bool kVec>
struct StageMK {
  static constexpr int kStep = kVec ? 4 : 1;
  static constexpr int kPerRow = kBK / kStep;
  static constexpr int kRowStep = kThreads / kPerRow;
  static constexpr int kIters = kBM / kRowStep;
  const float* X;
  const float* src;  // X[row0 + first][kk]
  size_t stride;     // kRowStep rows of X
  int nlive;         // the rows i < nlive of this thread exist
  int kk, off;

  __device__ __forceinline__ StageMK(const float* X_, int row0, int n, int K)
      : X(X_) {
    const int first = threadIdx.x / kPerRow;
    kk = (threadIdx.x % kPerRow) * kStep;
    const int left = n - row0 - first;
    nlive = left <= 0 ? 0 : min(kIters, (left + kRowStep - 1) / kRowStep);
    src = X + (size_t)(row0 + first) * K + kk;
    stride = (size_t)kRowStep * K;
    off = first * kLdMK + kk;
  }

  __device__ __forceinline__ void operator()(float* s, int k0, int K) const {
    const bool kok = k0 + kk < K;
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const bool ok = kok && i < nlive;
      cp_async(s + off + i * kRowStep * kLdMK, ok ? src + i * stride + k0 : X,
               ok, kVec);
    }
  }
};

// s[k][c] (stride kLd, width C) = X[r0 + k][col(c)] for a row-major X
// (rows x ldx).  kPaired (C = kBN): col(c) = c0 + c for c < kUnits, else
// h + c0 + c - kUnits, live while the unit is < h.  kQuad (C = kBN): col(c)
// = (c / kQuadUnits) h + c0 + c % kQuadUnits, live while the unit is < h.
// kPlain: col(c) = c0 + c, live while < ncols.  With kVec, every 4-column
// block is wholly live or wholly not (the launch checks the alignment).
template <int C, int kLd, bool kVec, int kMap>
struct StageKN {
  static constexpr int kStep = kVec ? 4 : 1;
  static constexpr int kPerRow = C / kStep;
  static constexpr int kRowStep = kThreads / kPerRow;
  static constexpr int kIters = kBK / kRowStep;
  const float* X;
  const float* src;  // X[first][col(c)]
  int ldx, first, off;
  bool col_ok;

  __device__ __forceinline__ StageKN(const float* X_, int ldx_, int c0,
                                     int ncols, int h)
      : X(X_), ldx(ldx_) {
    first = threadIdx.x / kPerRow;
    const int c = (threadIdx.x % kPerRow) * kStep;
    int gc;
    if (kMap == kPaired) {
      const int u = c < kUnits ? c : c - kUnits;
      col_ok = c0 + u < h;
      gc = (c < kUnits ? 0 : h) + c0 + u;
    } else if (kMap == kQuad) {
      const int u = c % kQuadUnits;
      col_ok = c0 + u < h;
      gc = (c / kQuadUnits) * h + c0 + u;
    } else {
      gc = c0 + c;
      col_ok = gc < ncols;
    }
    src = X + (size_t)first * ldx + gc;
    off = first * kLd + c;
  }

  __device__ __forceinline__ void operator()(float* s, int r0,
                                             int rows) const {
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int k = first + i * kRowStep;
      const bool ok = col_ok && r0 + k < rows;
      cp_async(s + off + i * kRowStep * kLd,
               ok ? src + (size_t)(r0 + i * kRowStep) * ldx : X, ok, kVec);
    }
  }
};

// ---- one 8-deep step of a warp's 64 x 32 tile ----------------------------

// Column (in the staged tile) of the warp's n8 tile nt: paired tiles take
// the re columns of the warp's 16 units in n8 tiles 0 .. kNT/2 - 1 and
// their im columns, kUnits further on, in kNT/2 .. kNT - 1; quad tiles
// channel nt of the warp's 8 units; plain tiles the warp's 8 kNT columns
// in order.
template <int kMap>
__device__ __forceinline__ int tile_col(int wn, int nt) {
  constexpr int kHalf = kNT / 2;
  if (kMap == kPaired)
    return (nt < kHalf ? 0 : kUnits) + wn * (kHalf * 8) + (nt % kHalf) * 8;
  if (kMap == kQuad) return nt * kQuadUnits + wn * 8;
  return wn * (kNT * 8) + nt * 8;
}

// acc += A[rows wm*64 ..][k0 .. k0 + 8) * B[k0 .. k0 + 8)[warp columns].
// A is s[m][k] (kAT = false) or s[k][m] (kAT = true); B is s[k][n].
template <bool kAT, int kMap>
__device__ __forceinline__ void warp_k8(const float* As, const float* Bs,
                                        int wm, int wn, int k0,
                                        float (&acc)[kMT][kNT][4]) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  uint32_t bb[kNT][2], bs[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int c = tile_col<kMap>(wn, nt) + g;
    tf32_split(Bs[(k0 + t) * kLdKN + c], bb[nt][0], bs[nt][0]);
    tf32_split(Bs[(k0 + t + 4) * kLdKN + c], bb[nt][1], bs[nt][1]);
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int r = wm * (kMT * 16) + mt * 16 + g;
    float a[4];
    if (kAT) {
      a[0] = As[(k0 + t) * kLdKM + r];
      a[1] = As[(k0 + t) * kLdKM + r + 8];
      a[2] = As[(k0 + t + 4) * kLdKM + r];
      a[3] = As[(k0 + t + 4) * kLdKM + r + 8];
    } else {
      a[0] = As[r * kLdMK + k0 + t];
      a[1] = As[(r + 8) * kLdMK + k0 + t];
      a[2] = As[r * kLdMK + k0 + t + 4];
      a[3] = As[(r + 8) * kLdMK + k0 + t + 4];
    }
    uint32_t ab[4], as[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) tf32_split(a[i], ab[i], as[i]);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      mma_tf32(acc[mt][nt], as, bb[nt]);
      mma_tf32(acc[mt][nt], ab, bs[nt]);
      mma_tf32(acc[mt][nt], ab, bb[nt]);
    }
  }
}

// acc += the product of one staged slice (kBK deep).  The tensor cores
// add each product into their fp32 accumulator with truncation, so errors
// that compound over the ~160 mma of a K of 424 drift one way (measured:
// ~10x plain fp32's distance from float64 at the CT shape with one
// accumulator for the whole K).  So a slice's 12 products go to a fresh
// register tile, and that tile is added into acc by ordinary fp32 adds,
// rounded to nearest ("promotion"): 2.7e-6 x max from float64 at the CT
// shape, plain fp32's 2.6e-6 (tools/exp_wire_tc.py).
template <bool kAT, int kMap>
__device__ __forceinline__ void slice_product(const float* As,
                                              const float* Bs, int wm, int wn,
                                              float (&acc)[kMT][kNT][4]) {
  float part[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[mt][nt][c] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < kBK; k0 += 8)
    warp_k8<kAT, kMap>(As, Bs, wm, wn, k0, part);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] += part[mt][nt][c];
}

// ---- the main loop -------------------------------------------------------

// acc = A (rows row0 .. row0 + kBM of a row-major n x K A) @ the kBN
// columns of B (K rows of ldb floats) that column map kMap stages for the
// tile at unit (kPlain: column) c0, left in registers for the caller's
// epilogue: the cp.async ring's prologue, the slice loop and
// slice_product.  h: the units (kPlain: the columns) of B.  smem:
// kSmemBytes of dynamic shared memory.  kVecA, kVecB: 16-byte copies of A
// (K % 4 == 0, A 16-byte aligned) and of B's mapped columns (h % 4 == 0,
// B 16-byte aligned).
template <int kMap, bool kVecA, bool kVecB>
__device__ __forceinline__ void tile_product(float* smem, const float* A,
                                             const float* B, int ldb, int n,
                                             int K, int row0, int c0, int h,
                                             float (&acc)[kMT][kNT][4]) {
  float(*As)[kStageA] = reinterpret_cast<float(*)[kStageA]>(smem);
  float(*Bs)[kStageB] =
      reinterpret_cast<float(*)[kStageB]>(smem + kStages * kStageA);
  const int warp = threadIdx.x / 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int ktiles = (K + kBK - 1) / kBK;

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

  const StageMK<kVecA> stage_a(A, row0, n, K);
  const StageKN<kBN, kLdKN, kVecB, kMap> stage_b(B, ldb, c0, h, h);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) {
      stage_a(As[s], s * kBK, K);
      stage_b(Bs[s], s * kBK, K);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait_ring();
    __syncthreads();
    const int nk = kt + kStages - 1;
    if (nk < ktiles) {
      const int s = nk % kStages;
      stage_a(As[s], nk * kBK, K);
      stage_b(Bs[s], nk * kBK, K);
    }
    cp_async_commit();
    const int s = kt % kStages;
    slice_product<false, kMap>(As[s], Bs[s], wm, wn, acc);
  }
}

// The copy widths and epilogue accesses a launch can take, from its shapes
// and pointers: vec_a 16-byte copies of A (K % 4 == 0: its rows are then
// 4-float aligned at any h), vec_b 16-byte copies of B's mapped columns
// (h % 4 == 0), pair 8-byte epilogue accesses (h even, the epilogue's
// tensors `epi` 8-byte aligned; vec_b only with pair).
struct Access {
  bool vec_a, vec_b, pair;
};

inline Access access(const float* A, const float* B, int K, int h,
                     std::initializer_list<const void*> epi) {
  bool pair = h % 2 == 0;
  for (const void* p : epi) pair = pair && aligned(p, 8);
  return {K % 4 == 0 && aligned(A, 16),
          pair && h % 4 == 0 && aligned(B, 16), pair};
}

// pick(vec_a, vec_b, pair), each a std::bool_constant: the kernel instance
// that takes a's accesses.
template <class Pick>
auto instance(const Access& a, Pick pick) {
  using T = std::true_type;
  using F = std::false_type;
  if (a.vec_b) return a.vec_a ? pick(T(), T(), T()) : pick(F(), T(), T());
  if (a.pair) return a.vec_a ? pick(T(), F(), T()) : pick(F(), F(), T());
  return a.vec_a ? pick(T(), F(), F()) : pick(F(), F(), F());
}

// ---- the paired GEMM: forward and data gradient --------------------------

// The column pair (j, j + 1) of a row: one 8-byte access when kPair (j
// even, rows of even length, 8-byte aligned base), else one or two 4-byte
// ones (the second while `two`).
template <bool kPair>
__device__ __forceinline__ float2 load2(const float* p, bool two) {
  if (kPair) return *reinterpret_cast<const float2*>(p);
  return make_float2(p[0], two ? p[1] : 0.f);
}

template <bool kPair>
__device__ __forceinline__ void store2(float* p, float2 v, bool two) {
  if (kPair) {
    *reinterpret_cast<float2*>(p) = v;
  } else {
    p[0] = v.x;
    if (two) p[1] = v.y;
  }
}

// The Gabor activation of one unit, as paired_gemm_kernel forms it.
__device__ __forceinline__ void gabor(float zr, float zi, float omega,
                                      float s2, float& ar, float& ai) {
  const float m = expf(-omega * zi - s2 * (zr * zr + zi * zi));
  float sn, cs;
  sincosf(omega * zr, &sn, &cs);
  ar = m * cs;
  ai = m * sn;
}

// out = A (n x K) @ B (K x 2h) on the column pairs (j, h + j) of this tile's
// units, then the epilogue (wire_gemm.cuh:paired_gemm_kernel's, the same
// float operations in the same order):
//   kFwd:      z = out + bias; out0 = z (n x 2h) unless null; out1 =
//              Gabor(z) (n x 2h)
//   kBwd:      out = dL/d(layer output); out0 = dL/dz (n x 2h), act the
//              layer's output, zin its pre-activation (n x 2h)
//   kBwdFirst: as kBwd for the real first layer; zin = z1 (n x h), out0 =
//              dL/dz1 (n x h)
// kVecA, kVecB: 16-byte copies of A and B (Access); kPair: 8-byte
// epilogue accesses (h even, the epilogue's tensors 8-byte aligned).
// kReps: replica blockIdx.z, A (n x K), B (K x 2h), bias (2h) and the
// epilogue's tensors each at the replica's own offset.
template <int kMode, bool kVecA, bool kVecB, bool kPair, bool kReps>
__global__ void __launch_bounds__(kThreads, 2) tc_paired_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ bias, const float* __restrict__ act,
    const float* __restrict__ zin, float* __restrict__ out0,
    float* __restrict__ out1, int n, int K, int h, float omega, float s2) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int unit0 = blockIdx.x * kUnits;
  const int row0 = blockIdx.y * kBM;
  const int h2 = 2 * h;

  if (kReps) {
    A += (size_t)blockIdx.z * n * K;
    B += (size_t)blockIdx.z * K * h2;
  }
  float acc[kMT][kNT][4];
  tile_product<kPaired, kVecA, kVecB>(smem, A, B, h2, n, K, row0, unit0, h,
                                      acc);
  if (kReps) {
    const size_t rep = blockIdx.z;
    const size_t wide = (size_t)n * h2;
    const size_t narrow = kMode == kBwdFirst ? (size_t)n * h : wide;
    if (bias != nullptr) bias += rep * h2;
    if (act != nullptr) act += rep * wide;
    if (zin != nullptr) zin += rep * narrow;
    if (out0 != nullptr) out0 += rep * (kMode == kFwd ? wide : narrow);
    if (out1 != nullptr) out1 += rep * wide;
  }

  const int g = lane / 4, t = lane % 4;
  constexpr int kHalf = kNT / 2;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kHalf; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        // accumulators 2 hr, 2 hr + 1: row g + 8 hr, columns 2t, 2t + 1
        const int r = row0 + wm * (kMT * 16) + mt * 16 + g + hr * 8;
        const int j = unit0 + wn * (kHalf * 8) + nt * 8 + 2 * t;
        if (r >= n || j >= h) continue;
        const bool two = j + 1 < h;
        const size_t base = (size_t)r * h2;
        const float2 xr = make_float2(acc[mt][nt][2 * hr],
                                      acc[mt][nt][2 * hr + 1]);
        const float2 xi = make_float2(acc[mt][nt + kHalf][2 * hr],
                                      acc[mt][nt + kHalf][2 * hr + 1]);
        if (kMode == kFwd) {
          const float2 br = load2<kPair>(bias + j, two);
          const float2 bi = load2<kPair>(bias + h + j, two);
          const float2 zr = make_float2(xr.x + br.x, xr.y + br.y);
          const float2 zi = make_float2(xi.x + bi.x, xi.y + bi.y);
          if (out0 != nullptr) {
            store2<kPair>(out0 + base + j, zr, two);
            store2<kPair>(out0 + base + h + j, zi, two);
          }
          float2 ar, ai;
          gabor(zr.x, zi.x, omega, s2, ar.x, ai.x);
          gabor(zr.y, zi.y, omega, s2, ar.y, ai.y);
          store2<kPair>(out1 + base + j, ar, two);
          store2<kPair>(out1 + base + h + j, ai, two);
        } else {
          // activation-form Gabor backward (wire_gemm.cuh:107-121):
          //   t1 = dar*ar + dai*ai, t2 = dai*ar - dar*ai
          //   dzr = -2 s^2 zr t1 + w t2,  dzi = (-w - 2 s^2 zi) t1
          const float2 ar = load2<kPair>(act + base + j, two);
          const float2 ai = load2<kPair>(act + base + h + j, two);
          const float2 t1 = make_float2(xr.x * ar.x + xi.x * ai.x,
                                        xr.y * ar.y + xi.y * ai.y);
          const float2 t2 = make_float2(xi.x * ar.x - xr.x * ai.x,
                                        xi.y * ar.y - xr.y * ai.y);
          if (kMode == kBwd) {
            const float2 zr = load2<kPair>(zin + base + j, two);
            const float2 zi = load2<kPair>(zin + base + h + j, two);
            store2<kPair>(out0 + base + j,
                         make_float2((-2.f * s2) * zr.x * t1.x + omega * t2.x,
                                     (-2.f * s2) * zr.y * t1.y + omega * t2.y),
                         two);
            store2<kPair>(out0 + base + h + j,
                         make_float2((-omega - (2.f * s2) * zi.x) * t1.x,
                                     (-omega - (2.f * s2) * zi.y) * t1.y),
                         two);
          } else {
            const size_t idx = (size_t)r * h + j;
            const float2 z = load2<kPair>(zin + idx, two);
            store2<kPair>(out0 + idx,
                         make_float2((-2.f * s2) * z.x * t1.x + omega * t2.x,
                                     (-2.f * s2) * z.y * t1.y + omega * t2.y),
                         two);
          }
        }
      }
}

// The instance of tc_paired_kernel<kMode, ..., kReps> that takes a's
// accesses.
template <int kMode, bool kReps>
auto paired_kernel(const Access& a) {
  return instance(a, [](auto va, auto vb, auto pr) {
    return &tc_paired_kernel<kMode, decltype(va)::value, decltype(vb)::value,
                             decltype(pr)::value, kReps>;
  });
}

template <int kMode>
cudaError_t paired(const float* A, const float* B, const float* bias,
                   const float* act, const float* zin, float* out0,
                   float* out1, int n, int K, int h, float omega, float s2,
                   cudaStream_t st, int reps = 1) {
  const dim3 grid(ceil_div(h, kUnits), ceil_div(n, kBM), reps);
  const Access a = access(A, B, K, h, {bias, act, zin, out0, out1});
  auto kernel = reps > 1 ? paired_kernel<kMode, true>(a)
                         : paired_kernel<kMode, false>(a);
  GEMM_CHECK(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes));
  kernel<<<grid, kThreads, kSmemBytes, st>>>(A, B, bias, act, zin, out0,
                                             out1, n, K, h, omega, s2);
  return cudaGetLastError();
}

// ---- the weight gradient -------------------------------------------------

// Per-chunk partial of [X^T D; colsum(D)] over the rows of chunk z:
// X (n x M), D (n x N); the partial is an (M + 1) x N block whose last row
// (the bias gradient) the blocks of the first M tile sum in row order from
// the staged D tiles.  kVec: 16-byte copies (M % 4 == 0, N % 4 == 0, X
// and D 16-byte aligned).  kReps: blockIdx.z = replica x chunks + chunk,
// X (unless x_shared) and D at the replica's offsets (its partials follow
// its predecessors').
template <bool kVec, bool kReps>
__global__ void __launch_bounds__(kThreads, 2) tc_wgrad_kernel(
    const float* __restrict__ X, const float* __restrict__ D,
    float* __restrict__ part, int n, int M, int N, int x_shared) {
  extern __shared__ __align__(16) float smem[];
  float(*As)[kStageA] = reinterpret_cast<float(*)[kStageA]>(smem);
  float(*Bs)[kStageB] =
      reinterpret_cast<float(*)[kStageB]>(smem + kStages * kStageA);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int i0 = blockIdx.x * kBM, j0 = blockIdx.y * kBN;
  int chunk = blockIdx.z;
  if (kReps) {
    const int chunks = (n + kChunkRows - 1) / kChunkRows;
    chunk = blockIdx.z % chunks;
    if (!x_shared) X += (size_t)(blockIdx.z / chunks) * n * M;
    D += (size_t)(blockIdx.z / chunks) * n * N;
  }
  const int r_begin = chunk * kChunkRows;
  const int r_end = min(n, r_begin + kChunkRows);
  const int ktiles = (r_end - r_begin + kBK - 1) / kBK;
  const bool bias_row = blockIdx.x == 0;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
  float colsum = 0.f;

  const StageKN<kBM, kLdKM, kVec, kPlain> stage_x(X, M, i0, M, 0);
  const StageKN<kBN, kLdKN, kVec, kPlain> stage_d(D, N, j0, N, 0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) {
      stage_x(As[s], r_begin + s * kBK, r_end);
      stage_d(Bs[s], r_begin + s * kBK, r_end);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait_ring();
    __syncthreads();
    const int nk = kt + kStages - 1;
    if (nk < ktiles) {
      const int s = nk % kStages;
      stage_x(As[s], r_begin + nk * kBK, r_end);
      stage_d(Bs[s], r_begin + nk * kBK, r_end);
    }
    cp_async_commit();
    const int s = kt % kStages;
    if (bias_row && threadIdx.x < kBN) {
#pragma unroll
      for (int k = 0; k < kBK; ++k) colsum += Bs[s][k * kLdKN + threadIdx.x];
    }
    slice_product<true, kPlain>(As[s], Bs[s], wm, wn, acc);
  }

  // replica r's partial of chunk c: r x chunks + c = blockIdx.z
  const size_t block = (size_t)blockIdx.z * (M + 1) * N;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + wm * (kMT * 16) + mt * 16 + g + (c / 2) * 8;
        const int j = j0 + tile_col<kPlain>(wn, nt) + 2 * t + c % 2;
        if (i < M && j < N) part[block + (size_t)i * N + j] = acc[mt][nt][c];
      }
  if (bias_row && threadIdx.x < kBN && j0 + (int)threadIdx.x < N)
    part[block + (size_t)M * N + j0 + threadIdx.x] = colsum;
}

// [X^T D; colsum(D)] over all n rows into out ((M + 1) x N), through the
// chunk partials in `part` (wgrad_part_floats) summed in chunk order.  With
// `colscale` (N), the first M rows come out multiplied by it per column
// (gemm_common::reduce_chunks), the bias row stays colsum(D).  For `reps`
// replicas X (unless x_shared), D, part, out and colscale hold reps of
// their own.
inline cudaError_t weight_grad(const float* X, const float* D, float* part,
                               float* out, int n, int M, int N,
                               cudaStream_t st,
                               const float* colscale = nullptr,
                               int reps = 1, int x_shared = 0) {
  const int chunks = ceil_div(n, kChunkRows);
  const dim3 grid(ceil_div(M, kBM), ceil_div(N, kBN), chunks * reps);
  const bool vec =
      M % 4 == 0 && N % 4 == 0 && aligned(X, 16) && aligned(D, 16);
  auto kernel = reps > 1
      ? (vec ? tc_wgrad_kernel<true, true> : tc_wgrad_kernel<false, true>)
      : (vec ? tc_wgrad_kernel<true, false> : tc_wgrad_kernel<false, false>);
  GEMM_CHECK(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes));
  kernel<<<grid, kThreads, kSmemBytes, st>>>(X, D, part, n, M, N,
                                             x_shared);
  GEMM_CHECK(cudaGetLastError());
  return gemm_common::reduce_chunks(part, chunks, (M + 1) * N, out, st,
                                    colscale, N, M, reps);
}

inline long long wgrad_part_floats(int n, int M, int N) {
  return (long long)ceil_div(n, kChunkRows) * (M + 1) * N;
}

// ---- the narrow weight gradients: first and final layer ----------------

constexpr int kNarrowMax = 8;    // columns of the narrow operand
constexpr int kNarrowCols = 32;  // wide columns per block (one warp's row)
constexpr int kNarrowGroups = 8;  // row groups per block
constexpr int kNarrowChunkRows = 512;

// Per-chunk partial of [X^T D; colsum(D)] (an (M + 1) x N block) when one
// operand is narrow: the final layer's X = a_L (n x 2h), D = g (n x o), and
// the first layer's X = coords (n x d), D = dz1 (n x h).  A block takes 32
// columns of the wide operand (a warp reads one row of them) and the
// chunk's rows in 8 interleaved groups; each thread walks its rows in order
// with the narrow row at hand, and the 8 group sums meet in group order in
// shared memory, so the sums' order is fixed.  kWideX: out[w][c] = sum
// X[r][w] D[r][c] (the bias row, sum D[r][c], is narrow_colsum_kernel's);
// else out[c][w] = sum X[r][c] D[r][w] and the bias row sum D[r][w].
// Memory-bound (one read of the wide operand), on the CUDA cores.
// kReps: replica blockIdx.z, X shared by the replicas when x_shared.
template <bool kWideX, bool kReps>
__global__ void __launch_bounds__(kNarrowCols * kNarrowGroups)
    narrow_wgrad_kernel(const float* __restrict__ X,
                        const float* __restrict__ D, float* __restrict__ part,
                        int n, int M, int N, int x_shared) {
  __shared__ float sums[kNarrowGroups][kNarrowMax + 1][kNarrowCols];
  if (kReps) {
    if (!x_shared) X += (size_t)blockIdx.z * n * M;
    D += (size_t)blockIdx.z * n * N;
  }
  const int lx = threadIdx.x, grp = threadIdx.y;
  const int w = blockIdx.x * kNarrowCols + lx;
  const int chunk = blockIdx.y;
  const int r_begin = chunk * kNarrowChunkRows;
  const int r_end = min(n, r_begin + kNarrowChunkRows);
  const int wide = kWideX ? M : N, narrow = kWideX ? N : M;
  const bool live = w < wide;
  float acc[kNarrowMax + 1];  // the narrow columns, then the bias sum
#pragma unroll
  for (int c = 0; c <= kNarrowMax; ++c) acc[c] = 0.f;
  if (live) {
#pragma unroll 4
    for (int r = r_begin + grp; r < r_end; r += kNarrowGroups) {
      if (kWideX) {
        const float x = X[(size_t)r * M + w];
        const float* d = D + (size_t)r * N;
#pragma unroll
        for (int c = 0; c < kNarrowMax; ++c) {
          if (c >= narrow) break;
          const float dv = __ldg(d + c);
          acc[c] = fmaf(x, dv, acc[c]);
        }
      } else {
        const float dv = D[(size_t)r * N + w];
        const float* x = X + (size_t)r * M;
#pragma unroll
        for (int c = 0; c < kNarrowMax; ++c) {
          if (c >= narrow) break;
          acc[c] = fmaf(__ldg(x + c), dv, acc[c]);
        }
        acc[kNarrowMax] += dv;
      }
    }
  }
#pragma unroll
  for (int c = 0; c <= kNarrowMax; ++c) sums[grp][c][lx] = acc[c];
  __syncthreads();
  if (grp != 0 || !live) return;
  // replica blockIdx.z's partials follow its predecessors'
  float* out = part + (kReps ? (size_t)blockIdx.z * gridDim.y + chunk
                             : (size_t)chunk) * (M + 1) * N;
#pragma unroll
  for (int c = 0; c <= kNarrowMax; ++c) {
    if (c < narrow || c == kNarrowMax) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kNarrowGroups; ++q) s += sums[q][c][lx];
      if (c == kNarrowMax) {
        if (!kWideX) out[(size_t)M * N + w] = s;
      } else if (kWideX) {
        out[(size_t)w * N + c] = s;
      } else {
        out[(size_t)c * N + w] = s;
      }
    }
  }
}

// The bias row of the kWideX case, colsum(D) of the narrow D (n x N): one
// warp per narrow column, lanes striding the chunk's rows and meeting in a
// fixed butterfly; replica blockIdx.y.
__global__ void narrow_colsum_kernel(const float* __restrict__ D,
                                     float* __restrict__ part, int n, int M,
                                     int N) {
  D += (size_t)blockIdx.y * n * N;
  part += (size_t)blockIdx.y * gridDim.x * (M + 1) * N;
  const int c = threadIdx.y, lane = threadIdx.x;
  const int chunk = blockIdx.x;
  const int r_begin = chunk * kNarrowChunkRows;
  const int r_end = min(n, r_begin + kNarrowChunkRows);
  float s = 0.f;
  for (int r = r_begin + lane; r < r_end; r += 32) s += D[(size_t)r * N + c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) part[(size_t)chunk * (M + 1) * N + (size_t)M * N + c] = s;
}

// [X^T D; colsum(D)] into out ((M + 1) x N) for a narrow X (M <=
// kNarrowMax) or D (N <= kNarrowMax), through chunk partials in `part`
// (narrow_part_floats) summed in chunk order; `colscale` as weight_grad's.
// For `reps` replicas X (unless x_shared), D, part and out hold reps of
// their own.
inline cudaError_t narrow_weight_grad(const float* X, const float* D,
                                      float* part, float* out, int n, int M,
                                      int N, cudaStream_t st,
                                      const float* colscale = nullptr,
                                      int reps = 1, int x_shared = 0) {
  if (M > kNarrowMax && N > kNarrowMax) return cudaErrorInvalidValue;
  const int chunks = ceil_div(n, kNarrowChunkRows);
  const bool wide_x = N <= kNarrowMax && M > N;
  const dim3 grid(ceil_div(wide_x ? M : N, kNarrowCols), chunks, reps);
  const dim3 block(kNarrowCols, kNarrowGroups);
  if (wide_x) {
    auto kernel = reps > 1 ? narrow_wgrad_kernel<true, true>
                           : narrow_wgrad_kernel<true, false>;
    kernel<<<grid, block, 0, st>>>(X, D, part, n, M, N, x_shared);
    GEMM_CHECK(cudaGetLastError());
    narrow_colsum_kernel<<<dim3(chunks, reps), dim3(32, N), 0, st>>>(
        D, part, n, M, N);
  } else {
    auto kernel = reps > 1 ? narrow_wgrad_kernel<false, true>
                           : narrow_wgrad_kernel<false, false>;
    kernel<<<grid, block, 0, st>>>(X, D, part, n, M, N, x_shared);
  }
  GEMM_CHECK(cudaGetLastError());
  return gemm_common::reduce_chunks(part, chunks, (M + 1) * N, out, st,
                                    colscale, N, M, reps);
}

inline long long narrow_part_floats(int n, int M, int N) {
  return (long long)ceil_div(n, kNarrowChunkRows) * (M + 1) * N;
}

}  // namespace wire_tc
