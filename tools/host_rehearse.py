#!/usr/bin/env python3
"""Run a CUDA source of wire_tpu_torch/csrc on the host, without nvcc or a
card, at tiny shapes, against its plain PyTorch version.

    python3 tools/host_rehearse.py wire_mlp rotsum line_sample wire_step \
        mscale2_step wire2d mfn real

The source (``csrc/<name>.cu`` and the headers it includes) is rewritten
into a copy and built by g++ into a host library with a plain C interface,
the same interface nvcc's library has, so the ops wrapper can drive it on
CPU tensors:

- a stub ``cuda_runtime.h`` maps ``__global__``/``__device__`` to nothing,
  ``__shared__`` to ``static`` (blocks run one after another),
  ``__syncthreads`` to a barrier over the block's threads, and
  ``__shfl_xor_sync`` to a per-warp barrier and buffer;
- ``k<<<grid, block, smem, stream>>>(args)`` becomes a call that runs every
  block in turn with one ``std::thread`` per CUDA thread (a thread that
  returns early drops out of the barriers);
- ``extern __shared__`` (dynamic shared memory) becomes one static buffer;
- the inline PTX of ``wire_tc.cuh`` lives in small functions whose bodies
  are replaced: ``mma_tf32`` by a per-lane emulation of
  the m16n8k8 fragment layout under the warp barrier (each lane posts its
  a0..a3, b0, b1 and c0..c3 into the warp's 16 x 8, 8 x 8 and 16 x 8
  matrices, the warp meets, each lane sums its own four outputs in k
  order), and the ``cp.async`` ring by synchronous copies with the same
  zero fill.

The emulated mma encodes the fragment layout as the PTX manual states it:
A (16 x 8) a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B
(8 x 8) b0 (t, g), b1 (t + 4, g); C c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8,
2t), c3 (g + 8, 2t + 1), for lane = 4 g + t.  A kernel that indexes its
fragments otherwise fails here as it would on the card.
"""
import contextlib
import ctypes
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "wire_tpu_torch", "csrc")

STUB = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <tuple>
#include <vector>
using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(x) __attribute__((aligned(x)))
#define __restrict__ __restrict

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct __attribute__((aligned(16))) float4 { float x, y, z, w; };
struct __attribute__((aligned(8))) float2 { float x, y; };
inline float2 make_float2(float x, float y) { return float2{x, y}; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
inline int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
// global-memory atomics: one mutex over every thread of the launch
inline std::mutex stub_atomic_mutex;
inline float atomicAdd(float* p, float v) {
  std::lock_guard<std::mutex> lock(stub_atomic_mutex);
  const float old = *p;
  *p = old + v;
  return old;
}
inline float2 atomicAdd(float2* p, float2 v) {
  std::lock_guard<std::mutex> lock(stub_atomic_mutex);
  const float2 old = *p;
  p->x = old.x + v.x;
  p->y = old.y + v.y;
  return old;
}
inline const char* cudaGetErrorString(cudaError_t) { return "host stub"; }

struct StubBlock {
  explicit StubBlock(int nt) : bar(nt) {
    for (int w = 0; w * 32 < nt; ++w)
      warp_bar.emplace_back(new std::barrier<>(std::min(32, nt - 32 * w)));
  }
  std::barrier<> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  float shfl[64][32];
  float mA[64][16][8], mB[64][8][8], mC[64][16][8];
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline thread_local StubBlock* stub_blk;
inline thread_local int stub_tid;

inline void __syncthreads() { stub_blk->bar.arrive_and_wait(); }
inline void stub_warp_sync() {
  stub_blk->warp_bar[stub_tid / 32]->arrive_and_wait();
}
inline float __shfl_xor_sync(unsigned, float v, int off) {
  const int w = stub_tid / 32, l = stub_tid % 32;
  stub_blk->shfl[w][l] = v;
  stub_warp_sync();
  const float r = stub_blk->shfl[w][l ^ off];
  stub_warp_sync();
  return r;
}
template <class T>
inline T __ldg(const T* p) { return *p; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline void stub_mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                          const uint32_t (&b)[2]) {
  const int w = stub_tid / 32, lane = stub_tid % 32;
  const int g = lane / 4, t = lane % 4;
  auto& A = stub_blk->mA[w];
  auto& B = stub_blk->mB[w];
  auto& C = stub_blk->mC[w];
  A[g][t] = __uint_as_float(a[0]);
  A[g + 8][t] = __uint_as_float(a[1]);
  A[g][t + 4] = __uint_as_float(a[2]);
  A[g + 8][t + 4] = __uint_as_float(a[3]);
  B[t][g] = __uint_as_float(b[0]);
  B[t + 4][g] = __uint_as_float(b[1]);
  C[g][2 * t] = d[0];
  C[g][2 * t + 1] = d[1];
  C[g + 8][2 * t] = d[2];
  C[g + 8][2 * t + 1] = d[3];
  stub_warp_sync();
  const int rows[4] = {g, g, g + 8, g + 8};
  const int cols[4] = {2 * t, 2 * t + 1, 2 * t, 2 * t + 1};
  float out[4];
  for (int i = 0; i < 4; ++i) {
    float s = C[rows[i]][cols[i]];
    for (int k = 0; k < 8; ++k) s += A[rows[i]][k] * B[k][cols[i]];
    out[i] = s;
  }
  stub_warp_sync();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}
inline void stub_cp_async(float* smem, const float* gmem, bool valid,
                          bool vec) {
  const int nb = vec ? 16 : 4;
  if (valid) std::memcpy(smem, gmem, nb);
  else std::memset(smem, 0, nb);
}

template <class... P, class... A>
void stub_launch(dim3 grid, dim3 block, void (*k)(P...), A... a) {
  std::tuple<P...> args(static_cast<P>(a)...);
  const int nt = block.x * block.y * block.z;
  blockDim = block;
  gridDim = grid;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        auto blk = std::make_unique<StubBlock>(nt);
        std::vector<std::thread> th;
        for (int i = 0; i < nt; ++i)
          th.emplace_back([&, i] {
            stub_tid = i;
            stub_blk = blk.get();
            threadIdx = dim3(i % block.x, (i / block.x) % block.y,
                             i / (block.x * block.y));
            blockIdx = dim3(bx, by, bz);
            std::apply(k, args);
            blk->bar.arrive_and_drop();
            blk->warp_bar[i / 32]->arrive_and_drop();
          });
        for (auto& x : th) x.join();
      }
}
"""

# host bodies of the inline-PTX functions of csrc/wire_tc.cuh
PTX_BODIES = {
    "mma_tf32": "{ stub_mma_tf32(d, a, b); }",
    "cp_async": "{ stub_cp_async(smem, gmem, valid, vec); }",
    "cp_async_commit": "{}",
    "cp_async_wait_ring": "{}",
}


def _split_top(s):
    """Split at top-level commas."""
    parts, depth, cur = [], 0, ""
    for ch in s:
        depth += (ch in "([{") - (ch in ")]}")
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    parts.append(cur)
    return [p.strip() for p in parts]


def _rewrite_launches(src):
    out, pos = "", 0
    for m in re.finditer(r"([\w:]+(?:<[^<>;()]*>)?)\s*<<<(.*?)>>>\s*\(",
                         src, re.S):
        cfg = _split_top(m.group(2))
        out += src[pos:m.start()]
        out += (f"stub_launch(dim3({cfg[0]}), dim3({cfg[1]}), "
                f"{m.group(1)}, ")
        pos = m.end()
    return out + src[pos:]


def _replace_body(src, fname, body):
    m = re.search(r"\bvoid\s+" + fname + r"\s*\(", src)
    if m is None:
        return src
    i = src.index("{", m.end())
    depth, j = 0, i
    while True:
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        j += 1
        if depth == 0:
            break
    return src[:i] + body + src[j:]


def build_host(name, out_dir):
    """Rewrite csrc/<name>.cu and its headers into out_dir and build the
    host library; returns its path."""
    src_dir = os.path.join(out_dir, "csrc")
    os.makedirs(src_dir, exist_ok=True)
    with open(os.path.join(src_dir, "cuda_runtime.h"), "w") as f:
        f.write(STUB)
    for fname in os.listdir(CSRC):
        if not fname.endswith((".cu", ".cuh")):
            continue
        with open(os.path.join(CSRC, fname)) as f:
            text = _rewrite_launches(f.read())
        # dynamic shared memory: one static buffer (blocks run in turn)
        text = re.sub(r"extern __shared__ __align__\((\d+)\) float (\w+)\[\];",
                      r"static __attribute__((aligned(\1))) float \2[1 << 16];",
                      text)
        for fn, body in PTX_BODIES.items():
            text = _replace_body(text, fn, body)
        with open(os.path.join(src_dir, fname), "w") as f:
            f.write(text)
    lib = os.path.join(out_dir, f"{name}_host.so")
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off",
                    "-pthread", "-shared", "-fPIC", "-x", "c++",
                    "-I", src_dir, "-o", lib,
                    os.path.join(src_dir, f"{name}.cu")], check=True)
    return lib


@contextlib.contextmanager
def host_library(name, out_dir):
    """Within the block, ``build.load(name)`` gives the host library and
    ``torch.cuda.current_stream`` a null stream, so an ops wrapper's launch
    functions run on CPU tensors."""
    import torch
    from wire_tpu_torch.ops import build

    lib = ctypes.CDLL(build_host(name, out_dir))
    load, stream = build.load, torch.cuda.current_stream

    class _Stream:
        cuda_stream = 0

    build.load = lambda n: lib if n == name else load(n)
    torch.cuda.current_stream = lambda device=None: _Stream()
    try:
        yield lib
    finally:
        build.load, torch.cuda.current_stream = load, stream


def _max_rel(got, want):
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(got, want))


def rehearse_wire_mlp(out_dir):
    import numpy as np
    import torch
    from wire_tpu_torch.nn.registry import get_inr
    from wire_tpu_torch.ops import wire_mlp as WM

    WM._lib.cache_clear()
    with host_library("wire_mlp", out_dir):
        for n, hf, L, o in ((300, 7, 2, 1), (130, 19, 1, 3), (200, 60, 3, 1),
                            (150, 29, 0, 2), (261, 300, 1, 1),
                            (2100, 7, 1, 1)):
            model = get_inr("wire", in_features=2, out_features=o,
                            hidden_features=hf, hidden_layers=L,
                            first_omega0=3.0, hidden_omega0=3.0, scale=12.0)
            spec = model.spec
            params = model.init(torch.Generator().manual_seed(n), "cpu")
            rng = np.random.default_rng(n)
            c = torch.tensor(rng.uniform(-1, 1, (n, 2)).astype(np.float32))
            g = torch.tensor(rng.normal(size=(n, o)).astype(np.float32))
            keys = tuple((k, kk) for k in params for kk in params[k])
            outs = []
            for fn in ("kernel", "plain"):
                leaves = [params[k][kk].clone().requires_grad_(True)
                          for k, kk in keys]
                x = c.clone().requires_grad_(True)
                if fn == "kernel":
                    y = WM._WireMLP.apply(x, spec, keys, *leaves)
                else:
                    p = {k: {} for k in params}
                    for (k, kk), leaf in zip(keys, leaves):
                        p[k][kk] = leaf
                    y = WM.wire_mlp_plain(p, x, spec)
                grads = torch.autograd.grad(y, leaves + [x], g,
                                            allow_unused=True)
                outs.append([y.detach()] + [
                    torch.zeros_like(v) if gr is None else gr
                    for v, gr in zip(leaves + [x], grads)])
            with torch.no_grad():
                y0 = WM._forward_nograd(params, c, spec)
            rel = _max_rel(outs[0], outs[1])
            same = torch.equal(y0, outs[0][0])
            print(f"wire_mlp n {n} hf {hf} L {L} o {o}: max rel err "
                  f"{rel:.2e}, no-grad forward equal: {same}", flush=True)
            assert rel <= 1e-4 and same, (rel, same)


def rehearse_rotsum(out_dir):
    import numpy as np
    import torch
    from wire_tpu_torch.ops import rotsum as R

    R._lib.cache_clear()
    angles = np.array([0.0, 7.3, 44.9, 45.1, 90.0, 121.7, 180.0, -13.4,
                       200.0, 315.0], np.float32)
    with host_library("rotsum", out_dir):
        for H, W in ((24, 24), (17, 17), (16, 22), (21, 12)):
            rng = np.random.default_rng(H * W)
            img = torch.tensor(rng.random((H, W)).astype(np.float32))
            cot = torch.tensor(rng.normal(size=(len(angles), W)).astype(
                np.float32))
            parts = R.angle_parts_tensor(angles, H == W, "cpu")
            outs = []
            for fn in ("kernel", "plain"):
                x = img.clone().requires_grad_(True)
                y = (R._RotateProject.apply(x, parts) if fn == "kernel"
                     else R.rotate_project_plain(x, angles))
                (gx,) = torch.autograd.grad(y, x, cot)
                outs.append((y.detach(), gx))
            rel = _max_rel(outs[0], outs[1])
            # <R x, y> = <x, R^T y>
            lhs = float((outs[0][0].double() * cot.double()).sum())
            rhs = float((img.double() * outs[0][1].double()).sum())
            dot = abs(lhs - rhs) / abs(lhs)
            print(f"rotsum {H} x {W}: max rel err {rel:.2e}, dot-product "
                  f"test {dot:.1e}", flush=True)
            assert rel <= 1e-4 and dot <= 1e-5, (rel, dot)


# (P, A) of the line_sample rehearsal: even and odd P, K = P // 2 + 1
LINE_SAMPLE_CASES = ((8, 5), (9, 4), (16, 7), (27, 6))


def line_sample_case(P, A, seed):
    """The inputs of the spectrum gather/scatter pair at P: a random
    unshifted complex spectrum, operators/radon.py's tables for A angles
    over [0, 180] (at 0 and 90 degrees the even-P samples reach the Nyquist
    line, position P) with a last row of positions on lines P and P + 1
    put in by hand, and a random complex cotangent."""
    import numpy as np
    import torch
    from wire_tpu_torch.operators import radon as TR

    rng = np.random.default_rng(seed)
    angles = np.linspace(0, 180, A, dtype=np.float32)
    centre, gy, gx, uncentre = TR._fourier_consts(P, angles, "cpu")
    K = gy.shape[1]
    edge = torch.tensor(rng.uniform(0, P + 1, (2, K)).astype(np.float32))
    edge[0, :3] = torch.tensor([P, P + 0.5, P - 0.25])
    edge[1, 3:5] = torch.tensor([P + 0.75, P])
    gy = torch.cat([gy, edge[:1]]).contiguous()
    gx = torch.cat([gx, edge[1:]]).contiguous()

    def cplx(shape):
        return torch.complex(*(torch.tensor(rng.normal(size=shape).astype(
            np.float32)) for _ in range(2)))
    return cplx((P, P)), centre, gy, gx, uncentre, cplx(tuple(gy.shape))


def line_sample_vs_plain(P, A, seed):
    """Max over the slice and the spectrum's gradient of max |kernel -
    plain| / max |plain|, the kernels run through the wrapper's C interface
    (``_SampleSpectrum``; inside host_library("line_sample", ...))."""
    import torch
    from wire_tpu_torch.ops import line_sample as LS

    F, centre, gy, gx, uncentre, cot = line_sample_case(P, A, seed)
    outs = []
    for fn in (LS._SampleSpectrum.apply, LS.sample_spectrum_plain):
        x = F.clone().requires_grad_(True)
        y = fn(x, centre, gy, gx, uncentre)
        (g,) = torch.autograd.grad(y, x, cot)
        outs.append((torch.view_as_real(y.detach()), torch.view_as_real(g)))
    return _max_rel(outs[0], outs[1])


def rehearse_line_sample(out_dir):
    from wire_tpu_torch.ops import line_sample as LS

    LS._lib.cache_clear()
    try:
        with host_library("line_sample", out_dir):
            for P, A in LINE_SAMPLE_CASES:
                before = dict(LS.launches)
                rel = line_sample_vs_plain(P, A, P)
                ran = {k: LS.launches[k] - before[k] for k in before}
                print(f"line_sample P {P} A {A}: max rel err {rel:.2e}, "
                      f"launches {ran}", flush=True)
                assert rel <= 1e-5 and ran == {"gather": 1, "scatter": 1}, (
                    rel, ran)
    finally:
        LS._lib.cache_clear()


def rehearse_wire_step(out_dir):
    """wire_step (the WIRE train step on wire_tc.cuh's chains) against its
    plain version at tiny shapes: ragged n (several 512- and 1,024-row
    chunks of the weight gradients), h not a multiple of 4, L 0-2, o 1-3,
    nvalid and denom, and two calls bit-equal."""
    import numpy as np
    import torch
    from wire_tpu_torch.nn.registry import get_inr
    from wire_tpu_torch.ops import wire_step as WS

    WS._lib.cache_clear()
    with host_library("wire_step", out_dir):
        for n, hf, L, o, nvalid, denom in (
                (300, 7, 2, 3, 290, 901.5), (130, 19, 1, 1, None, None),
                (150, 29, 0, 2, None, None), (261, 300, 1, 3, 200, None),
                (2100, 7, 1, 3, 2049, 6000.0)):
            model = get_inr("wire", in_features=2, out_features=o,
                            hidden_features=hf, hidden_layers=L,
                            first_omega0=7.0, hidden_omega0=7.0, scale=8.0)
            params = model.init(torch.Generator().manual_seed(n), "cpu")
            rng = np.random.default_rng(n)
            c, t, gt = (torch.tensor(a.astype(np.float32)) for a in (
                rng.uniform(-1, 1, (n, 2)), rng.uniform(0, 1, (n, o)),
                rng.uniform(0, 1, (n, o))))
            outs = [WS._launch(params, c, t, model.spec, nvalid, denom, gt,
                               True, None) for _ in range(2)]
            want = WS.wire_step_plain(params, c, t, model.spec,
                                      nvalid=nvalid, denom=denom, gt=gt,
                                      want_metrics=True)
            flat = [_step_tensors(o_) for o_ in outs + [want]]
            rel = _max_rel(flat[0], flat[2])
            same = all(torch.equal(a, b) for a, b in zip(flat[0], flat[1]))
            print(f"wire_step n {n} hf {hf} L {L} o {o} nvalid {nvalid}: "
                  f"max rel err {rel:.2e}, two calls equal: {same}",
                  flush=True)
            assert rel <= 1e-4 and same, (rel, same)


def _step_tensors(out):
    """pred, every gradient leaf (dicts by key, lists in order), and the
    SSE sums of a step's result tuple."""
    leaves = []

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            leaves.append(x.reshape(-1))
    walk(out)
    return leaves


def rehearse_mscale2_step(out_dir):
    """mscale2_step (the trunk on real_tc.cuh's chain: wire_tc.cuh's loop
    with the real epilogues, the narrow first-layer and top data-gradient
    kernels) against its plain version at tiny shapes where 128-row tiles
    straddle two scales (n = 130, 150, 700 and 800 rows per scale), widths
    that are and are not multiples of 4 (each kernel instance of the copies
    and epilogue accesses), a hidden width of 8 (its products and weight
    gradient on the narrow kernels), the weight gradients over several
    1,024-row chunks and the column sums over two 2,048-row ones, the
    relu^2 spline at gamma 9 and the qspline at 1/8, the sine and gauss
    bases (out of line in the epilogues), nvalid and denom, and two calls
    bit-equal."""
    import numpy as np
    import torch
    from wire_tpu_torch.ops import mscale2_step as MS
    from wire_tpu_torch.ops import real_mlp as RM

    MS._lib.cache_clear()
    with host_library("mscale2_step", out_dir):
        for n, widths, kinds, inv, nvalid, denom in (
                (130, (2, 40, 40, 3), ("qspline",) * 2, (9.0, 0.25, 0.125),
                 None, None),
                (150, (2, 24, 37, 33, 3), ("srelu", "qspline", "srelu"),
                 (9.0, 0.125), 140, 433.5),
                (700, (2, 16, 12, 1), ("qspline", "cspline"), (9.0, 4.0),
                 650, None),
                (800, (2, 64, 8, 48, 3), ("sine", "srelu", "gauss"),
                 (9.0, 0.25, 0.125), 790, None)):
            rng = np.random.default_rng(n)

            def t(a):
                return torch.tensor(np.asarray(a, np.float32))
            canon = {"layers": [{"w": t(rng.uniform(-1, 1, (a, b))
                                        / np.sqrt(a)),
                                 "alpha": t(rng.uniform(0.5, 2.0, b)),
                                 "beta": t(rng.uniform(-1, 1, b))}
                                for a, b in zip(widths[:-2], widths[1:-1])],
                     "final": {"w": t(rng.uniform(-1, 1, widths[-2:])),
                               "b": t(rng.uniform(-1, 1, widths[-1]))}}
            o, ns = widths[-1], len(inv)
            comb = {"freq_0": {"w": t(rng.uniform(-0.5, 0.5, (ns * o, 128))),
                               "b": t(rng.uniform(-0.5, 0.5, 128))},
                    "freq_1": {"w": t(rng.uniform(-0.3, 0.3, (128, o))),
                               "b": t(rng.uniform(-0.5, 0.5, o))}}
            c, tg, gt = (t(a) for a in (rng.uniform(-1, 1, (n, 2)),
                                        rng.uniform(0, 1, (n, o)),
                                        rng.uniform(0, 1, (n, o))))
            kinds = RM.norm_kinds(kinds)
            outs = [MS._launch(canon, comb, c, tg, kinds, inv, nvalid, denom,
                               gt, True, None) for _ in range(2)]
            want = MS.mscale2_step_plain(canon, comb, c, tg, kinds, inv,
                                         nvalid=nvalid, denom=denom, gt=gt,
                                         want_metrics=True)
            flat = [_step_tensors(o_) for o_ in outs + [want]]
            rel = _max_rel(flat[0], flat[2])
            same = all(torch.equal(a, b) for a, b in zip(flat[0], flat[1]))
            print(f"mscale2_step n {n} widths {widths} ns {ns}: max rel err "
                  f"{rel:.2e}, two calls equal: {same}", flush=True)
            assert rel <= 1e-4 and same, (rel, same)


def rehearse_wire2d(out_dir):
    """wire2d_step and the wire2d_mlp pair (csrc/wire2d.cu on wire_tc.cuh's
    loop: the forward's quad tiles, the data gradients' paired tiles)
    against their plain versions at tiny shapes: h = 5, 6, 13 and 16 units
    per head (odd, even, and a multiple of 4: each kernel instance of the
    copies and epilogue accesses), L 0-3, o 1 and 3, ragged n (several
    512- and 1,024-row chunks of the weight gradients), the step with
    nvalid and denom, the pair with and without dcoords and on (4, n/4, 2)
    coordinates flattened as wire2d_mlp flattens them, the pair's forward
    without a gradient; two calls of each bit-equal."""
    import numpy as np
    import torch
    from wire_tpu_torch import tree
    from wire_tpu_torch.nn.registry import get_inr
    from wire_tpu_torch.ops import wire2d as W2

    W2._lib.cache_clear()
    with host_library("wire2d", out_dir):
        for n, h, L, o, nvalid, denom, dcoords, lead, freq in (
                (300, 5, 2, 3, 290, 901.5, True, (), (7.0, 8.0)),
                (130, 13, 1, 1, None, None, False, (), (3.0, 12.0)),
                (200, 16, 3, 1, 150, None, True, (4,), (3.0, 12.0)),
                (150, 13, 0, 3, None, 777.0, True, (), (7.0, 8.0)),
                (261, 6, 2, 1, None, None, False, (3,), (3.0, 12.0)),
                (2100, 5, 1, 3, 2049, 6000.0, True, (), (7.0, 8.0))):
            model = get_inr("wire2d", in_features=2, out_features=o,
                            hidden_features=2 * h, hidden_layers=L,
                            first_omega0=freq[0], hidden_omega0=freq[0],
                            scale=freq[1])
            spec = model.spec
            params = model.init(torch.Generator().manual_seed(n), "cpu")
            rng = np.random.default_rng(n)
            c, t, gt, g = (torch.tensor(a.astype(np.float32)) for a in (
                rng.uniform(-1, 1, (n, 2)), rng.uniform(0, 1, (n, o)),
                rng.uniform(0, 1, (n, o)), rng.normal(size=(n, o))))
            steps = [W2._launch_step(params, c, t, spec, nvalid, denom, gt,
                                     True, None) for _ in range(2)]
            want = W2.wire2d_step_plain(params, c, t, spec, nvalid=nvalid,
                                        denom=denom, gt=gt,
                                        want_metrics=True)
            flat = [_step_tensors(o_) for o_ in steps + [want]]
            rel = _max_rel(flat[0], flat[2])
            same = all(torch.equal(a, b) for a, b in zip(flat[0], flat[1]))
            print(f"wire2d_step n {n} h {h} L {L} o {o} nvalid {nvalid} "
                  f"denom {denom}: max rel err {rel:.2e}, two calls equal: "
                  f"{same}", flush=True)
            assert rel <= 1e-4 and same, (rel, same)

            flat_p = tree.leaves(params)
            paths = tuple(p for p, _ in flat_p)
            cl = c.reshape(*lead, -1, 2) if lead else c
            outs = []
            for fn in ("kernel", "kernel", "plain"):
                leaves = [v.clone().requires_grad_(True) for _, v in flat_p]
                x = cl.clone().requires_grad_(dcoords)
                if fn == "kernel":  # as wire2d_mlp flattens leading axes
                    y = W2._Wire2dMLP.apply(x.reshape(-1, 2), spec, paths,
                                            *leaves).reshape(*cl.shape[:-1],
                                                             o)
                else:
                    y = W2.wire2d_mlp_plain(tree.unflatten(paths, leaves),
                                            x, spec)
                ins = leaves + ([x] if dcoords else [])
                grads = torch.autograd.grad(y, ins, g.reshape(y.shape),
                                            allow_unused=True)
                outs.append([y.detach()] + [
                    torch.zeros_like(v) if gr is None else gr
                    for v, gr in zip(ins, grads)])
            y0, _, _ = W2._forward(params, c, spec, keep=False)
            rel = _max_rel(outs[0], outs[2])
            same = all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
            nograd = torch.equal(y0, outs[0][0].reshape(n, o))
            print(f"wire2d_mlp n {n} h {h} L {L} o {o} dcoords {dcoords} "
                  f"lead {lead}: max rel err {rel:.2e}, two calls equal: "
                  f"{same}, no-grad forward equal: {nograd}", flush=True)
            assert rel <= 1e-4 and same and nograd, (rel, same, nograd)


def rehearse_mfn(out_dir):
    """mfn_step and the mfn_mlp pair (csrc/mfn.cu: the links on
    wire_tc.cuh's loop with the filter epilogues, the narrow kernel, the
    512-row filter-gradient chunks) against their plain versions at tiny
    shapes: h = 13, 16, 10, 20 (odd, a multiple of 4, even: each kernel
    instance of the copies and epilogue accesses) and h = 6 (the links and
    their weight gradients on the narrow kernels), k 1-4 filters, d 1-3,
    o 1-3, ragged n over several 512- and 1,024-row chunks, the step with
    nvalid and denom, the pair with and without dcoords and on (4, n/4, d)
    coordinates flattened as mfn_mlp flattens them, the pair's forward
    without a gradient; two calls of each bit-equal."""
    import numpy as np
    import torch
    from wire_tpu_torch import tree
    from wire_tpu_torch.nn.registry import get_inr
    from wire_tpu_torch.ops import mfn as MF

    MF._lib.cache_clear()
    with host_library("mfn", out_dir):
        for n, d, h, L, o, nvalid, denom, dcoords, lead in (
                (300, 2, 13, 2, 3, 290, 901.5, True, ()),
                (130, 3, 16, 1, 1, None, None, False, ()),
                (200, 2, 6, 3, 3, 150, None, True, (4,)),
                (150, 1, 10, 0, 2, None, 777.0, True, ()),
                (1100, 2, 20, 2, 3, 1030, None, True, ()),
                (2100, 3, 13, 1, 1, 2049, 6000.0, False, (3,))):
            model = get_inr("mfn", in_features=d, out_features=o,
                            hidden_features=h, hidden_layers=L)
            spec = model.spec
            params = model.init(torch.Generator().manual_seed(n), "cpu")
            rng = np.random.default_rng(n)
            c, t, gt, g = (torch.tensor(a.astype(np.float32)) for a in (
                rng.uniform(-1, 1, (n, d)), rng.uniform(0, 1, (n, o)),
                rng.uniform(0, 1, (n, o)), rng.normal(size=(n, o))))
            steps = [MF._launch_step(params, c, t, nvalid, denom, gt, True,
                                     None) for _ in range(2)]
            want = MF.mfn_step_plain(params, c, t, spec, nvalid=nvalid,
                                     denom=denom, gt=gt, want_metrics=True)
            flat = [_step_tensors(o_) for o_ in steps + [want]]
            rel = _max_rel(flat[0], flat[2])
            same = all(torch.equal(a, b) for a, b in zip(flat[0], flat[1]))
            print(f"mfn_step n {n} d {d} h {h} L {L} o {o} nvalid {nvalid} "
                  f"denom {denom}: max rel err {rel:.2e}, two calls equal: "
                  f"{same}", flush=True)
            assert rel <= 1e-4 and same, (rel, same)

            flat_p = tree.leaves(params)
            paths = tuple(p for p, _ in flat_p)
            cl = c.reshape(*lead, -1, d) if lead else c
            outs = []
            for fn in ("kernel", "kernel", "plain"):
                leaves = [v.clone().requires_grad_(True) for _, v in flat_p]
                x = cl.clone().requires_grad_(dcoords)
                if fn == "kernel":  # as mfn_mlp flattens leading axes
                    y = MF._MfnMLP.apply(x.reshape(-1, d), paths,
                                         *leaves).reshape(*cl.shape[:-1], o)
                else:
                    y = MF.mfn_mlp_plain(tree.unflatten(paths, leaves), x,
                                         spec)
                ins = leaves + ([x] if dcoords else [])
                grads = torch.autograd.grad(y, ins, g.reshape(y.shape),
                                            allow_unused=True)
                outs.append([y.detach()] + [
                    torch.zeros_like(v) if gr is None else gr
                    for v, gr in zip(ins, grads)])
            y0, _, _ = MF._forward(params, c, keep=False)
            rel = _max_rel(outs[0], outs[2])
            same = all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
            nograd = torch.equal(y0, outs[0][0].reshape(n, o))
            print(f"mfn_mlp n {n} d {d} h {h} L {L} o {o} dcoords {dcoords} "
                  f"lead {lead}: max rel err {rel:.2e}, two calls equal: "
                  f"{same}, no-grad forward equal: {nograd}", flush=True)
            assert rel <= 1e-4 and same and nograd, (rel, same, nograd)


def rehearse_real(out_dir):
    """real_step and the real_mlp pair (csrc/real_mlp.cu on real_tc.cuh's
    chain: wire_tc.cuh's loop with the real epilogues, the narrow first-layer
    and top data-gradient kernels, dcoords) against their plain versions at
    tiny shapes: widths that are and are not multiples of 4 (each kernel
    instance of the copies and epilogue accesses), a hidden width of 8 (its
    products and weight gradients on the narrow kernels), d = 26 (posenc's
    first layer on the tensor cores, its dcoords), widths 2 -> 2 -> 1 (the
    step's SSE partials outgrow every other use of the workspace), each
    basis inlined and the mixed codes of lane segments out of line, relu,
    a per-row gamma whose blocks straddle 128-row tiles, ragged n over
    several 512-, 1,024- and 2,048-row chunks, the step with nvalid and
    denom, the pair with and without dcoords and its forward without a
    gradient; two calls of each bit-equal."""
    import numpy as np
    import torch
    from wire_tpu_torch.ops import real_mlp as RM

    seg = ((("qspline", 20), ("identity", 10), ("sine", 10)), "srelu")
    RM._lib.cache_clear()
    with host_library("real_mlp", out_dir):
        for n, widths, kinds, nvalid, denom, dcoords, row_gamma in (
                (300, (2, 48, 40, 3), ("qspline", "qspline"), 290, 901.5,
                 True, None),
                (150, (2, 37, 33, 3), ("srelu", "gauss"), None, None, True,
                 ((1.0, 0.5, 0.25), 50)),
                (200, (26, 20, 20, 1), ("relu", "relu"), 150, None, True,
                 None),
                (260, (2, 8, 12, 2), ("cspline", "sine"), None, 777.0, False,
                 ((9.0, 0.125), 130)),
                (700, (2, 48, 40, 3), seg, 650, None, True, None),
                (2100, (2, 2, 1), ("qspline",), 2049, 6000.0, True, None),
                (2100, (2, 16, 3), ("identity",), None, None, False, None)):
            L = len(widths) - 2
            d, o = widths[0], widths[-1]
            rng = np.random.default_rng(n + d)

            def t(a):
                return torch.tensor(np.asarray(a, np.float32))
            canon = {"layers": [{"w": t(rng.uniform(-1, 1, (a, b))
                                        / np.sqrt(a)),
                                 "alpha": t(rng.uniform(0.5, 2.0, b)),
                                 "beta": t(rng.uniform(-1, 1, b))}
                                for a, b in zip(widths[:-2], widths[1:-1])],
                     "final": {"w": t(rng.uniform(-1, 1, widths[-2:])),
                               "b": t(rng.uniform(-1, 1, o))}}
            c, tg, gt, g = (t(a) for a in (rng.uniform(-1, 1, (n, d)),
                                           rng.uniform(0, 1, (n, o)),
                                           rng.uniform(0, 1, (n, o)),
                                           rng.normal(size=(n, o))))
            kinds = RM.norm_kinds(kinds)
            steps = [RM._launch_step(canon, c, tg, kinds, nvalid, denom, gt,
                                     True, None) for _ in range(2)]
            want = RM.real_step_plain(canon, c, tg, kinds, nvalid=nvalid,
                                      denom=denom, gt=gt, want_metrics=True)
            flat = [_step_tensors(o_) for o_ in steps + [want]]
            rel = _max_rel(flat[0], flat[2])
            same = all(torch.equal(a, b) for a, b in zip(flat[0], flat[1]))
            print(f"real_step n {n} widths {widths} kinds {kinds} nvalid "
                  f"{nvalid} denom {denom}: max rel err {rel:.2e}, two calls "
                  f"equal: {same}", flush=True)
            assert rel <= 1e-4 and same, (rel, same)

            outs = []
            for fn in ("kernel", "kernel", "plain"):
                leaves = [v.clone().requires_grad_(True)
                          for _, v in RM.canon_leaves(canon)]
                x = c.clone().requires_grad_(dcoords)
                if fn == "kernel":
                    y = RM._RealMLP.apply(x, kinds, row_gamma, *leaves)
                else:
                    y = RM.real_mlp_plain(RM.canon_from_leaves(leaves, L), x,
                                          kinds, row_gamma)
                ins = leaves + ([x] if dcoords else [])
                grads = torch.autograd.grad(y, ins, g)
                outs.append([y.detach()] + list(grads))
            y0, _, _ = RM._forward(canon, c, kinds, row_gamma, keep=False)
            rel = _max_rel(outs[0], outs[2])
            same = all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
            nograd = torch.equal(y0, outs[0][0])
            print(f"real_mlp n {n} widths {widths} dcoords {dcoords} "
                  f"row_gamma {row_gamma}: max rel err {rel:.2e}, two calls "
                  f"equal: {same}, no-grad forward equal: {nograd}",
                  flush=True)
            assert rel <= 1e-4 and same and nograd, (rel, same, nograd)
    RM._lib.cache_clear()


def main():
    sys.path.insert(0, ROOT)
    rehearsals = {"wire_mlp": rehearse_wire_mlp, "rotsum": rehearse_rotsum,
                  "line_sample": rehearse_line_sample,
                  "wire_step": rehearse_wire_step,
                  "mscale2_step": rehearse_mscale2_step,
                  "wire2d": rehearse_wire2d, "mfn": rehearse_mfn,
                  "real": rehearse_real}
    names = sys.argv[1:] or list(rehearsals)
    with tempfile.TemporaryDirectory() as d:
        for name in names:
            rehearsals[name](os.path.join(d, name))


if __name__ == "__main__":
    main()
