#!/usr/bin/env python3
"""Run a CUDA source of wire_tpu_torch/csrc on the host, without nvcc or a
card, at tiny shapes, against its plain PyTorch version.

    python3 tools/host_rehearse.py wire_mlp rotsum wire_step mscale2_step

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
#include <thread>
#include <tuple>
#include <vector>
using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
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
    """mscale2_step (the trunk on real_chain.cuh's chain) against its plain
    version at tiny shapes where 64-row tiles straddle two scales (n =
    130, 150, 700 rows per scale), widths that are and are not multiples
    of 4, the relu^2 spline at gamma 9 and the qspline at 1/8, nvalid and
    denom, and two calls bit-equal."""
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
                 650, None)):
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


def main():
    sys.path.insert(0, ROOT)
    rehearsals = {"wire_mlp": rehearse_wire_mlp, "rotsum": rehearse_rotsum,
                  "wire_step": rehearse_wire_step,
                  "mscale2_step": rehearse_mscale2_step}
    names = sys.argv[1:] or list(rehearsals)
    with tempfile.TemporaryDirectory() as d:
        for name in names:
            rehearsals[name](os.path.join(d, name))


if __name__ == "__main__":
    main()
