#!/usr/bin/env python3
"""The tensor-core MFN (csrc/mfn.cu) in variants, on one GPU: each
variant's host call and kernel times at the measure shapes, its distance
from the fp32 plain version, and the SASS size of its kernels, all in one
process.

    python3 tools/exp_mfn_tc.py [--variants a,b,...] [--reps 2]

Variants are text substitutions of a copy of csrc/mfn.cu (VARIANTS below),
each built by nvcc with the package's flags and loaded in place of the mfn
library:
  committed          as committed: the link epilogue calls one out-of-line
                     function (filter_g) for g at each output, the
                     thread's 8 columns' filters in registers, each row's
                     x loaded once per row
  gtable_smem        the first design: g at the thread's 64 outputs in
                     loops that are not unrolled, into the shared memory
                     tile_product has finished with, from a per-block
                     column table; the unrolled pass reads it there
  chunk_2048         the filter-gradient pass over 2,048-row chunks (320
                     blocks at the denoise shape, the earlier launch)
  filter_fwd_thread  z_0 one thread per element, its row and column by a
                     64-bit division (the earlier filter_forward_kernel)

The cases are chip_smoke.py's measure cases: mfn_step at the denoise shape
(n = 65,536, h = 300, seed 27, metrics) and the mfn_mlp pair at the SISR
shape (n = 65,536, h = 256, seed 28, with dcoords).  Prints the card's
name and power limit, then one JSON line per variant, case and
repetition: ms of a host call (CUDA events over 20 calls after 2 warm-up
calls), the device time per call of each kernel (torch.profiler), the
largest distance over the outputs from the fp32 plain version (max |a - b|
/ max |plain| per tensor), whether the outputs equal the committed
variant's bit for bit, and (first repetition) the SASS instructions,
registers, stack frame and spill bytes of each of the library's MFN
kernels.
"""
import argparse
import concurrent.futures
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

# the first design: g of the thread's 64 outputs in loops that are not
# unrolled, into the shared memory tile_product has finished with, from a
# per-block column table; the unrolled pass reads g from there
GTABLE_PHASE = """  // the tile's column table (9 rows of kBN), then g at each thread's
  // outputs e = (mt 2 + hr) kNT 2 + nt 2 + i
  constexpr int kBN = wire_tc::kBN, kTcThreads = wire_tc::kThreads;
  constexpr int kFW = 0, kFMu = kMaxIn, kFB = 2 * kMaxIn, kFGamma = kFB + 1,
                kFMu2 = kFB + 2, kColFields = kFB + 3;
  float* tab = smem;
  float* gv = smem + kColFields * kBN;
  if (kMode != kPlainOut) {
    __syncthreads();  // every warp is done with the staged slices
    const int c = threadIdx.x;
    if (c < kBN && col0 + c < N) {
      const Col col = load_col(f, d, N, col0 + c);
      for (int k = 0; k < kMaxIn; ++k) {
        tab[(kFW + k) * kBN + c] = col.w[k];
        tab[(kFMu + k) * kBN + c] = col.mu[k];
      }
      tab[kFB * kBN + c] = col.b;
      tab[kFGamma * kBN + c] = col.gamma;
      tab[kFMu2 * kBN + c] = col.mu2;
    }
    __syncthreads();
#pragma unroll 1
    for (int rr = 0; rr < 2 * kMT; ++rr) {
      const int r = row0 + wm * (kMT * 16) + (rr / 2) * 16 + g + (rr % 2) * 8;
      if (r >= n) continue;
      const Row row = load_row(x, r, d);
#pragma unroll 1
      for (int q = 0; q < 2 * kNT; ++q) {
        const int lc =
            wire_tc::tile_col<wire_tc::kPlain>(wn, q / 2) + 2 * t + q % 2;
        if (col0 + lc >= N) continue;
        Col col;
        for (int k = 0; k < kMaxIn; ++k) {
          col.w[k] = tab[(kFW + k) * kBN + lc];
          col.mu[k] = tab[(kFMu + k) * kBN + lc];
        }
        col.b = tab[kFB * kBN + lc];
        col.gamma = tab[kFGamma * kBN + lc];
        col.mu2 = tab[kFMu2 * kBN + lc];
        const Terms tm = filter_terms(col, row, d);
        gv[(rr * 2 * kNT + q) * kTcThreads + threadIdx.x] = tm.E * tm.S;
      }
    }
  }
  float2 cb[kNT];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int j = col0 + wire_tc::tile_col<wire_tc::kPlain>(wn, nt) + 2 * t;
    cb[nt] = kMode == kLinkFwd && j < N
                 ? wire_tc::load2<kPair>(bias + j, j + 1 < N)
                 : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {"""

GTABLE_SMEM = [
    (re.compile(r"  // this thread's 8 columns: their bias \(forward\) and "
                r"filter\n.*?#pragma unroll\n  for \(int mt = 0; mt < kMT; "
                r"\+\+mt\) \{", re.S), GTABLE_PHASE),
    ("      Row row{};\n      if (kMode != kPlainOut) row = load_row(x, r, "
     "d);\n", ""),
    ("          gg.x = filter_g(cols[nt][0], row, d);\n"
     "          if (two) gg.y = filter_g(cols[nt][1], row, d);",
     "          const int e = ((mt * 2 + hr) * kNT + nt) * 2;\n"
     "          gg.x = gv[e * kTcThreads + threadIdx.x];\n"
     "          if (two) gg.y = gv[(e + 1) * kTcThreads + threadIdx.x];"),
]

FILTER_FWD_THREAD = [
    (re.compile(r"  const int c = blockIdx.x \* 32 \+ threadIdx.x % 32;\n"
                r"  if \(c >= h\) return;\n  const Col col = load_col\(f, d, "
                r"h, c\);\n.*?\n  \}\n\}", re.S),
     "  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;\n"
     "  if (idx >= (size_t)n * h) return;\n"
     "  const int r = (int)(idx / h), c = (int)(idx % h);\n"
     "  const Terms t = filter_terms(load_col(f, d, h, c), load_row(x, r, d),"
     " d);\n"
     "  z[idx] = t.E * t.S;\n"
     "}"),
    ("filter_forward_kernel<<<dim3(ceil_div(h, 32), ceil_div(n, "
     "kNarrowRows)),",
     "filter_forward_kernel<<<ceil_div((long long)n * h, kThreads),"),
]

VARIANTS = {
    "committed": [],
    "gtable_smem": GTABLE_SMEM,
    "chunk_2048": [("constexpr int kFilterChunkRows = 512;",
                    "constexpr int kFilterChunkRows = 2048;")],
    "filter_fwd_thread": FILTER_FWD_THREAD,
}


def build_variant(nvcc, flags, subs, out_dir):
    from wire_tpu_torch.ops import build
    shutil.copytree(build.CSRC_DIR, out_dir)
    path = os.path.join(out_dir, "mfn.cu")
    with open(path) as f:
        text = f.read()
    for a, b in subs:
        if isinstance(a, str):
            assert a in text, a
            text = text.replace(a, b)
        else:
            text, count = a.subn(lambda m: b, text)
            assert count == 1, (a.pattern, count)
    with open(path, "w") as f:
        f.write(text)
    so = os.path.join(out_dir, "mfn.so")
    proc = subprocess.run([nvcc, *flags, "-o", so, path],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    return so, ptxas_stats(proc.stdout + proc.stderr)


def ptxas_stats(log):
    """{kernel: [registers, stack frame bytes, spill store bytes, spill
    load bytes]} of the MFN kernels, from ptxas -v's output."""
    stats, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = short(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            stats[name] = [None] + [int(v) for v in m.groups()]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name in stats:
            stats[name][0] = int(m.group(1))
            name = None
    return {k: v for k, v in stats.items()
            if "mfn_" in k or "filter_" in k}


def short(name):
    """A mangled kernel name without mfn.cu's anonymous-namespace prefix."""
    return re.sub(r"^_ZN\w*?mfn_cu_\w{8}", "", name)


def sass_sizes(nvcc, so):
    """{kernel: SASS instructions} of the library's MFN kernels."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.access(cuobjdump, os.X_OK):
        return None
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, timeout=600).stdout
    sizes, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            sizes[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            sizes[name] += 1
    return {short(k): v for k, v in sizes.items()
            if "mfn_" in k or "filter_" in k}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()

    import ctypes

    import torch
    import chip_smoke as S
    from wire_tpu_torch.nn.registry import get_inr
    from wire_tpu_torch.ops import build
    from wire_tpu_torch.ops import mfn as MF
    from wire_tpu_torch.ops.wire_step import StepScratch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    names = args.variants.split(",")
    nvcc = build.find_nvcc()
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=build.BUILD_DIR, prefix="exp_mfn_tc_")
    load = build.load
    try:
        with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
            futures = {k: pool.submit(build_variant, nvcc, build.NVCC_FLAGS,
                                      VARIANTS[k], os.path.join(tmp, k))
                       for k in names}
            built = {k: f.result() for k, f in futures.items()}
        libs = {k: so for k, (so, _) in built.items()}
        sass = {k: sass_sizes(nvcc, so) for k, so in libs.items()}

        model, params, c, t, gt, _ = S.mfn_case(torch, get_inr, 256 * 256,
                                                2, 300, 2, 3, 27, dev)
        spec = model.spec
        model2, params2, c2, _, _, g2 = S.mfn_case(
            torch, get_inr, 256 * 256, 2, 256, 2, 3, 28, dev)
        keys2 = S.leaf_paths(params2)
        xs2 = [c2] + [v for _, v in S.tree_leaves(params2)]
        want = {
            "mfn_step": S.tensors_of(*MF.mfn_step_plain(
                params, c, t, spec, gt=gt, want_metrics=True)),
            "mfn_mlp": S.vjp(torch, S.pair_fn(MF.mfn_mlp_plain, model2.spec,
                                              keys2), xs2, g2)}
        first = {}
        for rep in range(args.reps):
            for k, so in libs.items():
                lib = ctypes.CDLL(so)
                build.load = (lambda n, lib=lib:
                              lib if n == "mfn" else load(n))
                MF._lib.cache_clear()
                scratch = StepScratch()
                fns = {
                    "mfn_step": lambda: S.tensors_of(*MF.mfn_step(
                        params, c, t, spec, gt=gt, want_metrics=True,
                        scratch=scratch)),
                    "mfn_mlp": lambda: S.vjp(torch, S.pair_fn(
                        MF.mfn_mlp, model2.spec, keys2), xs2, g2)}
                for case, fn in fns.items():
                    got = fn()
                    torch.cuda.synchronize()
                    first.setdefault((k, case), got)
                    ref = first.get(("committed", case))
                    out = {"variant": k, "case": case, "rep": rep,
                           "ms": S.cuda_ms(torch, fn, 20),
                           "vs_fp32_plain": S.rel_distance(got, want[case]),
                           "bits_equal_committed": None if ref is None
                           else all(torch.equal(got[n], ref[n])
                                    for n in ref)}
                    by = S.kernel_breakdown(torch, fn, 10)
                    out["kernels_ms"] = {
                        re.sub(r"\(.*", "", q.replace(
                            "(anonymous namespace)::", "")).replace(
                                "void ", ""): v
                        for q, v in by.items() if "at::" not in q}
                    out["kernel_ms"] = sum(v[0] for v in
                                           out["kernels_ms"].values())
                    if rep == 0 and case == "mfn_step":
                        out["sass_instructions"] = sass[k]
                        out["ptxas_registers_stack_spills"] = built[k][1]
                    print(json.dumps(out), flush=True)
                    del got
                del scratch
    finally:
        build.load = load
        MF._lib.cache_clear()
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
