#!/usr/bin/env python3
"""mscale2_step's tensor-core trunk (csrc/real_tc.cuh) in variants, on one
GPU: each variant's host call and kernel times at the path's shape, its
distance from the float64 plain run, and the SASS size of its kernels, all
in one process.

    python3 tools/exp_real_tc.py [--variants a,b,...] [--reps 2]

Variants are text substitutions of a copy of csrc/real_tc.cuh (VARIANTS
below), each built by nvcc with the package's flags and loaded in place of
the mscale2_step library:
  committed        the chain as committed: a thread's epilogue inlines the
                   basis its columns share where it is piecewise, else
                   calls each column's out of line
  k3_tensor_cores  the top layer's data gradient (K = o = 3) on the
                   tensor-core kernel instead of the narrow one (the first
                   layer's forward, K = 2, stays narrow)
  all_inline       the whole basis switch inlined at every accumulator
                   register (the first design)
  all_out_of_line  every basis out of line
  identity_basis   B(v) = v and dB = 1 in the epilogues: the epilogue's
                   least cost (its outputs are not the step's)

The case is chip_smoke.py's measure case (the Mscale2 denoise model's
seed-22 fold, n = 65,536, ns = 3, seed-23 inputs).  Prints the card's name
and power limit, then one JSON line per variant and repetition: ms of a
host call (CUDA events over 20 calls after 2 warm-up calls), the device
time per call of each of the library's kernels (torch.profiler), the
largest distance over the outputs from the float64 plain run (max |a - b|
/ max |float64| per tensor), whether the outputs equal the committed
variant's bit for bit, and the SASS instructions of each kernel.
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

ALWAYS_FAR = ("  switch (code) {\n#define REAL_TC_INLINE",
              "  switch (code + 1000) {\n#define REAL_TC_INLINE")

VARIANTS = {
    "committed": [],
    "k3_tensor_cores": [("  if (K <= kNarrowK) {", "  if (K <= 2) {")],
    "all_inline": [
        ALWAYS_FAR,
        ("return kMode == kFwd ? far_value(code, v) : far_deriv(code, v);",
         "return kMode == kFwd ? real_chain::basis_value(code, v)\n"
         "                     : real_chain::basis_deriv(code, v);")],
    "all_out_of_line": [ALWAYS_FAR],
    "identity_basis": [
        ("o1 = basis<kFwd, kCode>(code, v);", "o1 = v + 0.f * code;"),
        ("gm * (basis<kBwd, kCode>(code, v) * acc)",
         "gm * ((1.f + 0.f * v + 0.f * code) * acc)")],
}


def build_variant(nvcc, flags, subs, out_dir):
    from wire_tpu_torch.ops import build
    shutil.copytree(build.CSRC_DIR, out_dir)
    path = os.path.join(out_dir, "real_tc.cuh")
    for a, b in subs:
        with open(path) as f:
            text = f.read()
        assert a in text, a
        with open(path, "w") as f:
            f.write(text.replace(a, b))
    so = os.path.join(out_dir, "mscale2_step.so")
    proc = subprocess.run([nvcc, *flags, "-o", so,
                           os.path.join(out_dir, "mscale2_step.cu")],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    return so


def sass_sizes(nvcc, so):
    """{kernel: SASS instructions} of the library's real_tc kernels."""
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
    return {k: v for k, v in sizes.items() if "real_" in k}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()

    import ctypes

    import torch
    import chip_smoke as S
    import wire_tpu_torch.nn.models as MM
    from wire_tpu_torch.apps import common as TC
    from wire_tpu_torch.nn.registry import get_inr
    from wire_tpu_torch.ops import build
    from wire_tpu_torch.ops import mscale2_step as MS
    from wire_tpu_torch.ops.wire_step import StepScratch
    from wire_tpu_torch.train.presets import get_config

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
    tmp = tempfile.mkdtemp(dir=build.BUILD_DIR, prefix="exp_real_tc_")
    load = build.load
    try:
        with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
            futures = {k: pool.submit(build_variant, nvcc, build.NVCC_FLAGS,
                                      VARIANTS[k], os.path.join(tmp, k))
                       for k in names}
            libs = {k: f.result() for k, f in futures.items()}
        sass = {k: sass_sizes(nvcc, so) for k, so in libs.items()}

        model = S.mscale2_models(get_inr, TC,
                                 get_config(S.MSCALE2_CONFIG))[0]
        canon, comb, kinds, inv = S.mscale2_fold(torch, MM, model, 22, dev)
        c, t, gt, _ = S.real_inputs(torch, 256 * 256, 2, 3, 23, dev)
        args_ = (canon, comb, c, t, kinds, inv)
        kw = dict(gt=gt, want_metrics=True)
        want = S.mscale2_plain(MS)(*S.float64_tree(args_),
                                   **S.float64_tree(kw))
        first = {}
        for rep in range(args.reps):
            for k, so in libs.items():
                lib = ctypes.CDLL(so)
                build.load = (lambda n, lib=lib:
                              lib if n == "mscale2_step" else load(n))
                MS._lib.cache_clear()
                scratch = StepScratch()

                def step():
                    return MS.mscale2_step(*args_, scratch=scratch, **kw)
                got = S.mscale2_tensors(*step())
                torch.cuda.synchronize()
                first.setdefault(k, got)
                ref = first.get("committed")
                out = {"variant": k, "rep": rep,
                       "ms": S.cuda_ms(torch, step, 20),
                       "vs_f64": S.rel_distance(got, want),
                       "bits_equal_committed": None if ref is None else all(
                           torch.equal(got[n], ref[n]) for n in ref)}
                by = S.kernel_breakdown(torch, step, 10)
                out["kernels_ms"] = {
                    re.sub(r"\(.*", "", q).replace("void ", ""): v
                    for q, v in by.items() if "at::" not in q}
                out["kernel_ms"] = sum(v[0] for v in
                                       out["kernels_ms"].values())
                if rep == 0:
                    out["sass_instructions"] = sass[k]
                print(json.dumps(out), flush=True)
                del scratch, got
    finally:
        build.load = load
        MS._lib.cache_clear()
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
