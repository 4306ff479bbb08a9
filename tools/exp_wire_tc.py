#!/usr/bin/env python3
"""The wire_mlp pair's tensor-core loop (csrc/wire_tc.cuh) in variants, on
one GPU: each variant's distance from a float64 reference, next to plain
fp32's, and its pair time at the CT shape, all in one process.

    python3 tools/exp_wire_tc.py [--parent DIR] [--variants a,b,...]

Variants are text substitutions of a copy of csrc/ (VARIANTS below), each
built by nvcc with the package's flags and loaded in place of the
wire_mlp library:
  slice32          the loop as committed (32-deep slices, each slice's
                   products promoted into the fp32 sums)
  slice16          16-deep slices
  stages2/stages4  a 2- or 4-stage cp.async ring
  warps8           8 warps of 32 x 32 per 128 x 64 tile
  blocks3          registers capped for 3 blocks per SM (spills)
  one_accumulator  no promotion: every product into one tensor-core
                   accumulator for the whole K
``--parent DIR`` adds an earlier csrc/ directory (e.g. a ``git archive``
of an earlier commit's wire_tpu_torch/csrc), whose wire_mlp.cu has the
same C interface, as the variant "parent".

Cases (n, hidden_features, L, o, omega0, sigma, hidden weight scale):
ct (the CT pair: 65,536, 300, 2, 1, 3, 12, 1), ph2 and ph3 (4,096 rows at
sigma 1 with the hidden weights doubled / tripled: Gabor phases of tens of
radians, ph2 the smoke's extreme-phase case), r1 (700, 19, 3, 3: h = 13)
and d7 (the denoise frequencies, o = 3).  Errors are max abs error over
every output and gradient, over the max abs of the float64 result (or of
plain fp32, for vs_plain32).  Prints one JSON line per variant and
repetition.
"""
import argparse
import concurrent.futures
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = {
    "slice32": [],
    "slice16": [("constexpr int kBK = 32; ", "constexpr int kBK = 16; ")],
    "stages2": [("kStages = 3;", "kStages = 2;")],
    "stages4": [("kStages = 3;", "kStages = 4;")],
    "warps8": [("kWarpsM = 2, kWarpsN = 2;", "kWarpsM = 4, kWarpsN = 2;"),
               ("constexpr int kMT = 4; ", "constexpr int kMT = 2; ")],
    "blocks3": [("__launch_bounds__(kThreads, 2) tc_paired",
                 "__launch_bounds__(kThreads, 3) tc_paired"),
                ("__launch_bounds__(kThreads, 2) tc_wgrad",
                 "__launch_bounds__(kThreads, 3) tc_wgrad")],
    "one_accumulator": [
        ("warp_k8<kAT, kPaired>(As, Bs, wm, wn, k0, part);",
         "warp_k8<kAT, kPaired>(As, Bs, wm, wn, k0, acc);"),
        ("for (int c = 0; c < 4; ++c) acc[mt][nt][c] += part[mt][nt][c];",
         "for (int c = 0; c < 4; ++c) (void)part[mt][nt][c];")],
}

CASES = {"ct": (65536, 300, 2, 1, 3.0, 12.0, 1.0, 4),
         "ph2": (4096, 300, 2, 1, 3.0, 1.0, 2.0, 4098),
         "ph3": (4096, 300, 2, 1, 3.0, 1.0, 3.0, 5),
         "r1": (700, 19, 3, 3, 3.0, 12.0, 1.0, 1),
         "d7": (65536, 300, 2, 3, 7.0, 8.0, 1.0, 2)}


def build_variant(nvcc, flags, src, subs, out_dir):
    shutil.copytree(src, out_dir)
    path = os.path.join(out_dir, "wire_tc.cuh")
    for a, b in subs:
        with open(path) as f:
            text = f.read()
        assert a in text, a
        with open(path, "w") as f:
            f.write(text.replace(a, b))
    so = os.path.join(out_dir, "wire_mlp.so")
    proc = subprocess.run([nvcc, *flags, "-o", so,
                           os.path.join(out_dir, "wire_mlp.cu")],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    regs = re.findall(r"Used (\d+) registers", proc.stdout + proc.stderr)
    return so, regs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier csrc/ directory")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()

    import numpy as np
    import torch
    import chip_smoke as CS
    from wire_tpu_torch.nn.registry import get_inr
    from wire_tpu_torch.ops import build
    from wire_tpu_torch.ops import wire_mlp as WM

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    todo = {k: (build.CSRC_DIR, VARIANTS[k])
            for k in args.variants.split(",")}
    if args.parent:
        todo["parent"] = (args.parent, [])
    nvcc = build.find_nvcc()
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=build.BUILD_DIR, prefix="exp_wire_tc_")
    try:
        with concurrent.futures.ThreadPoolExecutor(len(todo)) as pool:
            futures = {k: pool.submit(build_variant, nvcc, build.NVCC_FLAGS,
                                      src, subs, os.path.join(tmp, k))
                       for k, (src, subs) in todo.items()}
            libs = {k: f.result() for k, f in futures.items()}
        for k, (_, regs) in libs.items():
            print(k, "registers per kernel", regs, flush=True)

        def case(n, hf, L, o, omega, scale, wscale, seed):
            model = get_inr("wire", in_features=2, out_features=o,
                            hidden_features=hf, hidden_layers=L,
                            first_omega0=omega, hidden_omega0=omega,
                            scale=scale)
            params = model.init(torch.Generator().manual_seed(seed), dev)
            for k in params:
                if k.startswith("hidden"):
                    for kk in ("wr", "wi"):
                        params[k][kk] = params[k][kk] * wscale
            rng = np.random.default_rng(seed)
            c = torch.tensor(rng.uniform(-1, 1, (n, 2)).astype(np.float32),
                             device=dev)
            g = torch.tensor(rng.normal(size=(n, o)).astype(np.float32),
                             device=dev)
            keys = CS.leaf_paths(params)
            xs = [c] + [t for _, t in CS.tree_leaves(params)]
            plain = CS.pair_fn(WM.wire_mlp_plain, model.spec, keys)
            return (CS.pair_fn(WM.wire_mlp, model.spec, keys), xs, g,
                    CS.vjp(torch, plain, [x.double() for x in xs],
                           g.double()),
                    CS.vjp(torch, plain, xs, g))

        def rel(a, b):
            return max(float((a[k].double() - b[k].double()).abs().max())
                       / max(float(b[k].double().abs().max()), 1e-300)
                       for k in b)

        cases = {label: case(*c) for label, c in CASES.items()}
        load = build.load
        for rep in range(2):
            for k, (so, _) in libs.items():
                lib = ctypes.CDLL(so)
                build.load = (lambda n, lib=lib:
                              lib if n == "wire_mlp" else load(n))
                WM._lib.cache_clear()
                out = {}
                for label, (kfn, xs, g, f64, p32) in cases.items():
                    got = CS.vjp(torch, kfn, xs, g)
                    out[label] = {"vs_f64": rel(got, f64),
                                  "vs_plain32": rel(got, p32),
                                  "plain32_vs_f64": rel(p32, f64)}
                kfn, xs, g, _, _ = cases["ct"]
                out["pair_ms"] = CS.cuda_ms(
                    torch, lambda: CS.vjp(torch, kfn, xs, g), 20)
                by = CS.kernel_breakdown(
                    torch, lambda: CS.vjp(torch, kfn, xs, g), 10)
                out["kernels_ms"] = {
                    re.sub(r"\(.*", "", q).replace("void ", ""): v[0]
                    for q, v in by.items() if "at::" not in q}
                print(json.dumps({"variant": k, "rep": rep, **out}),
                      flush=True)
        build.load = load
        WM._lib.cache_clear()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
