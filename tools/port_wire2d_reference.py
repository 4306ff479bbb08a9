#!/usr/bin/env python3
"""How far WIRE-2D's fp32 plain versions lie from their own float64 runs,
and the kernels from both, on one GPU.

    python3 tools/port_wire2d_reference.py [--widths] [--parent DIR]
                                           [--n 65536] [--device cuda]

At chip_smoke.py's full WIRE-2D cases, wire2d_step at the denoise shape
(omega0 7, sigma 8, o = 3, the seed-30 init and inputs, metrics) and the
wire2d_mlp pair at the CT shape (omega0 3, sigma 12, o = 1, the seed-31
init, parameter gradients), it runs the plain version in float32 and in
float64 on the same inputs and, on a CUDA device, the kernels.  With
``--widths``, instead, each case of chip_smoke.py's WIRE2D_WIDTHS (its
seeds; the step with nvalid and denom, the pair with dcoords) at the
denoise frequencies and at the CT ones (omega0 3, sigma 12).  ``--parent
DIR`` adds the kernels of an earlier tree (a git archive of it in DIR, as
tools/port_parent_times.py takes it).

It prints one JSON line per case: for each output tensor the fp32 plain
run's distance from the float64 run, each kernel's distance from the
float64 run and from the fp32 plain run (max |a - b| over max |reference|
per tensor: the last is what chip_smoke.py holds to 1e-4), the largest of
each with its tensor, and the card's name and power limit.  ``--device
cpu`` runs the plain versions alone (use a small --n).
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from wire_tpu_torch import tree  # noqa: E402
from wire_tpu_torch.nn.registry import get_inr  # noqa: E402
from wire_tpu_torch.ops import build  # noqa: E402
from wire_tpu_torch.ops import wire2d as W2  # noqa: E402
from wire_tpu_torch.train.presets import get_config  # noqa: E402


def rel(got, want):
    return {k: float((got[k].double() - want[k].double()).abs().max())
            / max(float(want[k].double().abs().max()), 1e-300)
            for k in want}


def step_runs(model, params, c, t, gt, nvalid, denom, kernels):
    """{"fp32", "f64", *kernels}: the step's outputs by run."""
    def run(fn, dtype):
        p = tree.map(lambda v: v.to(dtype), params)
        return S.tensors_of(*fn(p, c.to(dtype), t.to(dtype), model.spec,
                                nvalid=nvalid, denom=denom, gt=gt.to(dtype),
                                want_metrics=True))
    runs = {"fp32": run(W2.wire2d_step_plain, torch.float32),
            "f64": run(W2.wire2d_step_plain, torch.float64)}
    for name, use in kernels.items():
        use()
        runs[name] = run(W2.wire2d_step, torch.float32)
    return runs


def pair_runs(model, params, c, g, dcoords, kernels):
    """{"fp32", "f64", *kernels}: the pair's output and gradients (with
    dcoords, or the parameters' alone) by run."""
    keys = S.leaf_paths(params)
    leaves = [v for _, v in S.tree_leaves(params)]

    def run(fn, dtype):
        pfn = S.pair_fn(fn, model.spec, keys)
        lv = [v.to(dtype) for v in leaves]
        if dcoords:
            return S.vjp(torch, pfn, [c.to(dtype)] + lv, g.to(dtype))
        return S.param_vjp(torch, pfn, c.to(dtype), lv, g.to(dtype))
    runs = {"fp32": run(W2.wire2d_mlp_plain, torch.float32),
            "f64": run(W2.wire2d_mlp_plain, torch.float64)}
    for name, use in kernels.items():
        use()
        runs[name] = run(W2.wire2d_mlp, torch.float32)
    return runs


def report(case, runs, smi):
    out = {"case": case, "nvidia_smi": smi,
           "fp32_plain_vs_f64": rel(runs["fp32"], runs["f64"])}
    for name in runs:
        if name not in ("fp32", "f64"):
            out[f"{name}_vs_f64"] = rel(runs[name], runs["f64"])
            out[f"{name}_vs_fp32_plain"] = rel(runs[name], runs["fp32"])
    for k in list(out):
        if isinstance(out[k], dict):
            worst = max(out[k], key=out[k].get)
            out[f"max_{k}"] = [out[k][worst], worst]
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", action="store_true")
    ap.add_argument("--parent")
    ap.add_argument("--n", type=int, default=256 * 256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip() \
        if on_card else "no card"
    kernels = {}
    if on_card:
        import port_parent_times as P
        here = (build.CSRC_DIR, build.BUILD_DIR)
        kernels["kernel"] = lambda: P.use(*here)
        if args.parent:
            there = (os.path.join(args.parent, "wire_tpu_torch", "csrc"),
                     os.path.join(args.parent, "wire_tpu_torch", "_build"))
            kernels["parent_kernel"] = lambda: P.use(*there)
    ct_kw = S.wire2d_ct_kw(get_config)

    if not args.widths:
        model, params, c, t, gt, _ = S.wire2d_case(torch, get_inr, args.n,
                                                   2, 3, 30, dev)
        report(f"wire2d_step denoise n {args.n}",
               step_runs(model, params, c, t, gt, None, None, kernels), smi)
        model, params, c, _, _, g = S.wire2d_case(torch, get_inr, args.n, 2,
                                                  1, 31, dev, ct_kw)
        report(f"wire2d_mlp CT n {args.n}",
               pair_runs(model, params, c, g, False, kernels), smi)
        return
    for hf, h, L, o, n, nvalid, denom in S.WIRE2D_WIDTHS:
        seed = n + hf + L
        for freq, kw in (("denoise", {}), ("ct", ct_kw)):
            kw = dict(kw, hidden_features=hf)
            what = f"h{h} L{L} o{o} n{n} {freq}"
            model, params, c, t, gt, _ = S.wire2d_case(
                torch, get_inr, n, L, o, seed, dev, kw)
            report(f"wire2d_step {what}", step_runs(
                model, params, c, t, gt, nvalid, denom, kernels), smi)
            model, params, c, _, _, g = S.wire2d_case(
                torch, get_inr, n, L, o, seed + 1, dev, kw)
            report(f"wire2d_mlp {what}",
                   pair_runs(model, params, c, g, True, kernels), smi)


if __name__ == "__main__":
    main()
