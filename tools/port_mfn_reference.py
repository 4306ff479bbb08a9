#!/usr/bin/env python3
"""How far the MFN kernels (mfn_step, the mfn_mlp pair) and their fp32
plain versions lie from the plain versions run in float64, per case, on
one GPU: the table that decides which reference each MFN case is held to.

    python3 tools/port_mfn_reference.py [--parent DIR]

For every MFN case of chip_smoke.py (mfn_cases: the step full and ragged,
the pair full, without dcoords, on (4, 50, 2) coordinates and at the
extreme phase; sweep_mfn_cases: the sweep's denoise step and its SISR and
CT pairs, CT with dcoords too) and of tests/test_torch_gpu.py
(test_mfn_step_kernel_matches_plain, test_mfn_mlp_kernel_matches_plain,
test_mfn_step_tensor_cores_match_plain_at_every_width,
test_mfn_at_extreme_phase_kernel_matches_plain,
test_mfn_mlp_leading_axes_and_no_grad; their seeds) it runs the plain
version in float64 (every input cast, chip_smoke.float64_tree) and in
float32, and the kernel, and prints one JSON line per case:

  fp32_plain_vs_f64      max |a - b| / max |float64| per output tensor, of
                         the fp32 plain run from the float64 run
  <tree>_kernel_vs_f64   the same of the kernel of this tree ("this") and,
                         with --parent, of an earlier tree ("parent": a git
                         archive of it in DIR, built there;
                         tools/port_parent_times.py:use)
  <tree>_kernel_vs_fp32  the kernel's largest distance from the fp32 plain
                         run
  worst                  each comparison's largest distance and its output
  decision               "fp32" where the fp32 plain run lies within
                         FP32_REF_TOL (2.5e-5) x max of the float64 run at
                         every output, else "float64"
  in_bound               whether each kernel lies within chip_smoke.REL_TOL
                         x max of the reference decided (the extreme-phase
                         cases keep the fp32 plain one)

and last the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
import port_parent_times as P  # noqa: E402
from wire_tpu_torch.apps import sweep as SW  # noqa: E402
from wire_tpu_torch.nn.registry import get_inr  # noqa: E402
from wire_tpu_torch.ops import build  # noqa: E402
from wire_tpu_torch.ops import mfn as MF  # noqa: E402

# a case whose fp32 plain run lies within this x max of its float64 run at
# every output is held to the fp32 plain version, else to the float64 one
FP32_REF_TOL = 2.5e-5


def per_output(got, want):
    """{output: max |got - want| / max |want|}."""
    return {k: float((got[k].double() - w.double()).abs().max())
            / max(float(w.double().abs().max()), 1e-300)
            for k, w in want.items()}


def worst(d):
    name = max(d, key=d.get)
    return d[name], name


def card_test_cases(dev):
    """{name: (kernel thunk, plain, args, kwargs)}: the cases of
    tests/test_torch_gpu.py's MFN comparisons, built as they build them."""
    from tests import test_torch_gpu as G
    out = {}

    def step_plain(*args, **kwargs):
        return G._tree_flat(*MF.mfn_step_plain(*args, **kwargs))

    for seed, (n, d, hf, layers, o, nvalid, denom) in [(0, case) for case in (
            (65536, 2, 300, 2, 3, None, None), (700, 3, 91, 3, 1, 650,
                                                1951.0),
            (4099, 2, 256, 1, 3, 4000, None))] + [
                (case[0] + case[2], case) for case in G.MFN_WIDTHS]:
        model, params, c, t, gt, _ = G._mfn_case(n, d, hf, layers, o, dev,
                                                 seed=seed)
        kw = dict(nvalid=nvalid, denom=denom, gt=gt, want_metrics=True)
        out[f"test step {n}-{d}-{hf}-{layers}-{o} seed {seed}"] = (
            lambda params=params, c=c, t=t, spec=model.spec, kw=kw:
            G._tree_flat(*MF.mfn_step(params, c, t, spec, **kw)),
            step_plain, (params, c, t, model.spec), kw)

    def pair(spec, plain=False, lead=None):
        apply = MF.mfn_mlp_plain if plain else MF.mfn_mlp

        def run(params, c, g):
            if lead is not None:
                c, g = c.reshape(*lead, c.shape[-1]), g.reshape(*lead,
                                                                g.shape[-1])
            return G._mfn_vjp(lambda p, x: apply(p, x, spec), params, c, g)
        return run

    for n, d, hf, layers, o in ((65536, 2, 256, 2, 3), (700, 3, 91, 3, 1),
                                (4099, 2, 300, 0, 1)):
        model, params, c, _, _, g = G._mfn_case(n, d, hf, layers, o, dev)
        out[f"test pair {n}-{d}-{hf}-{layers}-{o}"] = (
            lambda f=pair(model.spec), a=(params, c, g): f(*a),
            pair(model.spec, plain=True), (params, c, g), {})
    model, params, c, _, _, g = G._mfn_case(512, 2, 64, 2, 3, dev, seed=7)
    S.mfn_extreme_phase(torch, params, c)
    out["test pair extreme_phase"] = (
        lambda f=pair(model.spec), a=(params, c, g): f(*a),
        pair(model.spec, plain=True), (params, c, g), {})
    model, params, c, _, _, g = G._mfn_case(200, 2, 91, 2, 3, dev)
    out["test pair leading_axes"] = (
        lambda f=pair(model.spec, lead=(4, 50)), a=(params, c, g): f(*a),
        pair(model.spec, plain=True, lead=(4, 50)), (params, c, g), {})
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("port_mfn_reference.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    trees = {"this": (build.CSRC_DIR, build.BUILD_DIR)}
    if args.parent:
        trees["parent"] = (
            os.path.join(args.parent, "wire_tpu_torch", "csrc"),
            os.path.join(args.parent, "wire_tpu_torch", "_build"))
    cases = S.mfn_cases(torch, MF, get_inr, dev)
    cases.update(S.sweep_mfn_cases(torch, np, SW, MF, dev))
    cases.update(card_test_cases(dev))
    for name, (kernel, plain, a, kw) in cases.items():
        want64 = plain(*S.float64_tree(a), **S.float64_tree(kw))
        want32 = plain(*a, **kw)
        row = {"case": name, "fp32_plain_vs_f64": per_output(want32, want64)}
        for tree, dirs in trees.items():
            P.use(*dirs)
            got = kernel()
            torch.cuda.synchronize()
            row[f"{tree}_kernel_vs_f64"] = per_output(got, want64)
            row[f"{tree}_kernel_vs_fp32"] = worst(per_output(got, want32))
            del got
        row["worst"] = {k: worst(v) for k, v in row.items()
                        if k.endswith("_vs_f64")}
        f64 = row["worst"]["fp32_plain_vs_f64"][0] > FP32_REF_TOL
        row["decision"] = "float64" if f64 else "fp32"
        ref = ("fp32" if "extreme_phase" in name else row["decision"])
        row["in_bound"] = {
            tree: (row[f"{tree}_kernel_vs_fp32"][0] if ref == "fp32"
                   else row["worst"][f"{tree}_kernel_vs_f64"][0])
            <= S.REL_TOL for tree in trees}
        print(json.dumps(row), flush=True)
        del want64, want32
    print(json.dumps({"nvidia_smi": smi}))


if __name__ == "__main__":
    main()
