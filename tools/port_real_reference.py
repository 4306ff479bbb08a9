#!/usr/bin/env python3
"""How far the canonical real kernels (real_step, the real_mlp pair) and
their fp32 plain versions lie from the plain versions run in float64, per
case, on one GPU: the table that decides which reference each real case is
held to.

    python3 tools/port_real_reference.py [--parent DIR] [--only TEXT]

For every real case of chip_smoke.py (real_cases: the step full, ragged and
with lane segments and relu, the pair full, ragged, per basis kind, with
lane segments and row_gamma; real_fold_cases: the step at the mscale_hier
and mscale_HL folds; sweep_real_cases: the sweep's siren, gauss, relu and
posenc denoise steps and SISR and CT pairs) and of tests/test_torch_gpu.py
(test_real_mlp_kernel_matches_plain, its _at_path_widths and
_row_gamma_and_scales cases, test_real_step_kernel_matches_plain,
test_real_tensor_cores_match_plain_at_every_width; their seeds) it runs
the plain version in float64 (every input cast, chip_smoke.float64_tree)
and in float32, and the kernel, and prints one JSON line per case:

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
                         x max of the reference decided
  <tree>_relu_pattern    for chip_smoke.REAL_RELU_PATTERN_CASES (whose
                         fp32 plain run lies past REL_TOL x max of the
                         float64 one: fp32_plain_in_bound_of_f64 false),
                         the kernel against the float64 run on its own
                         relu pattern (chip_smoke.relu_pattern_reference)
                         and the pattern's differences from float64's

and last the card's name and power limit.  ``--only TEXT`` keeps the cases
whose name holds TEXT.
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
from wire_tpu_torch.apps import common as TC  # noqa: E402
from wire_tpu_torch.apps import sweep as SW  # noqa: E402
from wire_tpu_torch.nn import models as MM  # noqa: E402
from wire_tpu_torch.nn.registry import get_inr  # noqa: E402
from wire_tpu_torch.ops import build  # noqa: E402
from wire_tpu_torch.ops import real_mlp as RM  # noqa: E402
from wire_tpu_torch.train.presets import get_config  # noqa: E402

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


def kinds_id(kinds):
    """A case's kinds as text: the kind names joined by '-', "segments" for
    lane segments."""
    return "-".join(k if isinstance(k, str) else "segments" for k in kinds)


def card_test_cases(dev):
    """{name: (kernel thunk, plain, args, kwargs)}: the cases of
    tests/test_torch_gpu.py's real comparisons, built as they build them."""
    from tests import test_torch_gpu as G
    out = {}

    def pair(kinds, row_gamma=None, scales=None):
        def run(canon, c, g, plain=False):
            if scales is not None:
                if plain:
                    return G._real_vjp(lambda p, x: RM.real_mlp_plain(
                        p, x.repeat(len(scales), 1), kinds,
                        row_gamma=(scales, c.shape[0])).reshape(
                            len(scales), c.shape[0], -1), canon, c, g)
                return G._real_vjp(lambda p, x: RM.real_mlp_scales(
                    p, x, kinds, scales), canon, c, g)
            fn = RM.real_mlp_plain if plain else RM.real_mlp
            return G._real_vjp(lambda p, x: fn(p, x, kinds, row_gamma),
                               canon, c, g)
        return run

    def add_pair(name, run, canon, c, g):
        out[name] = (lambda: run(canon, c, g),
                     lambda *a: run(*a, plain=True), (canon, c, g), {})

    def add_step(name, canon, c, t, kinds, **kw):
        kw = dict(kw, want_metrics=True)
        out[name] = (lambda: G._step_flat(*RM.real_step(canon, c, t, kinds,
                                                        **kw)),
                     lambda *a, **k: G._step_flat(*RM.real_step_plain(*a,
                                                                      **k)),
                     (canon, c, t, kinds), kw)

    for kind in G.BASES + ("segments",):
        kinds = (G.SEGMENTS, "qspline") if kind == "segments" else (kind,
                                                                    kind)
        canon = G._canon((2, 48, 40, 3), dev)
        rng = np.random.default_rng(1)
        c, g = (torch.tensor(a.astype(np.float32), device=dev) for a in (
            rng.uniform(-1, 1, (700, 2)), rng.normal(size=(700, 3))))
        add_pair(f"test pair {kind}", pair(kinds), canon, c, g)
    for n, widths in ((28224, (2, 256, 256, 256, 3)),
                      (4099, (26, 64, 64, 1))):
        canon = G._canon(widths, dev, seed=2)
        rng = np.random.default_rng(3)
        c, g = (torch.tensor(a.astype(np.float32), device=dev) for a in (
            rng.uniform(-1, 1, (n, widths[0])),
            rng.normal(size=(n, widths[-1]))))
        add_pair(f"test pair path_widths {n}-{widths}",
                 pair(("qspline",) * (len(widths) - 2)), canon, c, g)
    canon = G._canon((2, 48, 40, 3), dev, seed=4)
    rng = np.random.default_rng(5)
    c, g = (torch.tensor(a.astype(np.float32), device=dev) for a in (
        rng.uniform(-1, 1, (300, 2)), rng.normal(size=(3, 300, 3))))
    add_pair("test pair row_gamma_scales",
             pair(("qspline", "cspline"), scales=(1.0, 0.5, 0.25)), canon,
             c, g)
    for n, widths, kinds, nvalid, denom in G.REAL_STEP_CASES:
        canon = G._canon(widths, dev, seed=7)
        rng = np.random.default_rng(8)
        c, t, gt = (torch.tensor(a.astype(np.float32), device=dev) for a in (
            rng.uniform(-1, 1, (n, widths[0])), rng.uniform(0, 1, (n, 3)),
            rng.uniform(0, 1, (n, 3))))
        add_step(f"test step {n}-{widths}-{kinds_id(kinds)}", canon, c, t,
                 kinds, nvalid=nvalid, denom=denom, gt=gt)
    for n, widths, kinds, nvalid, denom in G.REAL_WIDTHS:
        canon, c, t, gt, g = G._real_width_case(n, widths, dev)
        name = f"{n}-{widths}-{kinds_id(kinds)}"
        add_step(f"test widths step {name}", canon, c, t, kinds,
                 nvalid=nvalid, denom=denom, gt=gt)
        add_pair(f"test widths pair {name}", pair(kinds), canon, c, g)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent")
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("port_real_reference.py needs a CUDA device")
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
    model_a, _ = S.real_models(get_inr, TC, get_config(S.REAL_DENOISE_CONFIG),
                               7.0, 256)
    model_b, _ = S.real_models(get_inr, TC, get_config(S.REAL_SISR_CONFIG),
                               8.0, 168)
    cases = S.real_cases(torch, RM, MM, model_a, model_b, dev)
    cases.update(S.real_fold_cases(torch, RM, MM, get_inr, get_config, dev))
    cases.update(S.sweep_real_cases(torch, np, SW, RM, MM, dev))
    cases.update(card_test_cases(dev))
    for name, case in cases.items():
        if args.only not in name:
            continue
        kernel, plain, a, kw = case[:4]
        want64 = plain(*S.float64_tree(a), **S.float64_tree(kw))
        want32 = plain(*a, **kw)
        row = {"case": name, "fp32_plain_vs_f64": per_output(want32, want64)}
        for tree, dirs in trees.items():
            P.use(*dirs)
            got = kernel()
            torch.cuda.synchronize()
            row[f"{tree}_kernel_vs_f64"] = per_output(got, want64)
            row[f"{tree}_kernel_vs_fp32"] = worst(per_output(got, want32))
            if name in S.REAL_RELU_PATTERN_CASES:
                try:
                    want, info = case[4](name)
                    row[f"{tree}_relu_pattern"] = dict(
                        info, kernel_vs_f64_on_it=worst(per_output(got,
                                                                   want)))
                except AssertionError as e:
                    row[f"{tree}_relu_pattern"] = str(e)
            del got
        row["worst"] = {k: worst(v) for k, v in row.items()
                        if k.endswith("_vs_f64")}
        f64 = row["worst"]["fp32_plain_vs_f64"][0] > FP32_REF_TOL
        row["decision"] = "float64" if f64 else "fp32"
        row["in_bound"] = {
            tree: (row[f"{tree}_kernel_vs_fp32"][0] if not f64
                   else row["worst"][f"{tree}_kernel_vs_f64"][0])
            <= S.REL_TOL for tree in trees}
        if row["worst"]["fp32_plain_vs_f64"][0] > S.REL_TOL:
            row["fp32_plain_in_bound_of_f64"] = False
        print(json.dumps(row), flush=True)
        del want64, want32
    print(json.dumps({"nvidia_smi": smi}))


if __name__ == "__main__":
    main()
