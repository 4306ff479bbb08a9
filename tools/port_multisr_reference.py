#!/usr/bin/env python3
"""How far the multi-SR slice's pair cases lie from their plain versions
run in float64, per case, on one GPU: the table that decides which
reference chip_smoke.py holds each of them to.

    python3 tools/port_multisr_reference.py

For every case of chip_smoke.py:multisr_cases (wire_mlp at h 181, L 2,
o 3, omega0 10, sigma 5 on the app's (4, 36,864, 2) frame grids without
dcoords and on a ragged (3, 4,097, 2) with dcoords; the real_mlp pair at
the app's gauss and posenc folds and the mfn_mlp pair at its mfn, 256
wide, o 3, on the frame grids) and the card test's wire_mlp case
(tests/test_torch_gpu.py::test_wire_mlp_at_the_multi_sr_batch_matches_plain)
it runs the plain version in float64 (every input cast,
chip_smoke.float64_tree) and in float32, and the kernel, and prints one
JSON line per case:

  fp32_plain_vs_f64   max |a - b| / max |float64| per output, of the fp32
                      plain run from the float64 run
  kernel_vs_f64       the same of the kernel
  kernel_vs_fp32      the kernel's largest distance from the fp32 plain run
  worst               each comparison's largest distance and its output
  decision            "fp32" where the fp32 plain run lies within
                      FP32_REF_TOL (2.5e-5) x max of the float64 run at
                      every output; else "float64", or for a relu pair
                      "relu_pattern" (fault C.9's check: the float64 run
                      on the kernel's own relu pattern; a relu input
                      within fp32 rounding of its kink, decided the other
                      way, moves a gradient sum over 147,456 rows by
                      ~1 / sqrt(rows) of its size, so no fp32 evaluation
                      can be held to float64 there)
  kernel_vs_decided   the kernel's largest distance from the reference
                      decided, and whether it lies within REL_TOL

and last the card's name and power limit.
"""
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from wire_tpu_torch.apps import multi_sr as TMS  # noqa: E402
from wire_tpu_torch.nn import models as MM  # noqa: E402
from wire_tpu_torch.ops import mfn as MF  # noqa: E402
from wire_tpu_torch.ops import real_mlp as RM  # noqa: E402
from wire_tpu_torch.ops import wire_mlp as WM  # noqa: E402

FP32_REF_TOL = 2.5e-5


def per_output(got, want):
    """{output: max |got - want| / max |want|} (outputs reshaped to the
    reference's shape)."""
    return {k: float((got[k].double().reshape(w.shape) - w.double()).abs()
                     .max()) / max(float(w.double().abs().max()), 1e-300)
            for k, w in want.items()}


def worst(d):
    name = max(d, key=d.get)
    return d[name], name


def card_test_case(dev):
    """The card test's wire_mlp case, built as it builds it."""
    from tests import test_torch_gpu as G
    params, spec, c, g = G._multisr_wire_case(dev)
    return S.wire_pair_case(torch, WM, params, spec, c, g, dcoords=False)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("port_multisr_reference.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cases = S.multisr_cases(torch, np, TMS, WM, RM, MM, MF, dev)
    cases["test wire_mlp multisr"] = card_test_case(dev)
    for name, case in cases.items():
        kernel, plain, a, kw = case[:4]
        want64 = plain(*S.float64_tree(a), **S.float64_tree(kw))
        want32 = plain(*a, **kw)
        got = kernel()
        torch.cuda.synchronize()
        row = {"case": name,
               "fp32_plain_vs_f64": per_output(want32, want64),
               "kernel_vs_f64": per_output(got, want64),
               "kernel_vs_fp32": worst(per_output(got, want32))}
        row["worst"] = {k: worst(row[k]) for k in ("fp32_plain_vs_f64",
                                                   "kernel_vs_f64")}
        fp32_off = row["worst"]["fp32_plain_vs_f64"][0]
        if fp32_off <= FP32_REF_TOL:
            row["decision"] = "fp32"
            decided = row["kernel_vs_fp32"]
        elif len(case) > 4:
            row["decision"] = "relu_pattern"
            want, flips = case[4](name)
            row["relu_pattern"] = flips
            decided = worst(per_output(got, want))
        else:
            row["decision"] = "float64"
            decided = row["worst"]["kernel_vs_f64"]
        row["kernel_vs_decided"] = list(decided) + [decided[0] <= S.REL_TOL]
        print(json.dumps(row), flush=True)
        del want64, want32, got
        torch.cuda.empty_cache()
    print(json.dumps({"nvidia_smi": smi}))


if __name__ == "__main__":
    main()
