#!/usr/bin/env python3
"""How far the occupancy slice's new kernel cases and their fp32 plain
versions lie from the plain versions run in float64, on one GPU: the table
that decides which reference each case is held to (PERF.md section 2's
rule, as tools/port_real_reference.py applies it).

    python3 tools/port_occupancy_reference.py

The cases are chip_smoke.py's: wire_step at the occupancy app's chunks
(occupancy_cases: n 200,000, d 3, h 212, L 3, o 1, nvalid 200,000 and
62,144, and 70,001 rows with nvalid 69,000) and real_step / the real_mlp
pair at the mscale_1 and repIN folds (slice_real_cases).  One JSON line
per case:

  fp32_plain_vs_f64   max |a - b| / max |float64| per output tensor, of the
                      fp32 plain run from the float64 run (every input
                      cast, chip_smoke.float64_tree)
  kernel_vs_f64       the same of the kernel
  kernel_vs_fp32      the kernel's largest distance from the fp32 plain run
  decision            "fp32" where the fp32 plain run lies within
                      FP32_REF_TOL (2.5e-5) x max of the float64 run at
                      every output, else "float64"
  in_bound            whether the kernel lies within chip_smoke.REL_TOL x
                      max of the reference decided
  state               for chip_smoke.OCC_STATE_CASES (where neither the
                      kernel nor the fp32 plain run meets REL_TOL of the
                      float64 run: fault C.10) the kernel's distance from
                      the float64 run on its own pre-activations
                      (chip_smoke.wire_state_reference), the fp32 plain
                      run's from the float64 run on its own, and the
                      largest distance of a given pre-activation from the
                      float64 product of the reference's activations

and last the card's name and power limit.
"""
import os
import json
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from port_real_reference import FP32_REF_TOL, per_output, worst  # noqa: E402
from wire_tpu_torch.apps import common as TC  # noqa: E402
from wire_tpu_torch.apps import occupancy as O  # noqa: E402
from wire_tpu_torch.nn import models as MM  # noqa: E402
from wire_tpu_torch.nn.registry import get_inr  # noqa: E402
from wire_tpu_torch.ops import real_mlp as RM  # noqa: E402
from wire_tpu_torch.ops import wire_step as WS  # noqa: E402
from wire_tpu_torch.train.presets import get_config  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("port_occupancy_reference.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cases = S.occupancy_cases(torch, WS, O, dev)
    cases.update(S.slice_real_cases(torch, RM, MM, TC, get_inr, get_config,
                                    dev))
    for name, case in cases.items():
        kernel, plain, a, kw = case[:4]
        want64 = plain(*S.float64_tree(a), **S.float64_tree(kw))
        want32 = plain(*a, **kw)
        got = kernel()
        torch.cuda.synchronize()
        row = {"case": name, "fp32_plain_vs_f64": per_output(want32, want64),
               "kernel_vs_f64": per_output(got, want64),
               "kernel_vs_fp32": worst(per_output(got, want32))}
        row["worst"] = {k: worst(row[k]) for k in ("fp32_plain_vs_f64",
                                                   "kernel_vs_f64")}
        f64 = row["worst"]["fp32_plain_vs_f64"][0] > FP32_REF_TOL
        row["decision"] = "float64" if f64 else "fp32"
        row["in_bound"] = (row["worst"]["kernel_vs_f64"][0] if f64
                           else row["kernel_vs_fp32"][0]) <= S.REL_TOL
        if name in S.OCC_STATE_CASES:
            params, c, t, spec = a
            want, info = S.wire_state_reference(torch, *a, kw, *case[4](),
                                                name)
            own, own_info = S.wire_state_reference(
                torch, *a, kw, *S.wire_plain_state(torch, params, c, spec),
                name)
            row["state"] = {
                "kernel_vs_state": worst(per_output(got, want)),
                "kernel_z_rel": max(info["z_rel"]),
                "fp32_plain_vs_own_state": worst(per_output(want32, own)),
                "fp32_plain_z_rel": max(own_info["z_rel"])}
            row["in_bound"] = row["state"]["kernel_vs_state"][0] <= S.REL_TOL
        print(json.dumps(row), flush=True)
        del got, want32, want64
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
