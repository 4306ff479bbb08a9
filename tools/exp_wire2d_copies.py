#!/usr/bin/env python3
"""WIRE-2D's copy widths at h = 150 units per head, on one GPU: the loop as
committed, which decides 16-byte copies of A and of B apart
(csrc/wire_tc.cuh:access: A's rows take them at K = 300 and 600, B's
mapped columns need h % 4 == 0 and take 4-byte ones), against a variant
where A takes 16-byte copies only where B does too (the rule before the
two were split: at h = 150 every copy is 4 bytes).

    python3 tools/exp_wire2d_copies.py [--iters 20]

The variant is a text substitution of a copy of csrc/, built by nvcc with
the package's flags.  wire2d_step at the WIRE-2D denoise shape and the
wire2d_mlp pair at the WIRE-2D CT shape (chip_smoke.py's measure inputs)
run in turns in one process, variant ("parent" in the output),
committed, committed, variant, through tools/port_parent_times.py; its
JSON line also says whether the two give identical bits (they should:
only copies differ).
"""
import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch  # noqa: E402

import port_parent_times as P  # noqa: E402
from wire_tpu_torch.ops import build  # noqa: E402

JOINT_RULE = ("  return {K % 4 == 0 && aligned(A, 16),",
              "  return {K % 4 == 0 && h % 4 == 0 && aligned(A, 16),")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("exp_wire2d_copies.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=build.BUILD_DIR, prefix="exp_copies_")
    try:
        csrc = os.path.join(tmp, "csrc")
        shutil.copytree(build.CSRC_DIR, csrc)
        path = os.path.join(csrc, "wire_tc.cuh")
        with open(path) as f:
            text = f.read()
        assert JOINT_RULE[0] in text, JOINT_RULE[0]
        with open(path, "w") as f:
            f.write(text.replace(*JOINT_RULE))
        res = P.compare_trees(
            {"parent": (csrc, os.path.join(tmp, "_build")),
             "this": (build.CSRC_DIR, build.BUILD_DIR)},
            args.iters, names=["wire2d_step", "wire2d_mlp"])
        print(json.dumps({"nvidia_smi": P.smi(), "iters": args.iters,
                          "parent": "A and B 4-byte copies at h = 150",
                          **res}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
