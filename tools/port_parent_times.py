#!/usr/bin/env python3
"""Times of this tree's kernels against an earlier tree's, in one process
on one GPU, in turns (earlier, this, this, earlier).

    python3 tools/port_parent_times.py --parent DIR [--iters 20]

DIR holds an earlier tree (a git archive of it) whose
wire_tpu_torch/csrc is built into DIR/wire_tpu_torch/_build; both trees'
libraries keep the same C interface, so this tree's wrappers drive either.
For wire_step at the WIRE-300 denoise shape and mscale2_step at the
Mscale2 denoise shape (chip_smoke.py's measure inputs), prints per turn
the ms of a host call (CUDA events over ITERS calls after two warm-up
calls), then one JSON line with the mean of each tree's two turns and the
card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
import wire_tpu_torch.nn.models as MM  # noqa: E402
from wire_tpu_torch.apps import common as TC  # noqa: E402
from wire_tpu_torch.nn.registry import get_inr  # noqa: E402
from wire_tpu_torch.ops import build  # noqa: E402
from wire_tpu_torch.ops import mscale2_step as MS  # noqa: E402
from wire_tpu_torch.ops import wire_step as WS  # noqa: E402
from wire_tpu_torch.train.presets import get_config  # noqa: E402


def use(csrc, build_dir):
    build.CSRC_DIR, build.BUILD_DIR = csrc, build_dir
    build.load.cache_clear()
    WS._lib.cache_clear()
    MS._lib.cache_clear()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("port_parent_times.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    trees = {"parent": (os.path.join(args.parent, "wire_tpu_torch", "csrc"),
                        os.path.join(args.parent, "wire_tpu_torch",
                                     "_build")),
             "this": (build.CSRC_DIR, build.BUILD_DIR)}

    wire = get_inr("wire", in_features=2, out_features=3,
                   hidden_features=300, hidden_layers=2, first_omega0=7.0,
                   hidden_omega0=7.0, scale=8.0)
    wp, wc, wt, wg = S.inputs(torch, wire, 256 * 256, 2, dev)
    ms_model = S.mscale2_models(get_inr, TC, get_config(S.MSCALE2_CONFIG))[0]
    canon, comb, kinds, inv = S.mscale2_fold(torch, MM, ms_model, 22, dev)
    mc, mt, mg, _ = S.real_inputs(torch, 256 * 256, 2, 3, 23, dev)
    calls = {
        "wire_step": lambda scratch: WS.wire_step(
            wp, wc, wt, wire.spec, gt=wg, want_metrics=True,
            scratch=scratch),
        "mscale2_step": lambda scratch: MS.mscale2_step(
            canon, comb, mc, mt, kinds, inv, gt=mg, want_metrics=True,
            scratch=scratch)}
    times = {tree: {name: [] for name in calls} for tree in trees}
    for tree in ("parent", "this", "this", "parent"):
        use(*trees[tree])
        for name, call in calls.items():
            scratch = WS.StepScratch()
            ms = S.cuda_ms(torch, lambda: call(scratch), args.iters)
            times[tree][name].append(ms)
            print(f"{tree} {name}: {ms:.4f} ms", flush=True)
    print(json.dumps({"nvidia_smi": smi, "iters": args.iters, "ms": {
        tree: {name: sum(v) / len(v) for name, v in by.items()}
        for tree, by in times.items()}}))


if __name__ == "__main__":
    main()
