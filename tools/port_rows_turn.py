#!/usr/bin/env python3
"""Host-call times of rows 1-4 (wire_step, the wire_mlp pair, rotsum,
line_sample) at chip_smoke.py's measure inputs, of this tree against an
earlier one, on one GPU, one process a turn.

    python3 tools/port_rows_turn.py --parent DIR [--turns 3] [--iters 20]
    python3 tools/port_rows_turn.py --root DIR      # one turn, one tree

DIR holds an earlier tree (a git archive of its wire_tpu_torch/ and
chip_smoke.py); each turn imports that tree's own wire_tpu_torch and
chip_smoke.py (the trees' C interfaces may differ) and builds its
libraries into the tree's own _build/ on first use.  A turn times, with
CUDA events over ITERS calls after two warm-up calls, repeated three times
(the median kept): wire_step at the WIRE-300 denoise shape (65,536 rows,
its scratch reused), and the wire_mlp (CT shape, dcoords), rotsum (256^2,
100 angles) and line_sample (P 1,024) pairs forward and backward through
autograd, as chip_smoke.py's measure phase calls them.  With --parent
the turns run earlier, this, this, earlier, ...; each turn's JSON line is
printed, then one line with each tree's median of each row and the
card's name and power limit.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = ("wire_step", "wire_mlp", "rotsum", "line_sample")


def turn(root, iters):
    """One tree's times: {row: median ms of three repeats}."""
    sys.path.insert(0, root)
    import torch
    import chip_smoke as S
    from wire_tpu_torch.apps import ct as TCT
    from wire_tpu_torch.nn.registry import get_inr
    from wire_tpu_torch.ops import line_sample as LS
    from wire_tpu_torch.ops import rotsum as R
    from wire_tpu_torch.ops import wire_mlp as WM
    from wire_tpu_torch.ops import wire_step as WS
    from wire_tpu_torch.train.presets import get_config
    assert S.__file__.startswith(os.path.abspath(root)), S.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    model = get_inr("wire", in_features=2, out_features=3,
                    hidden_features=300, hidden_layers=2, first_omega0=7.0,
                    hidden_omega0=7.0, scale=8.0)
    params, coords, target, gt = S.inputs(torch, model, 256 * 256, 2, dev)
    scratch = WS.StepScratch()
    fns = {"wire_step": lambda: WS.wire_step(
        params, coords, target, model.spec, gt=gt, want_metrics=True,
        scratch=scratch)}
    ct_model, _ = S.ct_models(get_inr, TCT, get_config(S.CT_CONFIG))
    cases, _, _ = S.ct_kernel_cases(torch, WM, R, LS, ct_model, 256 * 256,
                                    256, 100, 1024, 513, seed=4, device=dev)
    for name, (kfn, _, _, xs, cot) in cases.items():
        fns[name] = (lambda kfn=kfn, xs=xs, cot=cot:
                     S.vjp(torch, kfn, xs, cot))
    return {name: statistics.median(S.cuda_ms(torch, fn, iters)
                                    for _ in range(3))
            for name, fn in fns.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent")
    ap.add_argument("--root")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    a = ap.parse_args()
    if a.root:
        print(json.dumps({"root": a.root, **turn(a.root, a.iters)}),
              flush=True)
        return
    parent = os.path.abspath(a.parent)
    order = []
    for _ in range(a.turns):
        order += [parent, ROOT, ROOT, parent]
    runs = {parent: [], ROOT: []}
    for root in order:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root,
             "--iters", str(a.iters)], capture_output=True, text=True,
            check=True, timeout=900).stdout.strip().splitlines()[-1]
        print(out, flush=True)
        runs[root].append(json.loads(out))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "median_ms": {tree: {row: statistics.median(r[row] for r in rs)
                             for row in ROWS}
                      for tree, rs in (("parent", runs[parent]),
                                       ("this", runs[ROOT]))},
        "turns": a.turns, "iters": a.iters, "nvidia_smi": smi}))


if __name__ == "__main__":
    main()
