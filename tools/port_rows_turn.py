#!/usr/bin/env python3
"""Host-call times of rows 1-11 (wire_step, the wire_mlp pair, rotsum,
line_sample, the real_mlp pair, real_step, mscale2_step, wire2d_step, the
wire2d_mlp pair, the mfn_mlp pair, mfn_step) at chip_smoke.py's measure
inputs, of this tree
against an earlier one, on one GPU, one process a turn, with a digest of
each row's outputs (its bits are the same in both trees when the digests
are).

    python3 tools/port_rows_turn.py --parent DIR [--turns 3] [--iters 20]
        [--rows real_step mfn_step ...] [--kernel-ms]
    python3 tools/port_rows_turn.py --root DIR      # one turn, one tree

DIR holds an earlier tree (a git archive of its wire_tpu_torch/ and
chip_smoke.py); each turn imports that tree's own wire_tpu_torch and
chip_smoke.py (the trees' C interfaces may differ) and builds its
libraries into the tree's own _build/ on first use.  A turn times, with
CUDA events over ITERS calls after two warm-up calls, repeated three times
(the median kept): wire_step at the WIRE-300 denoise shape (65,536 rows,
its scratch reused), and the wire_mlp (CT shape, dcoords), rotsum (256^2,
100 angles) and line_sample (P 1,024) pairs forward and backward through
autograd, as chip_smoke.py's measure phase calls them; real_step at the
B-spline denoise path (65,536 rows, 2 -> 256 x 3 -> 3), the real_mlp pair
at the B-spline SISR path (28,224 rows, dcoords), mscale2_step at the
mscale_2 denoise path (65,536 rows, 3 scales), mfn_step at the MFN
denoise shape (65,536 rows, h 300, k 3) and the mfn_mlp pair at the MFN
SISR one (h 256, parameter gradients); wire2d_step at the WIRE-2D denoise
shape (65,536 rows, 300 wide) and the wire2d_mlp pair at the WIRE-2D CT
one (o 1, the CT frequencies, parameter gradients).  With --parent the turns run
earlier, this, this, earlier, ...; each turn's JSON line is printed, then
one line with each tree's median of each row, whether each row's digests
agree across the trees, and the card's name and power limit.
"""
import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = ("wire_step", "wire_mlp", "rotsum", "line_sample", "real_step",
        "real_mlp", "mscale2_step", "wire2d_step", "wire2d_mlp", "mfn_step",
        "mfn_mlp")
# each row's library (its kernels' device time: --kernel-ms)
LIBRARY = {"wire_step": "wire_step", "wire_mlp": "wire_mlp",
           "rotsum": "rotsum", "line_sample": "line_sample",
           "real_step": "real_mlp", "real_mlp": "real_mlp",
           "mscale2_step": "mscale2_step", "wire2d_step": "wire2d",
           "wire2d_mlp": "wire2d", "mfn_step": "mfn", "mfn_mlp": "mfn"}


def digest(torch, out):
    """sha256 of every tensor's bytes in ``out`` (nested dicts, lists and
    tuples, dict keys sorted), in walk order."""
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x, key=str):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif torch.is_tensor(x):
            h.update(x.detach().float().contiguous().cpu().numpy()
                     .tobytes())
    walk(out)
    return h.hexdigest()[:16]


def slice_rows(torch, S, dev):
    """{row: thunk} of rows 5-11 at the measure phase's shapes
    (chip_smoke.py's helpers, which both trees have)."""
    from wire_tpu_torch.apps import common as TC
    from wire_tpu_torch.apps import sweep as SW
    from wire_tpu_torch.nn import models as MM
    from wire_tpu_torch.nn.registry import get_inr
    from wire_tpu_torch.ops import mfn as MF
    from wire_tpu_torch.ops import mscale2_step as MS
    from wire_tpu_torch.ops import real_mlp as RM
    from wire_tpu_torch.ops import wire2d as W2
    from wire_tpu_torch.ops.wire_step import StepScratch
    from wire_tpu_torch.train.presets import get_config
    fns = {}
    n = 256 * 256
    model_a, _ = S.real_models(get_inr, TC, get_config(
        S.REAL_DENOISE_CONFIG), 7.0, 256)
    canon, kinds = S.path_canon(torch, MM, model_a, 14, dev)
    c, t, gt, _ = S.real_inputs(torch, n, 2, 3, 15, dev)
    scratch = StepScratch()
    fns["real_step"] = lambda: RM.real_step(
        canon, c, t, kinds, gt=gt, want_metrics=True, scratch=scratch)
    model_b, _ = S.real_models(get_inr, TC, get_config(
        S.REAL_SISR_CONFIG), 8.0, 168)
    canon_b, kinds_b = S.path_canon(torch, MM, model_b, 16, dev)
    cb, _, _, g = S.real_inputs(torch, 168 * 168, 2, 3, 17, dev)
    xs = [cb] + [v for _, v in RM.canon_leaves(canon_b)]
    kfn = S.real_mlp_fn(RM, len(canon_b["layers"]), kinds_b)
    fns["real_mlp"] = lambda: S.vjp(torch, kfn, xs, g)
    ms_model = S.mscale2_models(get_inr, TC, get_config(
        S.MSCALE2_CONFIG))[0]
    mcanon, comb, mkinds, inv = S.mscale2_fold(torch, MM, ms_model, 22, dev)
    mc, mt, mgt, _ = S.real_inputs(torch, n, 2, 3, 23, dev)
    ms_scratch = StepScratch()
    fns["mscale2_step"] = lambda: MS.mscale2_step(
        mcanon, comb, mc, mt, mkinds, inv, gt=mgt, want_metrics=True,
        scratch=ms_scratch)
    mfn, params, fc, ft, fgt, _ = S.mfn_case(torch, get_inr, n, 2, 300, 2, 3,
                                             24, dev)
    mfn_scratch = StepScratch()
    fns["mfn_step"] = lambda: MF.mfn_step(
        params, fc, ft, mfn.spec, gt=fgt, want_metrics=True,
        scratch=mfn_scratch)
    mfn_s, _ = S.mfn_models(get_inr, SW, "sisr", 256, 256)
    ps = mfn_s.init(torch.Generator().manual_seed(25), dev)
    sc, _, _, sg = S.real_inputs(torch, n, 2, 3, 26, dev)
    fns["mfn_mlp"] = lambda: S.param_pair(torch, MF.mfn_mlp, ps, mfn_s.spec,
                                          sc, sg)
    w2d, wp, wc, wt, wgt, _ = S.wire2d_case(torch, get_inr, n, 2, 3, 34, dev)
    w2d_scratch = StepScratch()
    fns["wire2d_step"] = lambda: W2.wire2d_step(
        wp, wc, wt, w2d.spec, gt=wgt, want_metrics=True, scratch=w2d_scratch)
    w2c, cp, cc, _, _, cg = S.wire2d_case(torch, get_inr, n, 2, 1, 35, dev,
                                          S.wire2d_ct_kw(get_config))
    fns["wire2d_mlp"] = lambda: S.param_pair(torch, W2.wire2d_mlp, cp,
                                             w2c.spec, cc, cg)
    return fns


def turn(root, iters, rows=ROWS, kernel_ms=False):
    """One tree's times and digests: {row: median ms of three repeats}
    (with ``kernel_ms`` also {row + "_kernels": the device time of its
    library's kernels a call, torch.profiler}), {row: digest of its
    outputs}."""
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
    fns.update(slice_rows(torch, S, dev))
    fns = {name: fns[name] for name in rows}
    times = {name: statistics.median(S.cuda_ms(torch, fn, iters)
                                     for _ in range(3))
             for name, fn in fns.items()}
    if kernel_ms:
        csrc = os.path.join(root, "wire_tpu_torch", "csrc")
        times.update({f"{name}_kernels": S.kernel_device_ms(
            torch, fn, iters, S.kernel_names(LIBRARY[name], csrc))
            for name, fn in fns.items()})
    return times, {name: digest(torch, fn()) for name, fn in fns.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent")
    ap.add_argument("--root")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rows", nargs="+", default=list(ROWS))
    ap.add_argument("--kernel-ms", action="store_true",
                    help="also each row's kernels' device time a call")
    a = ap.parse_args()
    if a.root:
        times, digests = turn(a.root, a.iters, a.rows, a.kernel_ms)
        print(json.dumps({"root": a.root, **times, "digest": digests}),
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
             "--iters", str(a.iters), "--rows", *a.rows]
            + (["--kernel-ms"] if a.kernel_ms else []),
            capture_output=True, text=True, check=True,
            timeout=900).stdout.strip().splitlines()[-1]
        print(out, flush=True)
        runs[root].append(json.loads(out))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "median_ms": {tree: {k: statistics.median(r[k] for r in rs)
                             for k in rs[0] if k not in ("root", "digest")}
                      for tree, rs in (("parent", runs[parent]),
                                       ("this", runs[ROOT]))},
        "bit_equal": {row: len({r["digest"][row] for rs in runs.values()
                                for r in rs}) == 1 for row in a.rows},
        "turns": a.turns, "iters": a.iters, "nvidia_smi": smi}))


if __name__ == "__main__":
    main()
