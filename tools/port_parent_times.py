#!/usr/bin/env python3
"""Times and outputs of this tree's kernels against an earlier tree's, in
one process on one GPU, in turns (earlier, this, this, earlier).

    python3 tools/port_parent_times.py --parent DIR [--iters 20]
                                       [--mscale2-fit EPOCHS]
                                       [--mfn-fit EPOCHS]
    python3 tools/port_parent_times.py --parent DIR --ct TURNS

DIR holds an earlier tree (a git archive of it) whose
wire_tpu_torch/csrc is built into DIR/wire_tpu_torch/_build; both trees'
libraries keep the same C interface, so this tree's wrappers drive either.
At chip_smoke.py's measure inputs: wire_step at the WIRE-300 denoise
shape, the wire_mlp pair at the CT shape (with dcoords), wire2d_step at
the WIRE-2D denoise shape, the wire2d_mlp pair at the WIRE-2D CT shape
(parameter gradients), mscale2_step at the Mscale2 denoise shape,
mfn_step at the MFN denoise shape and the mfn_mlp pair at the MFN SISR
shape (with dcoords), real_step at the B-spline denoise shape and the
real_mlp pair at the B-spline SISR shape (with dcoords).
Prints per turn the ms of a host call (CUDA events over ITERS calls after
two warm-up calls) and its kernels' device time (torch.profiler, the
kernels of that tree's library alone), then one JSON line with the mean
of each tree's two turns, for each kernel whether its outputs of the two trees' first turns
are identical bit for bit (else their largest distance over max |earlier|
per output tensor), and the card's name and power limit.  This tree's
wrapper drives both trees' libraries, so their C interfaces must match:
mscale2_step_run and the wire2d entry points took replica arguments in
the slice that gave them a replica axis, so compare across that change
with tools/port_rows_turn.py, which imports each tree's own wrappers.  ``--mscale2-fit EPOCHS`` adds the Mscale2 denoise fit
(chip_smoke.py's fit_mscale2 through the kernel: the preset's image, the
seed-0 init, full batch) for EPOCHS epochs per turn, its ms per step
(fit_pointwise's step_ms, the first step left out) and best PSNR;
``--mfn-fit EPOCHS`` the same of the MFN denoise fit (chip_smoke.py's
fit_mfn: the sweep's image and model, the seed-0 init, full batch).

``--ct TURNS`` times the CT path instead, TURNS times per tree in turns
(earlier, this, this, earlier, earlier, this, ...), one process a turn
(``tools/port_ct_turn.py``, which imports that tree's own wire_tpu_torch
and chip_smoke.py, since the line_sample wrappers of the trees differ):
row 4's call and its kernels, the fourier operator's vjp and its device
launches, and the CT auto and WIRE-2D CT fits' ms per iteration; prints
each turn's JSON line, then one line with each tree's median of each.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
import wire_tpu_torch.nn.models as MM  # noqa: E402
from wire_tpu_torch.apps import common as TC  # noqa: E402
from wire_tpu_torch.nn.registry import get_inr  # noqa: E402
from wire_tpu_torch.ops import build  # noqa: E402
from wire_tpu_torch.ops import mfn as MF  # noqa: E402
from wire_tpu_torch.ops import mscale2_step as MS  # noqa: E402
from wire_tpu_torch.ops import real_mlp as RM  # noqa: E402
from wire_tpu_torch.ops import wire2d as W2  # noqa: E402
from wire_tpu_torch.ops import wire_mlp as WM  # noqa: E402
from wire_tpu_torch.ops import wire_step as WS  # noqa: E402
from wire_tpu_torch.train.presets import get_config  # noqa: E402


def use(csrc, build_dir):
    build.CSRC_DIR, build.BUILD_DIR = csrc, build_dir
    build.load.cache_clear()
    for mod in (WS, WM, W2, MS, MF, RM):
        mod._lib.cache_clear()


def calls(dev):
    """{name: fn(scratch) -> {output name: tensor}} at the smoke's measure
    inputs."""
    wire = get_inr("wire", in_features=2, out_features=3,
                   hidden_features=300, hidden_layers=2, first_omega0=7.0,
                   hidden_omega0=7.0, scale=8.0)
    wp, wc, wt, wg = S.inputs(torch, wire, 256 * 256, 2, dev)
    cfg = get_config(S.CT_CONFIG)
    ct = get_inr("wire", in_features=2, out_features=1, hidden_features=300,
                 hidden_layers=2, first_omega0=cfg.omega0,
                 hidden_omega0=cfg.omega0, scale=cfg.scale)
    cp = ct.init(torch.Generator().manual_seed(4), dev)
    rng = np.random.default_rng(4)
    cc, cg = (torch.tensor(a.astype(np.float32), device=dev) for a in (
        rng.uniform(-1, 1, (256 * 256, 2)), rng.normal(size=(256 * 256, 1))))
    ct_fn = S.pair_fn(WM.wire_mlp, ct.spec, S.leaf_paths(cp))
    ct_xs = [cc] + [t for _, t in S.tree_leaves(cp)]
    m2d, p2d, c2d, t2d, g2d, _ = S.wire2d_case(torch, get_inr, 256 * 256, 2,
                                                3, 34, dev)
    m2c, p2c, c2c, _, _, gc2 = S.wire2d_case(
        torch, get_inr, 256 * 256, 2, 1, 35, dev, S.wire2d_ct_kw(get_config))
    w2_fn = S.pair_fn(W2.wire2d_mlp, m2c.spec, S.leaf_paths(p2c))
    w2_leaves = [t for _, t in S.tree_leaves(p2c)]
    ms_model = S.mscale2_models(get_inr, TC, get_config(S.MSCALE2_CONFIG))[0]
    canon, comb, kinds, inv = S.mscale2_fold(torch, MM, ms_model, 22, dev)
    mc, mt, mg, _ = S.real_inputs(torch, 256 * 256, 2, 3, 23, dev)
    mfs, mfp, mfc, mft, mfg, _ = S.mfn_case(torch, get_inr, 256 * 256, 2,
                                            300, 2, 3, 27, dev)
    mfs2, mfp2, mfc2, _, _, mfg2 = S.mfn_case(torch, get_inr, 256 * 256, 2,
                                              256, 2, 3, 28, dev)
    mf_fn = S.pair_fn(MF.mfn_mlp, mfs2.spec, S.leaf_paths(mfp2))
    mf_xs = [mfc2] + [t for _, t in S.tree_leaves(mfp2)]
    model_a, _ = S.real_models(get_inr, TC, get_config(S.REAL_DENOISE_CONFIG),
                               7.0, 256)
    model_b, _ = S.real_models(get_inr, TC, get_config(S.REAL_SISR_CONFIG),
                               8.0, 168)
    ra, rka = S.path_canon(torch, MM, model_a, 14, dev)
    rc, rt, rg, _ = S.real_inputs(torch, 256 * 256, 2, 3, 15, dev)
    rb, rkb = S.path_canon(torch, MM, model_b, 16, dev)
    rc2, _, _, rg2 = S.real_inputs(torch, 168 * 168, 2, 3, 17, dev)
    r_fn = S.real_mlp_fn(RM, len(rb["layers"]), rkb)
    r_xs = [rc2] + [t for _, t in RM.canon_leaves(rb)]
    return {
        "real_step": lambda scratch: S.real_step_tensors(RM, *RM.real_step(
            ra, rc, rt, rka, gt=rg, want_metrics=True, scratch=scratch)),
        "real_mlp": lambda scratch: S.vjp(torch, r_fn, r_xs, rg2),
        "wire_step": lambda scratch: S.tensors_of(*WS.wire_step(
            wp, wc, wt, wire.spec, gt=wg, want_metrics=True,
            scratch=scratch)),
        "wire_mlp": lambda scratch: S.vjp(torch, ct_fn, ct_xs, cg),
        "wire2d_step": lambda scratch: S.tensors_of(*W2.wire2d_step(
            p2d, c2d, t2d, m2d.spec, gt=g2d, want_metrics=True,
            scratch=scratch)),
        "wire2d_mlp": lambda scratch: S.param_vjp(torch, w2_fn, c2c,
                                                  w2_leaves, gc2),
        "mscale2_step": lambda scratch: S.mscale2_tensors(*MS.mscale2_step(
            canon, comb, mc, mt, kinds, inv, gt=mg, want_metrics=True,
            scratch=scratch)),
        "mfn_step": lambda scratch: S.tensors_of(*MF.mfn_step(
            mfp, mfc, mft, mfs.spec, gt=mfg, want_metrics=True,
            scratch=scratch)),
        "mfn_mlp": lambda scratch: S.vjp(torch, mf_fn, mf_xs, mfg2)}


def mscale2_fit(dev, epochs):
    """() -> (ms per step, best PSNR dB) of the Mscale2 denoise fit through
    the kernel, as chip_smoke.py's fit_mscale2 runs it."""
    from wire_tpu_torch.apps import denoise as TD
    from wire_tpu_torch.train import metrics as M
    from wire_tpu_torch.train.trainer import FitConfig, fit_pointwise
    cfg = get_config(S.MSCALE2_CONFIG)
    im, im_noisy = TD.denoise_images(cfg)
    H, W, _ = im.shape
    model = S.mscale2_models(get_inr, TC, cfg)[0]
    params = model.init(torch.Generator().manual_seed(0), dev)
    grid = TD.C.grid2d(H, W)
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=epochs,
                        maxpoints=cfg.maxpoints, scale_lr_by_batch=True)

    def fit():
        res = fit_pointwise(model, params, grid, im_noisy.reshape(-1, 3),
                            fit_cfg, gt=im.reshape(-1, 3), device=dev)
        return res.step_ms, float(M.psnr_ref(im, res.best_rec.reshape(H, W,
                                                                      3)))
    return fit


def mfn_fit(dev, epochs):
    """() -> (ms per step, best PSNR dB) of the MFN denoise fit through the
    kernel, as chip_smoke.py's fit_mfn runs it."""
    from wire_tpu_torch.apps import sweep as SW
    from wire_tpu_torch.train import metrics as M
    from wire_tpu_torch.train.trainer import FitConfig, fit_pointwise
    im, im_noisy = SW.denoise_images()
    H, W, _ = im.shape
    model, _ = S.mfn_models(get_inr, SW, "denoise", H, W)
    params = model.init(torch.Generator().manual_seed(0), dev)
    grid = SW.C.grid2d(H, W)
    fit_cfg = FitConfig(learning_rate=SW._DENOISE_LR["mfn"], niters=epochs,
                        maxpoints=256 * 256, scale_lr_by_batch=True)

    def fit():
        res = fit_pointwise(model, params, grid, im_noisy.reshape(-1, 3),
                            fit_cfg, gt=im.reshape(-1, 3), device=dev)
        return res.step_ms, float(M.psnr_ref(im, res.best_rec.reshape(H, W,
                                                                      3)))
    return fit


def distance(got, want):
    """True where every output is identical bit for bit, else the largest
    max |got - want| / max |want| over the outputs."""
    if all(torch.equal(got[k], want[k]) for k in want):
        return True
    return max(float((got[k] - want[k]).abs().max())
               / max(float(want[k].abs().max()), 1e-30) for k in want)


def compare_trees(trees, iters, names=None, fit_epochs=0, mfn_epochs=0):
    """Times (ms per host call, in turns earlier, this, this, earlier) and
    the first turns' outputs of trees {"parent": (csrc, build dir), "this":
    (...)}, and with fit_epochs (mfn_epochs) the Mscale2 (MFN) denoise
    fit's ms per step and best PSNR per turn; prints each turn and returns
    the JSON summary."""
    dev = torch.device("cuda", 0)
    fns = calls(dev)
    names = names or list(fns)
    times = {tree: {name: [] for name in names} for tree in trees}
    kernel_times = {tree: {name: [] for name in names} for tree in trees}
    outs = {}
    fitters = {}
    if fit_epochs:
        fitters["mscale2"] = mscale2_fit(dev, fit_epochs)
    if mfn_epochs:
        fitters["mfn"] = mfn_fit(dev, mfn_epochs)
    fits = {f: {tree: [] for tree in trees} for f in fitters}
    for tree in ("parent", "this", "this", "parent"):
        use(*trees[tree])
        for f, fit in fitters.items():
            fits[f][tree].append(fit())
            print(f"{tree} {f} fit: {fits[f][tree][-1]}", flush=True)
        for name in names:
            scratch = WS.StepScratch()
            if tree not in outs.get(name, {}):
                outs.setdefault(name, {})[tree] = fns[name](scratch)
            ms = S.cuda_ms(torch, lambda: fns[name](scratch), iters)
            kms = S.kernel_device_ms(
                torch, lambda: fns[name](scratch), iters,
                S.kernel_names(S.KERNELS[name][0], csrc=trees[tree][0]))
            times[tree][name].append(ms)
            kernel_times[tree][name].append(kms)
            print(f"{tree} {name}: {ms:.4f} ms, kernels {kms} ms",
                  flush=True)
            del scratch
    res = {f"{f}_fit_ms_per_step_psnr_db": v for f, v in fits.items()}
    return {**res,
            "ms": {tree: {name: sum(v) / len(v) for name, v in by.items()}
                   for tree, by in times.items()},
            "kernel_ms": {tree: {name: sum(v) / len(v) if None not in v
                                 else None for name, v in by.items()}
                          for tree, by in kernel_times.items()},
            "bits_equal_or_distance": {
                name: distance(o["this"], o["parent"])
                for name, o in outs.items()}}


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def ct_turns(trees, turns):
    """{tree: {field: median over TURNS turns}} of tools/port_ct_turn.py
    run on each tree root of ``trees`` in turns."""
    import statistics
    runs = {tree: [] for tree in trees}
    for i in range(turns):
        for tree in (("parent", "this") if i % 2 == 0 else
                     ("this", "parent")):
            proc = subprocess.run(
                [sys.executable, os.path.join(ROOT, "tools",
                                              "port_ct_turn.py"),
                 trees[tree]], capture_output=True, text=True, check=True)
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"turn": i, "tree": tree, **line}), flush=True)
            runs[tree].append(line)
    return {tree: {k: statistics.median(r[k] for r in rs)
                   for k in rs[0] if isinstance(rs[0][k], (int, float))}
            for tree, rs in runs.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--mscale2-fit", type=int, default=0, metavar="EPOCHS")
    ap.add_argument("--mfn-fit", type=int, default=0, metavar="EPOCHS")
    ap.add_argument("--ct", type=int, default=0, metavar="TURNS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("port_parent_times.py needs a CUDA device")
    if args.ct:
        medians = ct_turns({"parent": os.path.abspath(args.parent),
                            "this": ROOT}, args.ct)
        print(json.dumps({"nvidia_smi": smi(), "turns": args.ct,
                          "median": medians}))
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = {"parent": (os.path.join(args.parent, "wire_tpu_torch", "csrc"),
                        os.path.join(args.parent, "wire_tpu_torch",
                                     "_build")),
             "this": (build.CSRC_DIR, build.BUILD_DIR)}
    res = compare_trees(trees, args.iters, fit_epochs=args.mscale2_fit,
                        mfn_epochs=args.mfn_fit)
    print(json.dumps({"nvidia_smi": smi(), "iters": args.iters, **res}))


if __name__ == "__main__":
    main()
