#!/usr/bin/env python3
"""How far the occupancy fit's outcome moves with its permutations and
with the kernel's rounding, on one GPU: the spreads that chip_smoke.py's
fit_occupancy gates rest on.

    python3 tools/port_occupancy_fits.py [--seeds N] [--plain-seeds P]
        [--epochs E] [--save FILE.npz]
    # defaults: 12 permutation seeds, the plain path at the first 6, 200

From the occupancy app's configuration (wire_tpu_torch/apps/occupancy.py:
setup) and its seed-0 init, for each permutation seed s < N (FitConfig
.seed; the init stays seed 0) one JSON line:
  per_point      the E-epoch fit through the kernel, and through the plain
                 path (fused='never') for s < P, both on the permutations
                 of seed s: best IoU and PSNR as the app computes them, the
                 per-epoch IoU's maximum, the first epoch whose IoU passes
                 0.5 (null if none), the training MSE at epochs 10, 50,
                 100 and E, ms per epoch;
  short          20-epoch fits through the kernel, per point and with
                 block_perm 512: best IoU and PSNR.
Then a summary line: over the seeds, how many kernel and plain fits pass
IoU 0.5, their IoU quantiles, the kernel-vs-plain differences seed by
seed, the block-permuted fits' IoU less the per-point ones'; and last the
card's name and power limit.  ``--save`` writes every fit's per-epoch IoU
and MSE histories.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from wire_tpu_torch.apps import occupancy as O  # noqa: E402
from wire_tpu_torch.train.trainer import fit_pointwise  # noqa: E402


def fit(fused, epochs, seed, block_perm, dev):
    import dataclasses
    im, grid, target, model, cfg = O.setup(niters=epochs, fused=fused,
                                           block_perm=block_perm)
    cfg = dataclasses.replace(cfg, seed=seed)
    params = model.init(torch.Generator().manual_seed(0), dev)
    res = fit_pointwise(model, params, grid, target, cfg, track="noisy",
                        epoch_metric=O.iou_metric(0.5), device=dev)
    iou, psnr = O.best_metrics(im, res.best_rec.reshape(im.shape))
    hist = np.asarray(res.time_array)
    above = np.nonzero(hist > 0.5)[0]
    return {"iou": iou, "psnr_db": psnr, "ms_per_epoch": res.step_ms,
            "max_epoch_iou": float(hist.max()),
            "onset_epoch": int(above[0]) + 1 if len(above) else None,
            "mse": {e: float(res.mse_noisy[e - 1])
                    for e in (10, 50, 100, epochs) if e <= epochs}}, \
        (hist, np.asarray(res.mse_noisy))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--plain-seeds", type=int, default=6)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--save")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel, plain, short, hists = {}, {}, {}, {}
    for s in range(args.seeds):
        kernel[s], hists[f"kernel_{s}"] = fit("auto", args.epochs, s, 0,
                                              dev)
        row = {"seed": s, "per_point": {"kernel": kernel[s]}}
        if s < args.plain_seeds:
            plain[s], hists[f"plain_{s}"] = fit("never", args.epochs, s, 0,
                                                dev)
            row["per_point"]["plain"] = plain[s]
        short[s] = {name: fit("auto", 20, s, block, dev)[0]
                    for name, block in (("per_point", 0),
                                        ("block_perm_512", 512))}
        row["short"] = short[s]
        print(json.dumps(row), flush=True)

    def spread(fits):
        ious = np.array([f["iou"] for f in fits.values()])
        return {"fits": len(ious), "above_0.5": int((ious > 0.5).sum()),
                "iou_quantiles": [float(q) for q in np.quantile(
                    ious, [0.0, 0.25, 0.5, 0.75, 1.0])]}
    print(json.dumps({
        "summary": "occupancy", "epochs": args.epochs,
        "kernel": spread(kernel), "plain": spread(plain),
        "kernel_minus_plain": {s: {k: kernel[s][k] - plain[s][k]
                                   for k in ("iou", "psnr_db")}
                               for s in plain},
        "block_minus_per_point_iou_20": {
            s: short[s]["block_perm_512"]["iou"]
            - short[s]["per_point"]["iou"] for s in short}}))
    if args.save:
        np.savez(args.save, **{f"{k}_{w}": v[i] for k, v in hists.items()
                               for i, w in enumerate(("iou", "mse"))})
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
