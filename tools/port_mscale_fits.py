#!/usr/bin/env python3
"""How far rounding moves the mscale_2 denoise fit, on one GPU.

Runs chip_smoke.py's mscale_2 denoise problem (preset
Mscale2_ST8_3_LR8e3_E4000, the 256 x 256 image, 65,536 coordinates, full
batch, 300 epochs, the seed-0 init) through:

  kernel             fit_pointwise with csrc/mscale2_step.cu
  family_plain32     the family's own plain path (fused="never": the relu^2
                     spline and autograd), float32
  family_plain64     the same in float64
  canonical_plain32  the kernel's plain version (ops/mscale2_step.py:
                     mscale2_step_plain, the piecewise spline on the
                     canonical fold) in place of the kernel, float32
  canonical_plain64  the same in float64

and prints each fit's best PSNR (dB) and wall time, then one JSON line.
The float64 fits run fit_pointwise's loop (its Adam, the best epoch by MSE
against the clean image) on float64 tensors; fit_pointwise itself is
float32.

    python3 tools/port_mscale_fits.py
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from wire_tpu_torch import tree  # noqa: E402
from wire_tpu_torch.apps import common as TC  # noqa: E402
from wire_tpu_torch.apps import denoise as TD  # noqa: E402
from wire_tpu_torch.nn.registry import get_inr  # noqa: E402
from wire_tpu_torch.ops import mscale2_step as MS  # noqa: E402
from wire_tpu_torch.train import metrics as M  # noqa: E402
from wire_tpu_torch.train.presets import get_config  # noqa: E402
from wire_tpu_torch.train.trainer import (Adam, FitConfig,  # noqa: E402
                                          fit_pointwise)


def fit_float64(model, params, coords, target, gt, cfg, device):
    """fit_pointwise's full-batch loop in float64; the best reconstruction
    (by MSE against gt) as float32 numpy."""
    def f64(x):
        return torch.as_tensor(x).to(device, torch.float64)
    params = tree.map(lambda t: t.detach().to(device, torch.float64).clone(),
                      params)
    coords, target, gt = f64(coords), f64(target), f64(gt)
    opt = Adam(cfg, params, npoints=target.shape[0], nchunks=1)
    best, best_rec = float("inf"), None
    for _ in range(cfg.niters):
        pred, grads, (_, sse_gt) = model.step_grads(
            params, coords, target, gt=gt, want_metrics=True)
        opt.step(params, grads)
        if float(sse_gt) < best:
            best, best_rec = float(sse_gt), pred.detach().clone()
    return best_rec.float().cpu().numpy()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("port_mscale_fits.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cfg = get_config(S.MSCALE2_CONFIG)
    im, im_noisy = TD.denoise_images(cfg)
    H, W, _ = im.shape
    model, plain, _ = S.mscale2_models(get_inr, TC, cfg)
    params = model.init(torch.Generator().manual_seed(0), dev)
    grid = TD.C.grid2d(H, W)
    noisy, clean = im_noisy.reshape(-1, 3), im.reshape(-1, 3)
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=S.REAL_ITERS,
                        maxpoints=cfg.maxpoints, scale_lr_by_batch=True)

    def fit32(m):
        return fit_pointwise(m, params, grid, noisy, fit_cfg, gt=clean,
                             device=dev).best_rec

    def fit64(m):
        return fit_float64(m, params, grid, noisy, clean, fit_cfg, dev)

    kernel_step = MS.mscale2_step

    def canonical(fit):
        MS.mscale2_step = lambda canon, comb, x, t, kinds, inv, scratch=None, \
            **kw: MS.mscale2_step_plain(canon, comb, x, t, kinds, inv, **kw)
        try:
            return fit(model)
        finally:
            MS.mscale2_step = kernel_step

    runs = [("kernel", lambda: fit32(model)),
            ("family_plain32", lambda: fit32(plain)),
            ("family_plain64", lambda: fit64(plain)),
            ("canonical_plain32", lambda: canonical(fit32)),
            ("canonical_plain64", lambda: canonical(fit64))]
    out = {}
    for name, fn in runs:
        t0 = time.time()
        out[name] = float(M.psnr_ref(im, fn().reshape(H, W, 3)))
        print(f"{name}: {out[name]:.6f} dB ({time.time() - t0:.1f} s)",
              flush=True)
    print(json.dumps({"fit": "mscale_2 denoise", "epochs": S.REAL_ITERS,
                      "nvidia_smi": smi, "best_psnr_db": out}))


if __name__ == "__main__":
    main()
