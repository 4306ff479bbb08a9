#!/usr/bin/env python
"""PSNR floors of chip_smoke.py's B-spline fits, from the JAX reference.

Runs wire_tpu on the CPU (fused="never", float32) from the PyTorch port's
seed-0 init moved across with wire_tpu_torch.bridge, through the same
problems as the port's apps build them:

- denoise (path A): preset Bspline_s9_5_LR8e3_E4000 (bspline_form, scale
  1/9.5, 256 wide, 3 activation layers, lr 8e-3), the 512^2 procedural
  image halved to 256^2 and noised as wire_tpu_torch/apps/denoise.py does,
  full batch of 65,536 coordinates, fit_pointwise for ITERS epochs (the LR
  decay over ITERS); the best PSNR vs the clean image;
- sisr (path B): preset Bspline_s9_LR1e3_E2000 (scale 1/9, lr 1e-3,
  down_scale 4, LR decay to 0.2), the 512^2 image shrunk by a third to
  171^2 (cv2 INTER_AREA), cropped to 168^2 and area-downscaled to 42^2 as
  wire_tpu_torch/apps/sisr.py does, fit_operator through the x4 box
  downsample for ITERS iterations; the best -10 log10(MSE) vs the clean HR
  image.

Prints one JSON line per path.  chip_smoke.py holds the port's kernel fits
to these numbers less 0.2 dB.

    python tools/port_real_floor.py [ITERS] [denoise|sisr ...]   # 300 both

About 90 s and 1 GB for both at 300 on 8 CPU cores.
"""
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from wire_tpu.nn import get_inr  # noqa: E402
from wire_tpu.operators.forward import DownsampleOp  # noqa: E402
from wire_tpu.train.trainer import (FitConfig, fit_operator,  # noqa: E402
                                    fit_pointwise)
from wire_tpu_torch.apps import common, denoise, sisr  # noqa: E402
from wire_tpu_torch.bridge import params_to_numpy  # noqa: E402
from wire_tpu_torch.signals import coords as C  # noqa: E402
from wire_tpu_torch.train import metrics as M  # noqa: E402
from wire_tpu_torch.train.presets import get_config  # noqa: E402

DENOISE = "Bspline_s9_5_LR8e3_E4000"
SISR = "Bspline_s9_LR1e3_E2000"


def jax_model(cfg):
    return get_inr(cfg.nonlin, fused="never", in_features=2, out_features=3,
                   hidden_features=cfg.hidden_features, hidden_layers=2,
                   scale=cfg.scale)


def port_init(cfg, omega0, sidelength):
    model = common.build_model(cfg, in_features=2, out_features=3,
                               omega0=omega0, sidelength=sidelength)
    init = model.init(torch.Generator().manual_seed(0))
    return jax.tree.map(jnp.asarray, params_to_numpy(init))


def run_denoise(iters):
    cfg = get_config(DENOISE)
    im, im_noisy = denoise.denoise_images(cfg)
    H, W, _ = im.shape
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=iters,
                        maxpoints=cfg.maxpoints, scale_lr_by_batch=True)
    res = fit_pointwise(jax_model(cfg), port_init(cfg, 7.0, H),
                        C.grid2d(H, W), im_noisy.reshape(-1, 3), fit_cfg,
                        gt=im.reshape(-1, 3), track="gt", donate=False)
    best = np.asarray(res.best_rec).reshape(H, W, 3)
    return {"psnr_db": float(M.psnr_ref(im, best))}


def run_sisr(iters):
    cfg = get_config(SISR)
    im, im_lr = sisr.sisr_images(None, 0, cfg.down_scale)
    H, W, _ = im.shape
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=iters,
                        maxpoints=cfg.maxpoints, lr_decay=0.2)
    res = fit_operator(jax_model(cfg), port_init(cfg, 8.0, H),
                       C.grid2d(H, W), im_lr, DownsampleOp(cfg.down_scale),
                       fit_cfg, gt_field=im, field_shape=(H, W, 3),
                       track="gt", donate=False)
    return {"mse_db": M.mse_db(float(res.best_mse)),
            "ssim": float(M.ssim(im, np.asarray(res.best_rec),
                                 data_range=1.0))}


def main():
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    paths = sys.argv[2:] or ["denoise", "sisr"]
    for path in paths:
        t0 = time.time()
        out = {"denoise": run_denoise, "sisr": run_sisr}[path](iters)
        print(json.dumps({
            "path": path, "iters": iters, **out, "wall_s": time.time() - t0,
            "backend": jax.default_backend(),
            "maxrss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            / 1e6}), flush=True)


if __name__ == "__main__":
    main()
