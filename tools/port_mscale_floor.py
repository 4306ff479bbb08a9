#!/usr/bin/env python
"""PSNR floor of chip_smoke.py's mscale_2 denoise fit, from the JAX
reference.

Runs wire_tpu on the CPU (fused="never", float32) from the PyTorch port's
seed-0 init moved across with wire_tpu_torch.bridge, through the problem
as the port's denoise app builds it: preset Mscale2_ST8_3_LR8e3_E4000
(bspline_mscale_2, scales 1/9, 4, 8, 256 wide, 3 activation layers, the
freq_combine combiner 9 -> 128 -> 3, lr 8e-3), the 512^2 procedural image
halved to 256^2 and noised as wire_tpu_torch/apps/denoise.py does, full
batch of 65,536 coordinates, fit_pointwise for ITERS epochs (the LR decay
over ITERS).  Prints one JSON line with the best PSNR vs the clean image;
chip_smoke.py holds the port's kernel fit to it less 0.2 dB.  With
``--port`` a second line gives the port's plain family path
(fused="never", the same relu^2 spline) through its fit_pointwise on the
CPU from the same init, and the largest relative difference of the two
per-epoch MSE histories: what the CPU's rounding alone does to the fit.

    python tools/port_mscale_floor.py [ITERS] [--port]   # 300 by default

About 10 min and 3 GB at 300 on 8 CPU cores (the port's fit 30 min more).
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
from wire_tpu.train.trainer import FitConfig, fit_pointwise  # noqa: E402
from wire_tpu_torch.apps import common, denoise  # noqa: E402
from wire_tpu_torch.bridge import params_to_numpy  # noqa: E402
from wire_tpu_torch.nn.registry import get_inr as port_get_inr  # noqa: E402
from wire_tpu_torch.signals import coords as C  # noqa: E402
from wire_tpu_torch.train import metrics as M  # noqa: E402
from wire_tpu_torch.train import trainer as T  # noqa: E402
from wire_tpu_torch.train.presets import get_config  # noqa: E402

PRESET = "Mscale2_ST8_3_LR8e3_E4000"


def main():
    args = sys.argv[1:]
    with_port = "--port" in args
    args = [a for a in args if a != "--port"]
    iters = int(args[0]) if args else 300
    t0 = time.time()
    cfg = get_config(PRESET)
    im, im_noisy = denoise.denoise_images(cfg)
    H, W, _ = im.shape
    port = common.build_model(cfg, in_features=2, out_features=3, omega0=7.0,
                              sidelength=H)
    port_init = port.init(torch.Generator().manual_seed(0))
    init = jax.tree.map(jnp.asarray, params_to_numpy(port_init))
    spec = dict(in_features=2, out_features=3,
                hidden_features=cfg.hidden_features, hidden_layers=2,
                scale=cfg.scale, scale_tensor=cfg.scale_tensor)
    fit_kw = dict(learning_rate=cfg.learning_rate, niters=iters,
                  maxpoints=cfg.maxpoints, scale_lr_by_batch=True)
    coords, target, gt = C.grid2d(H, W), im_noisy.reshape(-1, 3), \
        im.reshape(-1, 3)
    res = fit_pointwise(get_inr(cfg.nonlin, fused="never", **spec), init,
                        coords, target, FitConfig(**fit_kw), gt=gt,
                        track="gt", donate=False)
    best = np.asarray(res.best_rec).reshape(H, W, 3)
    print(json.dumps({
        "preset": PRESET, "iters": iters,
        "psnr_db": float(M.psnr_ref(im, best)), "wall_s": time.time() - t0,
        "backend": jax.default_backend(),
        "maxrss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        / 1e6}), flush=True)
    if not with_port:
        return
    t0 = time.time()
    mine = T.fit_pointwise(port_get_inr(cfg.nonlin, fused="never", **spec),
                           port_init, coords, target, T.FitConfig(**fit_kw),
                           gt=gt, device="cpu")
    print(json.dumps({
        "preset": PRESET, "iters": iters, "path": "port, fused='never', cpu",
        "psnr_db": float(M.psnr_ref(im, mine.best_rec.reshape(H, W, 3))),
        "max_rel_mse_diff": float(np.max(np.abs(
            mine.mse_gt / np.asarray(res.mse_gt) - 1))),
        "wall_s": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main()
