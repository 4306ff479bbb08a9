#!/usr/bin/env python
"""PSNR floor of chip_smoke.py's fit_tv phase, from the JAX reference.

Builds the phase's problem as the port's denoise app does: the 512^2
procedural natural image written as an 8-bit PNG by the port's writer
(``chip_smoke.write_tv_png``), read back through ``--image``'s path
(``apps/common.py:load_image``: min-max normalized), halved by area
averaging and noised (tau 30, readout 2) by ``apps/denoise.py:
denoise_images``.  Then wire_tpu's fit_pointwise on the CPU (fused="never",
float32) of the phase's preset (``chip_smoke.TV_BASE_CONFIG``: WIRE-300,
omega0 7, sigma 8, lr 5e-3 scaled by batch, the full batch of 65,536
coordinates) with ``tv_weight`` = lambda_tv over the full render, from the
PyTorch port's seed-0 init moved across with wire_tpu_torch.bridge.
Prints one JSON line per lambda_tv: the best PSNR vs the clean image.
chip_smoke.py holds the port's fit at ``chip_smoke.TV_LAMBDA`` to it less
0.2 dB.  About 5 min and 2 GB a lambda at 300 epochs on 8 CPU cores.

    python tools/port_tv_floor.py [EPOCHS] [LAMBDA ...]   # 300, TV_LAMBDA
"""
import json
import os
import resource
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from wire_tpu.nn import get_inr  # noqa: E402
from wire_tpu.train.trainer import FitConfig, fit_pointwise  # noqa: E402
from wire_tpu_torch.apps import common, denoise  # noqa: E402
from wire_tpu_torch.bridge import params_to_numpy  # noqa: E402
from wire_tpu_torch.signals import coords as C  # noqa: E402
from wire_tpu_torch.train import metrics as M  # noqa: E402
from wire_tpu_torch.train.presets import get_config  # noqa: E402


def main():
    epochs = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    lambdas = [float(x) for x in sys.argv[2:]] or [chip_smoke.TV_LAMBDA]
    cfg = get_config(chip_smoke.TV_BASE_CONFIG)
    with tempfile.TemporaryDirectory() as tmp:
        png = chip_smoke.write_tv_png(np, os.path.join(tmp, "tv.png"))
        im, im_noisy = denoise.denoise_images(cfg, png)
    H, W, _ = im.shape
    torch_model = common.build_model(cfg, in_features=2, out_features=3,
                                     omega0=cfg.omega0, sidelength=H)
    init = torch_model.init(torch.Generator().manual_seed(0))
    params = jax.tree.map(jnp.asarray, params_to_numpy(init))
    model = get_inr(cfg.nonlin, fused="never", in_features=2,
                    out_features=3, hidden_features=cfg.hidden_features,
                    hidden_layers=2, first_omega0=cfg.omega0,
                    hidden_omega0=cfg.omega0, scale=cfg.scale)
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=epochs,
                        maxpoints=cfg.maxpoints, scale_lr_by_batch=True)
    for lam in lambdas:
        t0 = time.time()
        res = fit_pointwise(model, params, C.grid2d(H, W),
                            im_noisy.reshape(-1, 3), fit_cfg,
                            gt=im.reshape(-1, 3), track="gt",
                            tv_weight=lam, image_shape=(H, W, 3),
                            donate=False)
        best = np.asarray(res.best_rec).reshape(H, W, 3)
        print(json.dumps({
            "config": chip_smoke.TV_BASE_CONFIG, "epochs": epochs,
            "lambda_tv": lam, "psnr_db": M.psnr_ref(im, best),
            "best_mse": float(res.best_mse),
            "best_epoch": int(np.argmin(np.asarray(res.mse_gt))),
            "wall_s": time.time() - t0, "backend": jax.default_backend(),
            "maxrss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            / 1e6}), flush=True)


if __name__ == "__main__":
    main()
