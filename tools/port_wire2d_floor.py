#!/usr/bin/env python
"""PSNR floors of chip_smoke.py's WIRE-2D fits, from the JAX reference.

Runs wire_tpu on the CPU (fused="never", float32) from the PyTorch port's
seed-0 init (``get_inr("wire2d", ...)``, ``torch.Generator().manual_seed(0)``)
moved across with wire_tpu_torch.bridge, on the two problems the smoke
fits WIRE-2D to (300 hidden features: 150 complex units per head, 2
hidden layers):

- denoise: the bench protocol (256 x 256 synthetic image, measure_np(snr 2,
  tau 30, RandomState(0)), 65,536 coordinates in one full batch, lr 5e-3
  scaled by batch), omega0 7, sigma 8, 3 outputs; fit_pointwise for ITERS
  epochs; the best PSNR vs the clean image;
- ct: the CT protocol of preset WIRE_s12_o8_LR5e3_E2000 (the 512^2
  procedural image halved to 256^2, a 100-angle sinogram made by the
  fourier method that fits it, lr 5e-3 decayed per iteration, full-grid
  render), omega0 3, sigma 12, 1 output; fit_operator for ITERS
  iterations; the best PSNR and SSIM vs the clean image.

Prints one JSON line per path.  chip_smoke.py holds the port's kernel fits
to these numbers less 0.2 dB ('ct' stands for the card's 'auto', which is
fourier there).

    python tools/port_wire2d_floor.py [ITERS] [denoise|ct ...]   # 300 both
"""
import importlib
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
from wire_tpu.train.trainer import (FitConfig, fit_operator,  # noqa: E402
                                    fit_pointwise)
from wire_tpu_torch import bench  # noqa: E402
from wire_tpu_torch.apps import ct as tct  # noqa: E402
from wire_tpu_torch.bridge import params_to_numpy  # noqa: E402
from wire_tpu_torch.nn.registry import get_inr as torch_get_inr  # noqa: E402
from wire_tpu_torch.signals import coords as C  # noqa: E402
from wire_tpu_torch.train import metrics as M  # noqa: E402
from wire_tpu_torch.train.presets import get_config  # noqa: E402

JR = importlib.import_module("wire_tpu.operators.radon")

# the smoke's two WIRE-2D models (chip_smoke.py: WIRE2D_DENOISE_KW,
# WIRE2D_CT_KW)
WIDTH = dict(in_features=2, hidden_features=300, hidden_layers=2)
DENOISE_KW = dict(WIDTH, out_features=3, first_omega0=7.0,
                  hidden_omega0=7.0, scale=8.0)
CT_CONFIG = "WIRE_s12_o8_LR5e3_E2000"


def ct_kw():
    cfg = get_config(CT_CONFIG)
    return dict(WIDTH, out_features=1, first_omega0=cfg.omega0,
                hidden_omega0=cfg.omega0, scale=cfg.scale)


def models(kw):
    """wire_tpu's plain WIRE-2D and the port's seed-0 init as jax arrays."""
    init = torch_get_inr("wire2d", **kw).init(torch.Generator().manual_seed(0))
    return (get_inr("wire2d", fused="never", **kw),
            jax.tree.map(jnp.asarray, params_to_numpy(init)))


def run_denoise(iters):
    im, im_noisy, grid, _ = bench.setup(256, 256)
    H, W, _ = im.shape
    jm, params = models(DENOISE_KW)
    cfg = FitConfig(learning_rate=5e-3, niters=iters, maxpoints=H * W,
                    scale_lr_by_batch=True)
    res = fit_pointwise(jm, params, grid, im_noisy.reshape(-1, 3), cfg,
                        gt=im.reshape(-1, 3), track="gt", donate=False)
    best = np.asarray(res.best_rec).reshape(H, W, 3)
    return {"psnr_db": float(M.psnr_ref(im, best))}


def run_ct(iters):
    cfg = get_config(CT_CONFIG)
    img = tct.ct_image(None, 0)
    H, W = img.shape
    thetas = np.linspace(0, 180, 100, dtype=np.float32)
    jm, params = models(ct_kw())
    op = JR.RadonOp(jnp.asarray(thetas), method="fourier")
    sino = np.asarray(jax.jit(op)(jnp.asarray(img)))
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=iters,
                        maxpoints=cfg.maxpoints)
    res = fit_operator(jm, params, C.grid2d(H, W), sino, op, fit_cfg,
                       gt_field=img, field_shape=(H, W), track="gt",
                       donate=False)
    best = np.asarray(res.best_rec)
    return {"method": "fourier", "psnr_db": float(M.psnr_ref(img, best)),
            "ssim": float(M.ssim(img, best, data_range=1.0))}


def main():
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    paths = sys.argv[2:] or ["denoise", "ct"]
    for path in paths:
        t0 = time.time()
        out = {"denoise": run_denoise, "ct": run_ct}[path](iters)
        print(json.dumps({
            "path": path, "iters": iters, **out, "wall_s": time.time() - t0,
            "backend": jax.default_backend(),
            "maxrss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            / 1e6}), flush=True)


if __name__ == "__main__":
    main()
