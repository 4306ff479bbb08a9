#!/usr/bin/env python
"""PSNR floors of chip_smoke.py's MFN fits, from the JAX reference.

Runs wire_tpu on the CPU (fused="never", float32) from the PyTorch port's
seed-0 init (the sweep's ``_build("mfn", ...)`` model, ``torch.Generator()
.manual_seed(0)``) moved across with wire_tpu_torch.bridge, through the
problems the port's sweep app builds:

- denoise: the 512^2 procedural image area-halved to 256^2 and noised with
  measure_np(snr 2, tau 30, RandomState(0)) (wire_tpu_torch/apps/sweep.py:
  denoise_images); MFN 300 wide, 2 hidden layers, lr 5e-2 scaled by batch,
  65,536 coordinates in one full batch, fit_pointwise for ITERS epochs (the
  LR decay over ITERS); the best PSNR vs the clean image;
- sisr: the 768^2 image shrunk by a third to 256^2 (cv2 INTER_AREA) and
  area-downscaled x4 to 64^2 (wire_tpu_torch/apps/sisr.py:sisr_images);
  MFN 256 wide, lr 5e-2 decaying to 0.2x, fit_operator through the x4 box
  downsample for ITERS iterations; the best -10 log10(MSE) vs the clean HR
  image.

Prints one JSON line per path.  chip_smoke.py holds the port's kernel fits
to these numbers less 0.2 dB.

    python tools/port_mfn_floor.py [ITERS] [denoise|sisr ...]   # 300 both
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
from wire_tpu_torch.apps import sisr, sweep  # noqa: E402
from wire_tpu_torch.bridge import params_to_numpy  # noqa: E402
from wire_tpu_torch.signals import coords as C  # noqa: E402
from wire_tpu_torch.train import metrics as M  # noqa: E402

SPEC_FIELDS = ("in_features", "out_features", "hidden_features",
               "hidden_layers")


def models(task, H, W):
    """The port's sweep model and wire_tpu's plain twin of it."""
    port = sweep._build("mfn", task, H, W, 3e1 if task == "denoise" else 1e2)
    jm = get_inr("mfn", fused="never",
                 **{f: getattr(port.spec, f) for f in SPEC_FIELDS})
    init = port.init(torch.Generator().manual_seed(0))
    return jm, jax.tree.map(jnp.asarray, params_to_numpy(init))


def run_denoise(iters):
    im, im_noisy = sweep.denoise_images()
    H, W, _ = im.shape
    jm, params = models("denoise", H, W)
    cfg = FitConfig(learning_rate=sweep._DENOISE_LR["mfn"], niters=iters,
                    maxpoints=256 * 256, scale_lr_by_batch=True)
    res = fit_pointwise(jm, params, C.grid2d(H, W), im_noisy.reshape(-1, 3),
                        cfg, gt=im.reshape(-1, 3), track="gt", donate=False)
    best = np.asarray(res.best_rec).reshape(H, W, 3)
    return {"psnr_db": float(M.psnr_ref(im, best))}


def run_sisr(iters):
    im, im_lr = sisr.sisr_images(None, 0, 4, size=768)
    H, W, _ = im.shape
    jm, params = models("sisr", H, W)
    cfg = FitConfig(learning_rate=sweep._SISR_LR["mfn"], niters=iters,
                    lr_decay=0.2)
    res = fit_operator(jm, params, C.grid2d(H, W), im_lr, DownsampleOp(4),
                       cfg, gt_field=im, field_shape=(H, W, 3), track="gt",
                       donate=False)
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
