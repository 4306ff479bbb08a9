"""Image denoising driver (port of wire_tpu/apps/denoise.py:24-93): fit an
INR to a noisy image, track best-vs-clean, write the artifact set.

Loop semantics: image halved by area averaging, photon+readout noise, Adam
with LR scaled by min(1, maxpoints/npoints) and 0.1^(t/niters) decay per
epoch, best image by MSE vs the clean image.

    python -m wire_tpu_torch.apps.denoise --config_name WIRE_s8_o7_LR5e3_E2000
    python -m wire_tpu_torch.apps.denoise --config_name Bspline_s9_5_LR8e3_E4000
"""
from __future__ import annotations

import os

import numpy as np
import torch

from wire_tpu_torch.apps import common
from wire_tpu_torch.device import resolve
from wire_tpu_torch.signals import coords as C, image as I, noise as N
from wire_tpu_torch.train import artifacts as A, metrics as M
from wire_tpu_torch.train.presets import get_config
from wire_tpu_torch.train.trainer import FitConfig, fit_pointwise


def denoise_images(cfg, image=None, seed=0):
    """(im, im_noisy): the clean image (the input halved by area
    averaging) and its photon + readout noised copy, float32."""
    im = I.resize_area(common.load_image(image, seed=seed), 0.5)
    rng = np.random.RandomState(seed)
    im_noisy = N.measure_np(im, cfg.noise_snr, cfg.tau, rng=rng).astype(
        np.float32)
    return im, im_noisy


def run(config_name, *, image=None, results_dir="results", seed=0,
        device=None):
    dev = resolve(device)
    cfg = get_config(config_name)
    if cfg.tvl:
        raise NotImplementedError("TV regularization is not ported yet")
    A.log(f"Starting image denoise experiment ({config_name}) on {dev}")

    omega0 = cfg.omega0 if cfg.omega0 is not None else 7.0
    im, im_noisy = denoise_images(cfg, image, seed)
    H, W, _ = im.shape

    coords = C.grid2d(H, W)
    gt = im.reshape(-1, 3)
    gt_noisy = im_noisy.reshape(-1, 3)

    model = common.build_model(cfg, in_features=2, out_features=3,
                               omega0=omega0, sidelength=H)
    params = model.init(torch.Generator().manual_seed(seed), dev)
    nparams = model.num_params(params)
    A.log(f"Non-linearity: {cfg.nonlin}, LR: {cfg.learning_rate}, "
          f"Scale: {cfg.scale}, params: {nparams}")

    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=cfg.niters,
                        maxpoints=cfg.maxpoints, scale_lr_by_batch=True)
    res = fit_pointwise(model, params, coords, gt_noisy, fit_cfg, gt=gt,
                        device=dev)

    best_img = res.best_rec.reshape(H, W, 3)
    psnr = M.psnr_ref(im, best_img)
    A.log(f"Best PSNR for {cfg.nonlin}: {psnr}")

    task_dir = os.path.join("denoise", f"T{cfg.tau}_SNR{cfg.noise_snr}")
    mdict = {
        "Scale": cfg.scale,
        "Learning rate": np.asarray(cfg.learning_rate),
        "rec": best_img,
        "gt": im,
        "im_noisy": im_noisy,
        "mse_noisy_array": res.mse_noisy,
        "mse_array": res.mse_gt,
        "time_array": np.full_like(res.mse_gt, res.wall_time_s),
    }
    metrics = {
        "Scale": cfg.scale,
        "Scale tensor": np.asarray(cfg.scale_tensor),
        "Tau": cfg.tau,
        "Noise SNR": cfg.noise_snr,
        "Learning Rate": np.asarray(cfg.learning_rate),
        "Number of parameters": nparams,
        "Best PSNR": psnr,
    }
    path = common.write_run_artifacts(results_dir, task_dir, cfg.name,
                                      mdict, metrics)
    A.log(f"Image denoise experiment completed -> {path}")
    return {"psnr": psnr, "path": path, "result": res}


def main(argv=None):
    a = common.base_parser(__doc__).parse_args(argv)
    run(a.config_name, image=a.image, results_dir=a.results_dir, seed=a.seed,
        device=a.device)


if __name__ == "__main__":
    main()
