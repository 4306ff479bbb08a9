"""Single-image super-resolution app (port of wire_tpu/apps/sisr.py:25-106):
fit an INR whose box-downsampled render matches a low-resolution image.

Loop semantics: the image is shrunk by a third (cv2 INTER_AREA), cropped to
a multiple of the downscale, and area-downscaled to the LR image
(optionally noised); each iteration renders the full HR grid, box-averages
it by the downscale and takes the MSE against the LR image, then one Adam
step with the learning rate decaying to 0.2x over the run; the best HR
image by MSE vs the clean HR image; -10 log10(best MSE), SSIM and, for
images of 176 pixels or more a side, MS-SSIM reported.  INTER_LINEAR
upsampling of the LR image (``rec_bi``) is the bilinear baseline.

    python -m wire_tpu_torch.apps.sisr --config_name Bspline_s9_LR1e3_E2000
"""
from __future__ import annotations

import numpy as np
import torch

from wire_tpu_torch.apps import common
from wire_tpu_torch.device import resolve
from wire_tpu_torch.operators.forward import DownsampleOp
from wire_tpu_torch.signals import coords as C, image as I, noise as N
from wire_tpu_torch.train import artifacts as A, metrics as M
from wire_tpu_torch.train.presets import get_config
from wire_tpu_torch.train.trainer import FitConfig, fit_operator


def sisr_images(image=None, seed=0, scale=4, size=512):
    """(im, im_lr): the HR field (the input shrunk by a third and cropped to
    a multiple of ``scale``) and its INTER_AREA downscale, float32."""
    im = common.load_image(image, size=size, channels=3, seed=seed)
    im = I.resize_area(im, 1 / 3)
    H, W, _ = im.shape
    im = np.ascontiguousarray(im[:scale * (H // scale), :scale * (W // scale)])
    return im, I.resize_area(im, 1 / scale)


def run(config_name, *, image=None, results_dir="results", seed=0,
        device=None):
    dev = resolve(device)
    cfg = get_config(config_name)
    A.log(f"Starting SISR experiment ({config_name}) on {dev}")
    scale = cfg.down_scale or 4
    omega0 = cfg.omega0 if cfg.omega0 is not None else 8.0

    im, im_lr = sisr_images(image, seed, scale)
    H, W, _ = im.shape
    rng = np.random.RandomState(seed)
    if cfg.added_noise:
        im_lr = N.measure_np(im_lr, cfg.noise_snr, cfg.tau,
                             rng=rng).astype(np.float32)
    im_bi = I.resize_linear(im_lr, scale)

    coords = C.grid2d(H, W)
    model = common.build_model(cfg, in_features=2, out_features=3,
                               omega0=omega0, sidelength=H)
    params = model.init(torch.Generator().manual_seed(seed), dev)

    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=cfg.niters,
                        maxpoints=cfg.maxpoints, lr_decay=0.2)
    res = fit_operator(model, params, coords, im_lr, DownsampleOp(scale),
                       fit_cfg, gt_field=im, field_shape=(H, W, 3),
                       track="gt", device=dev)

    best = res.best_rec
    mse_db = M.mse_db(res.best_mse)
    ssim = float(M.ssim(im, best, data_range=1.0))
    msssim = M.ms_ssim(im, best) if min(H, W) >= 176 else None
    A.log(f"Best MSE: {mse_db}")
    A.log(f"Best SSIM: {ssim}")

    mdict = {
        "Scale": cfg.scale,
        "rec": best,
        "gt": im,
        "rec_bi": im_bi,
        "mse_array": res.mse_gt,
        "ssim_array": res.mse_gt,  # the reference stores mse under both
    }
    metrics = {
        "Scale": cfg.scale,
        "Scale Tensor": np.asarray(cfg.scale_tensor),
        "Downscale": scale,
        "Learning rate": np.asarray(cfg.learning_rate),
        "Best MSE": mse_db,
        "Best SSIM": ssim,
    }
    path = common.write_run_artifacts(results_dir, f"sisr/DS_{scale}",
                                      cfg.name, mdict, metrics)
    A.log(f"Finished SISR experiment -> {path}")
    return {"mse_db": mse_db, "ssim": ssim, "ms_ssim": msssim, "path": path,
            "result": res}


def main(argv=None):
    a = common.base_parser(__doc__).parse_args(argv)
    run(a.config_name, image=a.image, results_dir=a.results_dir, seed=a.seed,
        device=a.device)


if __name__ == "__main__":
    main()
