"""Task 'pointwise': one fit of the denoise app (``apps/denoise.py:run``
without its artifacts): the app's inputs from the fit's seed
(``denoise_images``), its model (``common.build_model`` at the
configuration's widths, ``model.init``), ``fit_pointwise`` with the
preset's settings, then the app's PSNR of the best reconstruction.  One
``step_grads`` call an epoch (full batch), on the card one ``wire_step``
or ``real_step`` launch sequence."""
from __future__ import annotations

import numpy as np
import torch

from wire_tpu_torch.apps import common, denoise
from wire_tpu_torch.signals import coords as C
from wire_tpu_torch.train import metrics as M
from wire_tpu_torch.train.presets import get_config
from wire_tpu_torch.train.trainer import FitConfig, fit_pointwise

from benchmark import lookup, taskkit
from benchmark.reference import signals as RS

STEP_KERNEL = {"wire": "wire_step", "bspline_form": "real_step"}


class Context:
    def __init__(self, config, traffic, dev):
        self.config, self.traffic, self.dev = config, traffic, dev
        self.preset = get_config(traffic["preset"])
        for key, name in (("tau", "tau"),
                          ("noise_snr", "noise_snr"),
                          ("learning_rate", "learning_rate")):
            taskkit.same(key, getattr(self.preset, name), traffic[key])
        self.out_features = traffic["channels"]
        self.rows = traffic["rows"]
        self.replicas = 1
        counts = lookup.module("counts", config["family"])
        flops, nbytes = counts.step(config, self.rows, self.out_features)
        self.work = [(STEP_KERNEL[config["family"]], flops, nbytes,
                      counts.ENGINE)]
        self.model_flops = counts.model_flops(config, self.rows,
                                              self.out_features)
        self.kernels = (STEP_KERNEL[config["family"]],)


def fit(ctx, seed, probe, niters=None):
    cfg = ctx.preset
    probe.begin(seed)
    omega0 = cfg.omega0 if cfg.omega0 is not None else 7.0
    im, im_noisy = denoise.denoise_images(cfg, None, seed)
    H, W, _ = im.shape
    taskkit.same("rows", H * W, ctx.traffic["rows"])
    model = common.build_model(
        cfg, in_features=2, out_features=3, omega0=omega0, sidelength=H,
        hidden_features=ctx.config["hidden_features"],
        hidden_layers=ctx.config["hidden_layers"])
    taskkit.check_model(model, ctx.config, ctx.traffic)
    probe.wrap_step(model, "step_grads")
    params = model.init(torch.Generator().manual_seed(seed), ctx.dev)
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate,
                        niters=niters or cfg.niters, maxpoints=cfg.maxpoints,
                        scale_lr_by_batch=True, seed=seed)
    taskkit.check_fit(fit_cfg, ctx.traffic, niters)
    res = fit_pointwise(model, params, C.grid2d(H, W),
                        im_noisy.reshape(-1, 3), fit_cfg, gt=im.reshape(-1, 3),
                        tv_weight=cfg.lambda_tv if cfg.tvl else 0.0,
                        image_shape=(H, W, 3), device=ctx.dev)
    probe.loop_done()
    psnr = M.psnr_ref(im, res.best_rec.reshape(H, W, 3))
    return probe.end(rows=H * W, epochs=fit_cfg.niters, replicas=1,
                     losses=res.mse_noisy[:3, None],
                     best_mse=np.array([res.best_mse]),
                     hist_min=np.array([res.mse_gt.min()]),
                     best_rec=res.best_rec[None], psnr=[psnr])


def reference(ctx, seed, mm, fault=None):
    """[{losses, p0, g0, p3, gt}]: the reference's first three steps of the
    fit at ``seed`` and its clean image (rows, 3)."""
    im, im_noisy = RS.denoise_images(seed, ctx.traffic)
    H, W, c = im.shape
    coords = torch.from_numpy(RS.grid2d(H, W)).to(ctx.dev)
    target = torch.from_numpy(im_noisy.reshape(-1, c)).to(ctx.dev)
    n = taskkit.rows_half(H * W, fault)

    def loss_of(pred):
        err = pred[:n] - target[:n]
        return torch.sum(err * err) / (n * c)

    out = taskkit.reference_steps(ctx, mm, torch.Generator().manual_seed(seed),
                                  coords, loss_of)
    out["gt"] = im.reshape(-1, c)
    return [out]
