"""Task 'operator': one fit of the CT app (``apps/ct.py:run`` without its
artifacts): the app's field from the fit's seed (``ct_image``), its
sinogram through the traffic's Radon method (``make_sinogram``), its
model (``build_ct_model``'s call, ``common.build_model`` at the
configuration's widths, ``model.init``), ``fit_operator`` through a
``RadonOp``, then the app's PSNR and SSIM of the best field.  Each
iteration renders the whole grid through the ``wire_mlp`` pair on the
card and applies the operator (the fourier method: FFTs and
``line_sample``'s gather, the scatter in the backward)."""
from __future__ import annotations

import numpy as np
import torch

from wire_tpu_torch.apps import common, ct
from wire_tpu_torch.operators.radon import RadonOp
from wire_tpu_torch.signals import coords as C
from wire_tpu_torch.train import metrics as M
from wire_tpu_torch.train.presets import get_config
from wire_tpu_torch.train.trainer import FitConfig, fit_operator

from benchmark import lookup, taskkit
from benchmark.reference import signals as RS

PAIR_KERNEL = {"wire": "wire_mlp"}


class Context:
    def __init__(self, config, traffic, dev):
        self.config, self.traffic, self.dev = config, traffic, dev
        self.preset = get_config(traffic["preset"])
        taskkit.same("learning_rate", self.preset.learning_rate,
                     traffic["learning_rate"])
        self.out_features = 1
        self.rows = traffic["rows"]
        self.replicas = 1
        self.thetas = np.linspace(0, 180, traffic["angles"], dtype=np.float32)
        side = int(round(self.rows ** 0.5))
        counts = lookup.module("counts", config["family"])
        op_counts = lookup.module("counts", traffic["operator"])
        flops, nbytes = counts.pair(config, self.rows, 1)
        op_flops, op_bytes = op_counts.iteration(traffic, (side, side))
        self.work = [(PAIR_KERNEL[config["family"]], flops, nbytes,
                      counts.ENGINE),
                     (traffic["operator"], op_flops, op_bytes,
                      op_counts.ENGINE)]
        self.model_flops = counts.model_flops(config, self.rows, 1)
        self.kernels = (PAIR_KERNEL[config["family"]], "line_sample")


def fit(ctx, seed, probe, niters=None):
    cfg = ctx.preset
    tr = ctx.traffic
    probe.begin(seed)
    omega0 = cfg.omega0 if cfg.omega0 is not None else 3.0
    img = ct.ct_image(None, seed)
    H, W = img.shape
    taskkit.same("rows", H * W, tr["rows"])
    sinogram = ct.make_sinogram(img, ctx.thetas,
                                radon_method=tr["radon_method"],
                                device=ctx.dev)
    if cfg.added_noise:
        raise RuntimeError("the cell's preset adds sensor noise; the "
                           "reference has none")
    model = common.build_model(cfg, in_features=2, out_features=1,
                               omega0=omega0,
                               hidden_features=ctx.config["hidden_features"],
                               hidden_layers=ctx.config["hidden_layers"])
    taskkit.check_model(model, ctx.config, tr)
    probe.wrap_apply(model)
    params = model.init(torch.Generator().manual_seed(seed), ctx.dev)
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate,
                        niters=niters or cfg.niters, maxpoints=cfg.maxpoints,
                        seed=seed)
    taskkit.check_fit(fit_cfg, tr, niters)
    op = RadonOp(ctx.thetas, method=tr["radon_method"])
    res = fit_operator(model, params, C.grid2d(H, W), sinogram, op, fit_cfg,
                       gt_field=img, field_shape=(H, W), track="gt",
                       device=ctx.dev)
    probe.loop_done()
    psnr = float(M.psnr_ref(img, res.best_rec))
    ssim = float(M.ssim(img, res.best_rec, data_range=1.0))
    return probe.end(rows=H * W, epochs=fit_cfg.niters, replicas=1,
                     losses=res.mse_noisy[:3, None],
                     best_mse=np.array([res.best_mse]),
                     hist_min=np.array([res.mse_gt.min()]),
                     best_rec=res.best_rec.reshape(1, -1, 1), psnr=[psnr],
                     ssim=[ssim])


def reference(ctx, seed, mm, fault=None):
    """[{losses, p0, g0, p3, gt}]: the reference's first three iterations
    of the fit at ``seed`` (its own field, sinogram and Radon operator) and
    its clean field (rows, 1)."""
    radon = lookup.module("reference", ctx.traffic["operator"]).radon
    img = RS.ct_image(seed, ctx.traffic)
    H, W = img.shape
    field = torch.from_numpy(img).to(ctx.dev)
    with torch.no_grad():
        sino = radon(field, ctx.thetas)
    coords = torch.from_numpy(RS.grid2d(H, W)).to(ctx.dev)
    a = taskkit.rows_half(sino.shape[0], fault)

    def loss_of(pred):
        est = radon(pred.reshape(H, W), ctx.thetas)
        return torch.mean((est[:a] - sino[:a]) ** 2)

    out = taskkit.reference_steps(ctx, mm, torch.Generator().manual_seed(seed),
                                  coords, loss_of)
    out["gt"] = img.reshape(-1, 1)
    return [out]
