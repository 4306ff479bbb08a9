"""Task 'pointwise_many': one batched seed sweep of the sweep app
(``apps/sweep.py:sweep_denoise_seeds``): its inputs from the fit's seed
(``denoise_images``), the family's model (``_build`` at the
configuration's widths), the replicas' split inits (``seed_inits``),
``fit_pointwise_many`` with the sweep's settings, then each replica's
PSNR.  One ``step_grads_many`` call an epoch serves every replica: on the
card one ``wire_step`` launch sequence with the replica axis."""
from __future__ import annotations

import inspect

import torch

from wire_tpu_torch.apps import sweep
from wire_tpu_torch.signals import coords as C
from wire_tpu_torch.train import metrics as M
from wire_tpu_torch.train.trainer import FitConfig, fit_pointwise_many

from benchmark import lookup, taskkit
from benchmark.reference import signals as RS

STEP_KERNEL = {"wire": "wire_step"}


class Context:
    def __init__(self, config, traffic, dev):
        self.config, self.traffic, self.dev = config, traffic, dev
        self.out_features = traffic["channels"]
        self.rows = traffic["rows"]
        self.replicas = traffic["replicas"]
        counts = lookup.module("counts", config["family"])
        flops, nbytes = counts.step(config, self.rows, self.out_features,
                                    self.replicas)
        self.work = [(STEP_KERNEL[config["family"]], flops, nbytes,
                      counts.ENGINE)]
        self.model_flops = self.replicas * counts.model_flops(
            config, self.rows, self.out_features)
        self.kernels = (STEP_KERNEL[config["family"]],)
        self.defaults = {k: v.default for k, v in inspect.signature(
            sweep.sweep_denoise_seeds).parameters.items()}
        for key, name in (("tau", "tau"), ("noise_snr", "noise_snr"),
                          ("downscale", "downscale")):
            taskkit.same(key, self.defaults[name], traffic[key])


def fit(ctx, seed, probe, niters=None):
    family, M_ = ctx.config["family"], ctx.replicas
    probe.begin(seed)
    d = ctx.defaults
    im, im_noisy = sweep.denoise_images(None, seed, d["tau"], d["noise_snr"],
                                        d["size"], d["downscale"])
    H, W, _ = im.shape
    taskkit.same("rows", H * W, ctx.traffic["rows"])
    model = sweep._build(family, "denoise", H, W, d["tau"],
                         hidden_features=ctx.config["hidden_features"],
                         hidden_layers=ctx.config["hidden_layers"])
    taskkit.check_model(model, ctx.config, ctx.traffic)
    probe.wrap_step(model, "step_grads_many")
    cfg = FitConfig(
        learning_rate=sweep._seeds_lr(sweep._DENOISE_LR, family, None),
        niters=niters or d["niters"], maxpoints=256 * 256,
        scale_lr_by_batch=True, seed=seed)
    taskkit.check_fit(cfg, ctx.traffic, niters)
    res = fit_pointwise_many(model, sweep.seed_inits(model, M_, seed, ctx.dev),
                             C.grid2d(H, W), im_noisy.reshape(-1, 3), cfg,
                             gt=im.reshape(-1, 3), track="gt", device=ctx.dev)
    probe.loop_done()
    psnrs = [float(M.psnr_ref(im, res.best_rec[r].reshape(H, W, 3)))
             for r in range(M_)]
    return probe.end(rows=H * W, epochs=cfg.niters, replicas=M_,
                     losses=res.mse_noisy[:3], best_mse=res.best_mse,
                     hist_min=res.mse_gt.min(axis=0), best_rec=res.best_rec,
                     psnr=psnrs)


def reference(ctx, seed, mm, fault=None):
    """One {losses, p0, g0, p3, gt} a replica: replica r from the r-th
    child seed that a generator seeded ``seed`` draws in [0, 2**62)."""
    im, im_noisy = RS.denoise_images(seed, ctx.traffic)
    H, W, c = im.shape
    coords = torch.from_numpy(RS.grid2d(H, W)).to(ctx.dev)
    target = torch.from_numpy(im_noisy.reshape(-1, c)).to(ctx.dev)
    n = taskkit.rows_half(H * W, fault)

    def loss_of(pred):
        err = pred[:n] - target[:n]
        return torch.sum(err * err) / (n * c)

    gen = torch.Generator().manual_seed(int(seed))
    children = torch.randint(0, 2 ** 62, (ctx.replicas,),
                             generator=gen).tolist()
    outs = []
    for child in children:
        out = taskkit.reference_steps(
            ctx, mm, torch.Generator().manual_seed(child), coords, loss_of)
        out["gt"] = im.reshape(-1, c)
        outs.append(out)
    return outs


