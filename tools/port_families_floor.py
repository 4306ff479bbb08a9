#!/usr/bin/env python
"""PSNR floors of chip_smoke.py's fit_families phase, from the JAX
reference.

Runs wire_tpu on the CPU (fused="never", float32) from the PyTorch port's
seed-0 init moved across with wire_tpu_torch.bridge, through the denoise
problem as wire_tpu_torch/apps/denoise.py builds it (the 512^2 procedural
image halved to 256^2 and noised, 65,536 coordinates, full batch, lr
scaled by batch, decaying to 0.1x) for each of the three multiscale
families with a step hook, at the multiscale presets' shape
MscaleHL_s1_ST2_SHF256 (scale 1, scale_tensor (1, 2), 256 scaled hidden
features, 256 wide, lr 0.02) with the family swapped in, as the port's
build_model wires it: bspline_mscale_1 (first 2 -> 256 at both scales,
512 wide raw, then 512 -> 256 -> 3), bspline_mscale_1_new and
bspline_mscale_repIN (the coordinates tiled to 2 x 2 x 256 = 1,024 inputs,
1,024 -> 256 -> 256 -> 256 -> 3).  Prints one JSON line per family with
the best PSNR vs the clean image; chip_smoke.py holds the port's kernel
fits to these numbers less 0.2 dB.

    python tools/port_families_floor.py [EPOCHS] [FAMILY ...]   # 300, all

About 2 s an epoch for _1_new and repIN, 1 s for mscale_1, on 8 CPU cores.
"""
import dataclasses
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from wire_tpu.nn import get_inr  # noqa: E402
from wire_tpu.train.trainer import FitConfig, fit_pointwise  # noqa: E402
from wire_tpu_torch.apps import common, denoise  # noqa: E402
from wire_tpu_torch.bridge import params_to_numpy  # noqa: E402
from wire_tpu_torch.signals import coords as C  # noqa: E402
from wire_tpu_torch.train import metrics as M  # noqa: E402
from wire_tpu_torch.train.presets import get_config  # noqa: E402

PRESET = "MscaleHL_s1_ST2_SHF256"
FAMILIES = ("bspline_mscale_1", "bspline_mscale_1_new",
            "bspline_mscale_repIN")
SPEC_FIELDS = ("in_features", "out_features", "hidden_features",
               "hidden_layers", "scaled_hidden_features", "first_omega0",
               "hidden_omega0", "scale", "scale_tensor")


def family_config(nonlin):
    return dataclasses.replace(get_config(PRESET), nonlin=nonlin)


def run(nonlin, iters):
    cfg = family_config(nonlin)
    im, im_noisy = denoise.denoise_images(cfg)
    H, W, _ = im.shape
    tmodel = common.build_model(cfg, in_features=2, out_features=3,
                                omega0=7.0, sidelength=H)
    model = get_inr(nonlin, fused="never",
                    **{f: getattr(tmodel.spec, f) for f in SPEC_FIELDS})
    init = tmodel.init(torch.Generator().manual_seed(0))
    params = jax.tree.map(jax.numpy.asarray, params_to_numpy(init))
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=iters,
                        maxpoints=cfg.maxpoints, scale_lr_by_batch=True)
    res = fit_pointwise(model, params, C.grid2d(H, W),
                        im_noisy.reshape(-1, 3), fit_cfg,
                        gt=im.reshape(-1, 3), track="gt", donate=False)
    best = np.asarray(res.best_rec).reshape(H, W, 3)
    return {"psnr_db": float(M.psnr_ref(im, best)),
            "in_features": tmodel.spec.in_features}


def main():
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    for nonlin in sys.argv[2:] or FAMILIES:
        t0 = time.time()
        out = run(nonlin, iters)
        print(json.dumps({
            "family": nonlin, "iters": iters, **out,
            "wall_s": time.time() - t0, "backend": jax.default_backend(),
            "maxrss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            / 1e6}), flush=True)


if __name__ == "__main__":
    main()
