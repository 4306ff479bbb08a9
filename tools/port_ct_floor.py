#!/usr/bin/env python
"""PSNR floors of chip_smoke.py's CT fits, from the JAX reference.

Runs wire_tpu's fit_operator on the CPU (fused="never", float32) with the
CT protocol of wire_tpu_torch/apps/ct.py: the 256 x 256 one-channel
procedural image, a 100-angle sinogram made by the method that fits it,
WIRE with 300 hidden features (212 complex units), omega0 = 3, scale 12,
lr 5e-3 decayed per iteration, full-grid render, best image by MSE vs the
clean image; from the PyTorch port's seed-0 init moved across with
wire_tpu_torch.bridge.  Prints one JSON line per Radon method with the
best PSNR and SSIM.  chip_smoke.py holds the port's kernel fits to these
PSNRs less 0.2 dB.

    python tools/port_ct_floor.py [ITERS] [METHOD ...]   # 300 fourier rotate

'fourier' runs the JAX package's XLA line sampler (the CPU's), 'rotate'
its XLA gather path (rotate_xla).
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
from wire_tpu.train.trainer import FitConfig, fit_operator  # noqa: E402
from wire_tpu_torch.apps import ct as tct  # noqa: E402
from wire_tpu_torch.bridge import params_to_numpy  # noqa: E402
from wire_tpu_torch.signals import coords as C  # noqa: E402
from wire_tpu_torch.train import metrics as M  # noqa: E402
from wire_tpu_torch.train.presets import get_config  # noqa: E402

JR = importlib.import_module("wire_tpu.operators.radon")

CONFIG = "WIRE_s12_o8_LR5e3_E2000"


def main():
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    methods = sys.argv[2:] or ["fourier", "rotate"]
    cfg = get_config(CONFIG)
    img = tct.ct_image(None, 0)
    H, W = img.shape
    thetas = np.linspace(0, 180, 100, dtype=np.float32)
    init = tct.build_ct_model(cfg, cfg.omega0).init(
        torch.Generator().manual_seed(0))
    params = jax.tree.map(jnp.asarray, params_to_numpy(init))
    model = get_inr("wire", fused="never", in_features=2, out_features=1,
                    hidden_features=300, hidden_layers=2,
                    first_omega0=cfg.omega0, hidden_omega0=cfg.omega0,
                    scale=cfg.scale)
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=iters,
                        maxpoints=cfg.maxpoints)
    for method in methods:
        op = JR.RadonOp(jnp.asarray(thetas), method=method)
        sino = np.asarray(jax.jit(op)(jnp.asarray(img)))
        t0 = time.time()
        res = fit_operator(model, params, C.grid2d(H, W), sino, op, fit_cfg,
                           gt_field=img, field_shape=(H, W), track="gt",
                           donate=False)
        best = np.asarray(res.best_rec)
        print(json.dumps({
            "method": method, "iters": iters,
            "psnr_db": float(M.psnr_ref(img, best)),
            "ssim": float(M.ssim(img, best, data_range=1.0)),
            "best_mse": res.best_mse, "wall_s": time.time() - t0,
            "backend": jax.default_backend(),
            "maxrss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            / 1e6}), flush=True)


if __name__ == "__main__":
    main()
