#!/usr/bin/env python
"""IoU floor of chip_smoke.py's occupancy fit, from the JAX reference.

Runs wire_tpu's fit_pointwise on the CPU (fused="never", float32) with the
occupancy app's configuration as wire_tpu_torch/apps/occupancy.py builds
it (the 64^3 synthetic volume, WIRE 300 wide = 212 complex units, 3 hidden
layers, omega0 20, sigma 10, lr 5e-3 decaying to 0.2x, chunks of 200,000
points: two chunks an epoch, the implicit GridSpec grid, best by the
training loss, the per-epoch IoU at 0.5) from the PyTorch port's seed-0
init moved across with wire_tpu_torch.bridge.  wire_tpu draws its own
permutations (jax.random), so its trajectory is not the port's: the floor
is a level, and chip_smoke.py holds the port's kernel fit to it less a
stated margin.  Prints one JSON line per run: the best IoU and PSNR as the
app computes them from the best reconstruction, and the per-epoch IoU
history's maximum and last value.

    python tools/port_occupancy_floor.py [EPOCHS] [BLOCK_PERM ...]
    # default: 200 epochs, per point (block_perm 0)

About 11 s an epoch and 4 GB on 8 CPU cores.
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

from wire_tpu.nn import get_inr  # noqa: E402
from wire_tpu.signals import coords as C  # noqa: E402
from wire_tpu.train import metrics as M  # noqa: E402
from wire_tpu.train.trainer import FitConfig, fit_pointwise  # noqa: E402
from wire_tpu_torch.apps import occupancy as O  # noqa: E402
from wire_tpu_torch.bridge import params_to_numpy  # noqa: E402


def run(epochs, block_perm):
    im, grid, target, tmodel, tcfg = O.setup(niters=epochs,
                                             block_perm=block_perm)
    H, W, T = im.shape
    s = tmodel.spec
    model = get_inr("wire", fused="never", in_features=3, out_features=1,
                    hidden_features=s.hidden_features,
                    hidden_layers=s.hidden_layers,
                    first_omega0=s.first_omega0,
                    hidden_omega0=s.hidden_omega0, scale=s.scale)
    init = tmodel.init(torch.Generator().manual_seed(0))
    params = jax.tree.map(jax.numpy.asarray, params_to_numpy(init))
    cfg = FitConfig(learning_rate=tcfg.learning_rate, niters=epochs,
                    maxpoints=tcfg.maxpoints, lr_decay=tcfg.lr_decay,
                    seed=tcfg.seed, block_perm=block_perm)
    t0 = time.time()
    res = fit_pointwise(model, params, C.GridSpec(H, W, T), target, cfg,
                        track="noisy", donate=False,
                        epoch_metric=lambda rec, tgt: M.iou(rec, tgt, 0.5))
    iou, psnr = O.best_metrics(im, np.asarray(res.best_rec).reshape(H, W, T))
    hist = np.asarray(res.time_array)
    return {"epochs": epochs, "block_perm": block_perm, "best_iou": iou,
            "psnr_db": psnr, "max_epoch_iou": float(hist.max()),
            "last_epoch_iou": float(hist[-1]),
            "best_mse": float(res.best_mse), "wall_s": time.time() - t0}


def main():
    epochs = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    for block_perm in [int(b) for b in sys.argv[2:]] or [0]:
        out = run(epochs, block_perm)
        print(json.dumps({
            **out, "backend": jax.default_backend(),
            "maxrss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            / 1e6}), flush=True)


if __name__ == "__main__":
    main()
