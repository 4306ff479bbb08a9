"""Headline benchmark of the port: training throughput (coords/s) of the
WIRE-300 denoise fit on one GPU (the protocol of the repository's root
bench.py: 256 x 256 synthetic image, photon+readout noise, 300 hidden
features -> 212 complex, 2 hidden layers, full 65,536-coordinate batch,
Adam 5e-3 scaled by batch, 2000 epochs).

    python -m wire_tpu_torch.bench            # BENCH_EPOCHS overrides 2000

Prints ONE JSON line with the root bench's keys and one more:
  {"metric", "value" (coords/s), "unit", "vs_baseline", "ms_per_step",
   "pct_mxu_peak", "pct_3xtf32_bound", "wall_s", "psnr_db"}
ms_per_step is device time per epoch (CUDA events).  pct_mxu_peak is the
step's FLOP count (``ops.wire_step.step_flops``, the card's own count, no
padding) over ms_per_step, as a share of the H100's 67 TFLOP/s fp32 peak:
the CUDA cores' rate, kept under the root bench's key.  The step's hidden
products run on the tensor cores, each fp32 product as three TF32
products (``csrc/wire_tc.cuh``), so pct_3xtf32_bound is the share that
matters: the least time of the same work, the larger of 3 x the FLOPs at
the 495 TFLOP/s dense TF32 peak and the step's bytes at 3.35 TB/s, over
ms_per_step (chip_smoke.py's tensor_core_fields takes the same bound over
the kernels' own time).  vs_baseline divides by the root bench's
reference-PyTorch-on-CPU figure (6.31e3 coords/s; BENCH_BASELINE
overrides).  A best PSNR at or below 25 dB fails the run.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from wire_tpu_torch.device import resolve
from wire_tpu_torch.nn.registry import get_inr
from wire_tpu_torch.ops.wire_step import step_flops
from wire_tpu_torch.signals import coords as C, image as I, noise as N
from wire_tpu_torch.train import metrics as M
from wire_tpu_torch.train.trainer import FitConfig, fit_pointwise

TORCH_CPU_BASELINE_COORDS_PER_S = float(
    os.environ.get("BENCH_BASELINE", 6.31e3))
H100_FP32_TFLOPS = 67.0
H100_TF32_TFLOPS = 495.0   # dense, tensor cores
H100_HBM_TBPS = 3.35
PSNR_FLOOR_DB = 25.0


def setup(H=256, W=256):
    """(image, noisy image, coords, model) of the bench protocol."""
    im = I.synthetic_image(H, W, 3, seed=0)
    im_noisy = N.measure_np(im, noise_snr=2, tau=30.0,
                            rng=np.random.RandomState(0)).astype(np.float32)
    model = get_inr("wire", in_features=2, out_features=3,
                    hidden_features=300, hidden_layers=2, first_omega0=7.0,
                    hidden_omega0=7.0, scale=8.0)
    return im, im_noisy, C.grid2d(H, W), model


def main():
    dev = resolve("cuda")
    niters = int(os.environ.get("BENCH_EPOCHS", 2000))
    H = W = 256
    im, im_noisy, coords, model = setup(H, W)
    params = model.init(torch.Generator().manual_seed(0), dev)
    # warmup: builds the kernel and initialises the CUDA libraries
    warm = FitConfig(learning_rate=5e-3, niters=5, maxpoints=H * W,
                     scale_lr_by_batch=True)
    fit_pointwise(model, params, coords, im_noisy.reshape(-1, 3), warm,
                  gt=im.reshape(-1, 3), device=dev)
    cfg = FitConfig(learning_rate=5e-3, niters=niters, maxpoints=H * W,
                    scale_lr_by_batch=True)
    res = fit_pointwise(model, params, coords, im_noisy.reshape(-1, 3), cfg,
                        gt=im.reshape(-1, 3), device=dev)
    npoints = H * W
    ms_per_step = res.step_ms
    coords_per_s = npoints / (ms_per_step * 1e-3)
    h = params["first"]["w"].shape[1]
    gflop = step_flops(npoints, 2, h, 3, model.spec.hidden_layers) / 1e9
    pct_peak = (gflop / ms_per_step) / H100_FP32_TFLOPS
    nweights = model.num_params(params)
    mbytes = 4 * (npoints * (2 + 3 + 3) + nweights + npoints * 3
                  + nweights + 2) / 1e6
    bound_ms = max(3 * gflop / H100_TF32_TFLOPS, mbytes / (H100_HBM_TBPS
                                                          * 1e3))
    psnr = M.psnr_ref(im, res.best_rec.reshape(H, W, 3))
    print(f"device={torch.cuda.get_device_name(dev)} wall={res.wall_time_s:.2f}s "
          f"epochs={niters} psnr_vs_clean={psnr:.2f}dB", file=sys.stderr)
    if not psnr > PSNR_FLOOR_DB:
        raise SystemExit(f"bench PSNR floor violated: {psnr:.2f} dB <= "
                         f"{PSNR_FLOOR_DB}")
    print(json.dumps({
        "metric": "wire300_denoise_train_coords_per_s",
        "value": round(coords_per_s, 1),
        "unit": "coords/s",
        "vs_baseline": round(coords_per_s / TORCH_CPU_BASELINE_COORDS_PER_S,
                             2),
        "ms_per_step": round(ms_per_step, 3),
        "pct_mxu_peak": round(100.0 * pct_peak, 1),
        "pct_3xtf32_bound": round(100.0 * bound_ms / ms_per_step, 1),
        "wall_s": round(res.wall_time_s, 2),
        "psnr_db": round(psnr, 2),
    }))


if __name__ == "__main__":
    main()
