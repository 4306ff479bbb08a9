#!/usr/bin/env python3
"""Where the time of the port's fits goes, on one GPU.

Profiles EPOCHS epochs of wire_tpu_torch's fit_pointwise at the denoise
bench protocol (256 x 256, 65,536 coordinates, WIRE-300, full batch), or
with ``--ct METHOD`` EPOCHS iterations of fit_operator at the CT protocol
(256 x 256 field, 100 angles, WIRE-300 at omega0 = 3, scale 12; METHOD
'auto' = fourier on the card, or 'rotate'), or with ``--real denoise`` the
B-spline denoise fit (preset Bspline_s9_5_LR8e3_E4000, 65,536 coordinates)
and ``--real sisr`` the B-spline SISR fit (preset Bspline_s9_LR1e3_E2000,
168 x 168 HR, x4 box downsample), or with ``--mscale2`` the mscale_2
denoise fit (preset Mscale2_ST8_3_LR8e3_E4000, scales 1/9, 4, 8, 65,536
coordinates), or with ``--mfn`` the sweep app's MFN denoise fit (300 wide,
2 hidden layers, lr 5e-2, 65,536 coordinates) and ``--mfn sisr`` its MFN
SISR fit (256 wide, 256 x 256 HR, x4 box downsample), or with
``--wire2d`` the WIRE-2D denoise fit (300 wide, omega0 7, sigma 8, the
bench protocol) and ``--wire2d ct`` the WIRE-2D CT fit (omega0 3, sigma 12,
the CT protocol, 'auto' = fourier), with torch.profiler after a warm-up
fit,
and prints one JSON line: device time per epoch by kernel
(sorted, summed over launches; device-side events only, so a kernel is not
counted again under the operator or autograd Function that launched it),
the device's busy time per epoch, the wall time per epoch and the device's
idle share (1 - busy / wall).
Kernels of csrc/*.cu keep their CUDA names (tc_paired_kernel<0|1|2, ...>
= forward / hidden backward / first-layer backward GEMMs of wire_step and
wire_mlp on the tensor cores, and tc_wgrad_kernel, narrow_wgrad_kernel and
narrow_colsum_kernel their, WIRE-2D's, mscale_2's and the MFN's weight gradients;
wgrad_partial_kernel,
reduce_chunks_kernel, final_loss_kernel or
final_forward_kernel, first_forward_kernel, dcoords_kernel,
rotsum_*_kernel, line_*_kernel, real_gemm_kernel<0|1|2> = forward /
backward / dcoords GEMMs of the real families, colsum_partial_kernel,
real_tc_kernel<0|1, ...> = forward / data-gradient GEMMs of mscale_2's
trunk on the tensor cores, real_narrow_kernel<0|1> its first-layer
forward and top data gradient, combiner_kernel of mscale_2,
filter_forward_kernel,
mfn_tc_kernel<0|1|2, ...> = link forward / link backward / last data
gradient on the tensor cores, mfn_narrow_kernel<1> the link backward from
the final layer (K = o), filter_grad_partial_kernel and
filter_grad_finish_kernel of the MFN, gabor2d_first_kernel, gabor2d_tc_fwd_kernel,
gabor2d_tc_bwd_kernel<0|1> = hidden / first-layer data gradients on the
tensor cores and gabor2d_dcoords_kernel of WIRE-2D); the rest are PyTorch's (weight stacking, FFTs, Adam, best
tracking).

    python3 tools/port_step_profile.py [EPOCHS] [--ct auto|rotate |
                                        --real denoise|sisr | --mscale2 |
                                        --mfn [sisr] | --wire2d [ct]]
                                        # default 20, denoise
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import numpy as np  # noqa: E402

from wire_tpu_torch import bench  # noqa: E402
from wire_tpu_torch.apps import common  # noqa: E402
from wire_tpu_torch.apps import ct as tct  # noqa: E402
from wire_tpu_torch.apps import denoise, sisr  # noqa: E402
from wire_tpu_torch.operators.forward import DownsampleOp  # noqa: E402
from wire_tpu_torch.device import resolve  # noqa: E402
from wire_tpu_torch.nn.registry import get_inr  # noqa: E402
from wire_tpu_torch.operators.radon import RadonOp  # noqa: E402
from wire_tpu_torch.signals import coords as C  # noqa: E402
from wire_tpu_torch.train.presets import get_config  # noqa: E402
from wire_tpu_torch.train.trainer import (FitConfig, fit_operator,  # noqa
                                          fit_pointwise)


def denoise_fit(epochs, dev):
    im, im_noisy, grid, model = bench.setup(256, 256)
    params = model.init(torch.Generator().manual_seed(0), dev)
    target, gt = im_noisy.reshape(-1, 3), im.reshape(-1, 3)
    cfg = FitConfig(learning_rate=5e-3, niters=epochs, maxpoints=256 * 256,
                    scale_lr_by_batch=True)
    return lambda: fit_pointwise(model, params, grid, target, cfg, gt=gt,
                                 device=dev)


def ct_fit(iters, method, dev):
    cfg = get_config("WIRE_s12_o8_LR5e3_E2000")
    img = tct.ct_image(None, 0)
    thetas = np.linspace(0, 180, 100, dtype=np.float32)
    sino = tct.make_sinogram(img, thetas, radon_method=method, device=dev)
    model = tct.build_ct_model(cfg, cfg.omega0)
    params = model.init(torch.Generator().manual_seed(0), dev)
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=iters,
                        maxpoints=cfg.maxpoints)
    op = RadonOp(thetas, method=method)
    return lambda: fit_operator(model, params, C.grid2d(*img.shape), sino,
                                op, fit_cfg, gt_field=img,
                                field_shape=img.shape, device=dev)


def real_fit(iters, path, dev):
    if path in ("denoise", "mscale2"):
        cfg = get_config("Bspline_s9_5_LR8e3_E4000" if path == "denoise"
                         else "Mscale2_ST8_3_LR8e3_E4000")
        im, im_noisy = denoise.denoise_images(cfg)
        H, W, _ = im.shape
        model = common.build_model(cfg, in_features=2, out_features=3,
                                   omega0=7.0, sidelength=H)
        params = model.init(torch.Generator().manual_seed(0), dev)
        fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=iters,
                            maxpoints=cfg.maxpoints, scale_lr_by_batch=True)
        return lambda: fit_pointwise(model, params, C.grid2d(H, W),
                                     im_noisy.reshape(-1, 3), fit_cfg,
                                     gt=im.reshape(-1, 3), device=dev)
    cfg = get_config("Bspline_s9_LR1e3_E2000")
    im, im_lr = sisr.sisr_images(None, 0, cfg.down_scale)
    H, W, _ = im.shape
    model = common.build_model(cfg, in_features=2, out_features=3,
                               omega0=8.0, sidelength=H)
    params = model.init(torch.Generator().manual_seed(0), dev)
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=iters,
                        maxpoints=cfg.maxpoints, lr_decay=0.2)
    return lambda: fit_operator(model, params, C.grid2d(H, W), im_lr,
                                DownsampleOp(cfg.down_scale), fit_cfg,
                                gt_field=im, field_shape=(H, W, 3),
                                device=dev)


def mfn_fit(epochs, path, dev):
    from wire_tpu_torch.apps import sweep
    if path == "sisr":
        im, im_lr = sisr.sisr_images(None, 0, 4, size=768)
        H, W, _ = im.shape
        model = sweep._build("mfn", "sisr", H, W, 1e2)
        params = model.init(torch.Generator().manual_seed(0), dev)
        fit_cfg = FitConfig(learning_rate=sweep._SISR_LR["mfn"],
                            niters=epochs, lr_decay=0.2)
        return lambda: fit_operator(model, params, C.grid2d(H, W), im_lr,
                                    DownsampleOp(4), fit_cfg, gt_field=im,
                                    field_shape=(H, W, 3), device=dev)
    im, im_noisy = sweep.denoise_images()
    H, W, _ = im.shape
    model = sweep._build("mfn", "denoise", H, W, 3e1)
    params = model.init(torch.Generator().manual_seed(0), dev)
    fit_cfg = FitConfig(learning_rate=sweep._DENOISE_LR["mfn"], niters=epochs,
                        maxpoints=256 * 256, scale_lr_by_batch=True)
    return lambda: fit_pointwise(model, params, C.grid2d(H, W),
                                 im_noisy.reshape(-1, 3), fit_cfg,
                                 gt=im.reshape(-1, 3), device=dev)


def wire2d_fit(epochs, path, dev):
    width = dict(in_features=2, hidden_features=300, hidden_layers=2)
    if path == "ct":
        cfg = get_config("WIRE_s12_o8_LR5e3_E2000")
        img = tct.ct_image(None, 0)
        thetas = np.linspace(0, 180, 100, dtype=np.float32)
        sino = tct.make_sinogram(img, thetas, device=dev)
        model = get_inr("wire2d", out_features=1, first_omega0=cfg.omega0,
                        hidden_omega0=cfg.omega0, scale=cfg.scale, **width)
        params = model.init(torch.Generator().manual_seed(0), dev)
        fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=epochs,
                            maxpoints=cfg.maxpoints)
        return lambda: fit_operator(model, params, C.grid2d(*img.shape),
                                    sino, RadonOp(thetas), fit_cfg,
                                    gt_field=img, field_shape=img.shape,
                                    device=dev)
    im, im_noisy, grid, _ = bench.setup(256, 256)
    model = get_inr("wire2d", out_features=3, first_omega0=7.0,
                    hidden_omega0=7.0, scale=8.0, **width)
    params = model.init(torch.Generator().manual_seed(0), dev)
    cfg = FitConfig(learning_rate=5e-3, niters=epochs, maxpoints=256 * 256,
                    scale_lr_by_batch=True)
    return lambda: fit_pointwise(model, params, grid, im_noisy.reshape(-1, 3),
                                 cfg, gt=im.reshape(-1, 3), device=dev)


def main():
    args = sys.argv[1:]
    method = real = None
    if "--ct" in args:
        i = args.index("--ct")
        method = args[i + 1]
        del args[i:i + 2]
    if "--real" in args:
        i = args.index("--real")
        real = args[i + 1]
        del args[i:i + 2]
    if "--mscale2" in args:
        args.remove("--mscale2")
        real = "mscale2"
    mfn = None
    if "--mfn" in args:
        i = args.index("--mfn")
        mfn = "denoise"
        if i + 1 < len(args) and args[i + 1] in ("denoise", "sisr"):
            mfn = args.pop(i + 1)
        del args[i]
    wire2d = None
    if "--wire2d" in args:
        i = args.index("--wire2d")
        wire2d = "denoise"
        if i + 1 < len(args) and args[i + 1] in ("denoise", "ct"):
            wire2d = args.pop(i + 1)
        del args[i]
    epochs = int(args[0]) if args else 20
    dev = resolve("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    if wire2d is not None:
        run = wire2d_fit(epochs, wire2d, dev)
    elif mfn is not None:
        run = mfn_fit(epochs, mfn, dev)
    elif real is not None:
        run = real_fit(epochs, real, dev)
    elif method is not None:
        run = ct_fit(epochs, method, dev)
    else:
        run = denoise_fit(epochs, dev)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    # device-side events only (kernels, copies, memsets): an operator's or
    # an autograd Function's range on the host also carries the device time
    # of the kernels it launched, which would count them twice
    by_kernel = {}
    for e in prof.key_averages():
        us = e.device_time_total if e.device_type == DeviceType.CUDA else 0
        if us > 0:
            by_kernel[e.key] = (by_kernel.get(e.key, 0.0) + us / 1e3 / epochs,
                                e.count / epochs)
    busy = sum(ms for ms, _ in by_kernel.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "fit": (f"wire2d {wire2d}" if wire2d is not None else
                f"mfn {mfn}" if mfn is not None else
                "mscale_2 denoise" if real == "mscale2" else
                f"bspline {real}" if real is not None else
                "denoise" if method is None else f"ct {method}"),
        "epochs": epochs, "nvidia_smi": smi,
        "wall_ms_per_epoch": wall_ms / epochs,
        "device_busy_ms_per_epoch": busy if busy else "not measured",
        "device_idle_share": 1.0 - busy * epochs / wall_ms if busy
        else "not measured",
        "kernels_ms_per_epoch": {
            k: {"ms": ms, "launches": n} for k, (ms, n) in sorted(
                by_kernel.items(), key=lambda kv: -kv[1][0])}}))


if __name__ == "__main__":
    main()
