"""Nonlinearity sweeps (port of wire_tpu/apps/sweep.py): the rebuild
of the legacy ``wire_*.py`` scripts' outer loops.  Each of the six headline
nonlinearities (wire, siren, mfn, relu, posenc, gauss) is fitted to one
task with the scripts' hardcoded per-nonlin hyperparameters, and the
deviation from the paper's expected metric table is recorded and
aggregated.

(The reference's own legacy scripts can no longer run: their factory call
omits a required argument, SURVEY.md §2.6; this module implements the
intended behavior.)

Tasks and their hardcoded settings (with reference cites):
- denoise  wire_image_denoise.py:30-77 (omega0 7, sigma0 4/6-wire, 300 wide,
           2000 iters, per-nonlin LRs, expected PSNRs at :31)
- ct       wire_ct.py:28-53 (omega0 3/12-siren, 300 wide, 5000 iters)
- sisr     wire_SISR.py:28-60 (omega0 8, down 4x, 2000 iters)

Every family trains through its kernels on the card: wire through
wire_step (denoise) and the wire_mlp pair (SISR, CT), siren, gauss, relu
and posenc through real_step and the real_mlp pair, mfn through mfn_step
and the mfn_mlp pair; CT's 'auto' Radon operator is the fourier method
there (line_sample).  ``device="cpu"`` runs the plain PyTorch path.

    python -m wire_tpu_torch.apps.sweep {denoise,sisr,ct} [--nonlins ...]

Only the single-seed sweeps are ported: ``--seeds`` (one family's seeds
batched in one device program) needs the batched fitters of ROADMAP A.8.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from wire_tpu_torch.apps import common
from wire_tpu_torch.apps import ct as TCT
from wire_tpu_torch.apps import sisr as TS
from wire_tpu_torch.device import resolve
from wire_tpu_torch.nn.registry import get_inr
from wire_tpu_torch.operators.forward import DownsampleOp
from wire_tpu_torch.operators.radon import RadonOp
from wire_tpu_torch.signals import coords as C, image as I, noise as N
from wire_tpu_torch.train import artifacts as A, metrics as M
from wire_tpu_torch.train.trainer import (FitConfig, fit_operator,
                                          fit_pointwise)

NONLINS = ["wire", "siren", "mfn", "relu", "posenc", "gauss"]

# paper-expected values per task (order matches NONLINS)
EXPECTED = {
    "denoise_psnr": [30.2, 26.6, 28.1, 0, 29.2, 29.7],  # wire_image_denoise.py:31
    "ct_psnr": [32.3, 30.3, 18.1, 0, 28.5, 29.2],       # wire_ct.py:34-37
    "ct_ssim": [0.81, 0.76, 0.23, 0, 0.71, 0.73],
    "sisr_mse_db": [27.3, 25.6, 21.9, 0, 26.3, 26.1],   # wire_SISR.py:32-35
    "sisr_ssim": [0.93, 0.90, 0.77, 0, 0.92, 0.91],
}

_DENOISE_LR = {"wire": 5e-3, "siren": 2e-3, "mfn": 5e-2, "relu": 1e-3,
               "posenc": 2e-3, "gauss": 3e-3}  # wire_image_denoise.py:76-83
_CT_LR = {"wire": 5e-3, "siren": 2e-3, "mfn": 5e-2, "relu": 1e-3,
          "posenc": 1e-3, "gauss": 2e-3}       # wire_ct.py:67-76
_SISR_LR = {"wire": 5e-3, "siren": 2e-3, "mfn": 5e-2, "relu": 1e-3,
            "posenc": 1e-3, "gauss": 2e-3}     # wire_SISR.py:96-103


def _build(nonlin, task, H, W, tau, in_features=2, out_features=3,
           hidden_features=None, hidden_layers=2, posenc_sidelength=None):
    omega0, sigma0 = {
        "denoise": (7.0, 4.0), "ct": (3.0, 12.0), "sisr": (8.0, 9.0),
    }[task]  # denoise :41-42, ct :47-49, sisr wire_SISR.py:49-51
    if hidden_features is None:
        # wire_image_denoise.py:48 / wire_ct.py:52-53 use 300;
        # wire_SISR.py:55-56 uses 256
        hidden_features = 256 if task == "sisr" else 300
    if task == "denoise" and nonlin == "wire":
        sigma0 = 6.0  # wire_image_denoise.py:86
    if task == "ct" and nonlin == "siren":
        omega0 = 12.0  # wire_ct.py:84-85
    pos_encode = False
    model_nonlin = nonlin
    sidelength = H
    if nonlin == "posenc":
        model_nonlin, pos_encode = "relu", True
        if posenc_sidelength is not None:
            sidelength = posenc_sidelength  # ct: nmeas (wire_ct.py:103)
        else:
            sidelength = (int(max(H, W) / 3)
                          if (task == "denoise" and tau < 100)
                          else int(max(H, W)))
    return get_inr(model_nonlin, in_features=in_features,
                   out_features=out_features,
                   hidden_features=hidden_features,
                   hidden_layers=hidden_layers, first_omega0=omega0,
                   hidden_omega0=omega0, scale=sigma0,
                   pos_encode=pos_encode, sidelength=sidelength)


def _step_ms(res):
    """The fit's device ms per step/iteration (CUDA events), where one was
    measured (not on the CPU)."""
    return {} if res.step_ms is None else {"Step (ms)": res.step_ms}


def denoise_images(image=None, seed=0, tau=3e1, noise_snr=2, size=512,
                   downscale=0.5):
    """(im, im_noisy) of the denoise sweep: the input (or the size^2
    procedural stand-in) area-scaled by ``downscale`` and its photon +
    readout noised copy (RandomState(seed)), float32."""
    # the reference script's fixed 1/2 (wire_image_denoise.py:55) assumes
    # its 2040x1356 parrot source; downscale=1 keeps smaller inputs at a
    # comparable pixels-per-parameter ratio
    im = common.load_image(image, size=size, channels=3, seed=seed)
    if downscale != 1:
        im = I.resize_area(im, downscale)
    rng = np.random.RandomState(seed)
    im_noisy = N.measure_np(im, noise_snr, tau, rng=rng).astype(np.float32)
    return im, im_noisy


def sweep_denoise(image=None, results_dir="results", seed=0, niters=2000,
                  tau=3e1, noise_snr=2, nonlins=NONLINS, size=512,
                  downscale=0.5, device=None):
    dev = resolve(device)
    im, im_noisy = denoise_images(image, seed, tau, noise_snr, size,
                                  downscale)
    H, W, _ = im.shape
    coords = C.grid2d(H, W)

    results = {}
    for nonlin in nonlins:
        model = _build(nonlin, "denoise", H, W, tau)
        params = model.init(torch.Generator().manual_seed(seed), dev)
        cfg = FitConfig(learning_rate=_DENOISE_LR[nonlin], niters=niters,
                        maxpoints=256 * 256, scale_lr_by_batch=True)
        res = fit_pointwise(model, params, coords, im_noisy.reshape(-1, 3),
                            cfg, gt=im.reshape(-1, 3), device=dev)
        psnr = float(M.psnr_ref(im, res.best_rec.reshape(H, W, 3)))
        exp = EXPECTED["denoise_psnr"][NONLINS.index(nonlin)]
        results[nonlin] = {
            "Best PSNR": psnr, "Expected PSNR": exp,
            "PSNR Difference": psnr - exp,
            "Number of parameters": model.num_params(params),
            "Time (s)": res.wall_time_s, **_step_ms(res),
            "rec": res.best_rec.reshape(H, W, 3),
        }
        A.log(f"denoise {nonlin}: PSNR {psnr:.2f} (expected {exp})")
    _save_sweep(results, results_dir, "denoise_sweep")
    return results


def sweep_ct(image=None, results_dir="results", seed=0, niters=5000,
             nmeas=100, nonlins=NONLINS, size=512, device=None):
    dev = resolve(device)
    img = common.load_image(image, size=size, channels=1, seed=seed)
    if img.ndim == 3:
        img = img[..., 0]
    img = I.normalize(img, True).astype(np.float32)
    H, W = img.shape
    thetas = np.linspace(0, 180, nmeas, dtype=np.float32)
    # measured and fitted through one operator ('auto': fourier on the
    # card, rotate on the CPU)
    sinogram = TCT.make_sinogram(img, thetas, device=dev)
    op = RadonOp(thetas)
    coords = C.grid2d(H, W)

    results = {}
    for nonlin in nonlins:
        model = _build(nonlin, "ct", H, W, tau=1e2, out_features=1,
                       posenc_sidelength=nmeas)  # wire_ct.py:103
        params = model.init(torch.Generator().manual_seed(seed), dev)
        cfg = FitConfig(learning_rate=_CT_LR[nonlin], niters=niters)
        res = fit_operator(model, params, coords, sinogram, op, cfg,
                           gt_field=img, field_shape=(H, W), track="gt",
                           device=dev)
        psnr = float(M.psnr_ref(img, res.best_rec))
        ssim = float(M.ssim(img, res.best_rec))
        iexp = NONLINS.index(nonlin)
        results[nonlin] = {
            "Best PSNR": psnr, "Expected PSNR": EXPECTED["ct_psnr"][iexp],
            "PSNR Difference": psnr - EXPECTED["ct_psnr"][iexp],
            "Best SSIM": ssim, "Expected SSIM": EXPECTED["ct_ssim"][iexp],
            "Time (s)": res.wall_time_s, **_step_ms(res),
            "rec": res.best_rec,
        }
        A.log(f"ct {nonlin}: PSNR {psnr:.2f} SSIM {ssim:.3f}")
    _save_sweep(results, results_dir, "ct_sweep")
    return results


def sweep_sisr(image=None, results_dir="results", seed=0, niters=2000,
               scale=4, nonlins=NONLINS, size=768, device=None):
    dev = resolve(device)
    im, im_lr = TS.sisr_images(image, seed, scale, size=size)
    H, W, _ = im.shape
    coords = C.grid2d(H, W)

    results = {}
    for nonlin in nonlins:
        model = _build(nonlin, "sisr", H, W, tau=1e2)
        params = model.init(torch.Generator().manual_seed(seed), dev)
        cfg = FitConfig(learning_rate=_SISR_LR[nonlin], niters=niters,
                        lr_decay=0.2)
        res = fit_operator(model, params, coords, im_lr, DownsampleOp(scale),
                           cfg, gt_field=im, field_shape=(H, W, 3),
                           track="gt", device=dev)
        mse_db = float(M.mse_db(res.best_mse))
        ssim = float(M.ssim(im, res.best_rec))
        iexp = NONLINS.index(nonlin)
        results[nonlin] = {
            "Best MSE": mse_db,
            "Expected MSE": EXPECTED["sisr_mse_db"][iexp],
            "Best SSIM": ssim,
            "Expected SSIM": EXPECTED["sisr_ssim"][iexp],
            "Time (s)": res.wall_time_s, **_step_ms(res),
            "rec": res.best_rec,
        }
        A.log(f"sisr {nonlin}: MSE {mse_db:.2f}dB SSIM {ssim:.3f}")
    _save_sweep(results, results_dir, "sisr_sweep")
    return results


def _save_sweep(results, results_dir, name):
    """<name>_info.mat (each family's reconstruction), <name>_metrics.mat
    and <name>_table.md under results_dir."""
    os.makedirs(results_dir, exist_ok=True)
    mdict = {}
    metrics = {}
    for nonlin, r in results.items():
        mdict[nonlin] = {"rec": r["rec"]}
        metrics[nonlin] = {k: v for k, v in r.items() if k != "rec"}
    A.save_mat(os.path.join(results_dir, f"{name}_info.mat"), mdict)
    mpath = os.path.join(results_dir, f"{name}_metrics.mat")
    A.save_mat(mpath, metrics)
    A.tabulate_results(mpath, results_dir)
    os.replace(os.path.join(results_dir, "metrics_table.md"),
               os.path.join(results_dir, f"{name}_table.md"))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("task", choices=["denoise", "ct", "sisr"])
    p.add_argument("--image", default=None,
                   help="input image as a .npy array (default: procedural "
                        "test image)")
    p.add_argument("--results_dir", default="results")
    p.add_argument("--niters", type=int, default=None)
    p.add_argument("--nonlins", nargs="+", default=NONLINS)
    p.add_argument("--downscale", type=float, default=None)
    p.add_argument("--seeds", type=int, default=0,
                   help="run this many seeds of ONE family batched in one "
                        "device program (not ported yet)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    a = p.parse_args(argv)
    if a.seeds:
        raise NotImplementedError(
            "sweep --seeds needs fit_pointwise_many / fit_operator_many, "
            "which are not ported yet (ROADMAP A.8)")
    kw = dict(image=a.image, results_dir=a.results_dir, nonlins=a.nonlins,
              device=a.device)
    if a.niters:
        kw["niters"] = a.niters
    if a.downscale is not None and a.task == "denoise":
        kw["downscale"] = a.downscale
    {"denoise": sweep_denoise, "ct": sweep_ct, "sisr": sweep_sisr}[a.task](
        **kw)


if __name__ == "__main__":
    main()
