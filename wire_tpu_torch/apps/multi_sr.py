"""Multi-frame super-resolution driver (port of wire_tpu/apps/multi_sr.py):
combine a burst of randomly shifted and rotated LR frames into one HR INR.

Pipeline: synthesize nimg = 0.25 s^2 warped HR frames of the image with
known Euclidean motion (shifts up to 5 s px, rotations up to pi/10),
box-downsample each by s, take the motion as known (oracle) or estimate it
(``register_burst``), then fit with ``fit_frames``: render the INR at each
frame's warped HR grid, box-downsample, masked MSE against the LR frame,
frames in shuffled batches of 4, no learning-rate decay; the best
parameters rendered on the full grid at the end; scipy griddata
interpolation as the baseline.  Writes
``<results_dir>/multi_SR/<s>x_<nimg>images_<nonlin>_<oracle|estim>_reg.mat``.

    python -m wire_tpu_torch.apps.multi_sr                # WIRE, 192^2, x4
    python -m wire_tpu_torch.apps.multi_sr --estim_reg
    python -m wire_tpu_torch.apps.multi_sr --device cpu --niters 5

Runs on the card unless given ``device="cpu"``.  ``--mesh N`` splits each
batch's frames over N ranks (``fit_frames`` with a mesh,
``dist.fit_frames_sharded``; the batch size divisible by N); rank 0 writes
the .mat.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from wire_tpu_torch.apps import common
from wire_tpu_torch.apps.common import load_image
from wire_tpu_torch.device import resolve
from wire_tpu_torch.nn.registry import get_inr
from wire_tpu_torch.signals import coords as C, image as I, motion as Mo
from wire_tpu_torch.train import artifacts as A, metrics as M
from wire_tpu_torch.train.trainer import FitConfig, fit_frames

_LR = {"wire": 5e-3, "siren": 1e-3, "mfn": 5e-2, "relu": 5e-4,
       "posenc": 5e-4, "gauss": 1e-3}


def setup(nonlin="wire", *, image=None, seed=0, scale_sr=4, niters=2000,
          use_gt_registration=True, size=192, hidden_features=256,
          hidden_layers=2, omega0=10.0, sigma0=5.0, fused="auto"):
    """The app's problem as a dict: the HR image ``im``, the burst's LR
    frames ``imstack``, the known motions ``mats``, the grids ``Xs``/``Ys``
    the fit takes (the burst's own, or ``register_burst``'s with its
    ``ok`` flags and warps ``est``), the ``FrameDataset`` ``ds``, the
    ``model`` and the fit config ``cfg``.  ``fused="never"`` builds the
    model's plain path."""
    rng = np.random.RandomState(seed)
    if image:
        im = load_image(image)
    else:
        im = I.synthetic_image(size, size, 3, seed=seed)
    H, W, _ = im.shape
    nimg = int(0.25 * scale_sr * scale_sr)
    imstack_hr, Xgt, Ygt, mats = Mo.make_burst(
        im, shift_max=5 * scale_sr, theta_max=np.pi / 10, nframes=nimg,
        rng=rng)
    imstack = Mo.downsample_burst(imstack_hr, scale_sr)
    out = dict(im=im, imstack=imstack, mats=mats, nimg=nimg)
    if use_gt_registration:
        out.update(Xs=Xgt, Ys=Ygt)
    else:
        Xs, Ys, ok, est = Mo.register_burst(imstack, (H, W))
        out.update(Xs=Xs, Ys=Ys, ok=ok, est=est)
    masks = 1.0 - np.float32(imstack == 0)
    out["ds"] = Mo.FrameDataset.build(imstack, out["Xs"], out["Ys"], masks)
    model_nonlin, pos_encode = nonlin, False
    if nonlin == "posenc":
        model_nonlin, pos_encode = "relu", True
    out["model"] = get_inr(model_nonlin, in_features=2, out_features=3,
                           hidden_features=hidden_features,
                           hidden_layers=hidden_layers, first_omega0=omega0,
                           hidden_omega0=omega0, scale=sigma0,
                           pos_encode=pos_encode, sidelength=max(H, W),
                           fused=fused)
    # the reference's multi-SR runs without decay
    out["cfg"] = FitConfig(learning_rate=_LR.get(nonlin, 5e-3),
                           niters=niters, lr_decay=1.0, seed=seed)
    return out


def run(nonlin="wire", *, image=None, results_dir="results", seed=0,
        scale_sr=4, niters=2000, use_gt_registration=True, size=192,
        hidden_features=256, hidden_layers=2, omega0=10.0, sigma0=5.0,
        batch_size=4, mesh=None, params=None, fused="auto", device=None):
    """The app's fit and artifacts.  ``params`` replaces the seed's init
    (the tests move wire_tpu's across); returns psnr, ssim, psnr_interp,
    the .mat path, the FitResult and, with estimated registration, the
    warps' errors against the known motion (``registration_errors``)."""
    dev = mesh.device if mesh is not None else resolve(device)
    A.log(f"Starting multi-SR with {nonlin} on {dev}")
    prob = setup(nonlin, image=image, seed=seed, scale_sr=scale_sr,
                 niters=niters, use_gt_registration=use_gt_registration,
                 size=size, hidden_features=hidden_features,
                 hidden_layers=hidden_layers, omega0=omega0, sigma0=sigma0,
                 fused=fused)
    im, imstack, ds, model = (prob[k] for k in ("im", "imstack", "ds",
                                                "model"))
    H, W, _ = im.shape
    nimg = prob["nimg"]
    if params is None:
        params = model.init(torch.Generator().manual_seed(seed), dev)
    nparams = model.num_params(params)
    A.log(f"Learning with {nparams} parameters "
          f"({nimg * (H // scale_sr) * (W // scale_sr) / nparams:.2f}x "
          f"compression)")

    im_interp = interp_baseline(im, imstack, prob["Xs"], prob["Ys"],
                                scale_sr)
    snr_interp = float(M.psnr_ref(im, im_interp))

    res = fit_frames(model, params, ds.coords, ds.pixels, ds.masks,
                     prob["cfg"], hr_shape=(H, W, 3), scale=scale_sr,
                     batch_size=batch_size, device=dev, mesh=mesh)

    coords_full = torch.from_numpy(C.grid2d(H, W)).to(dev)
    with torch.no_grad():
        img_full = model.apply(res.best_params, coords_full).reshape(
            H, W, 3).cpu().numpy()
    snrval = float(M.psnr_ref(im, img_full))
    ssimval = float(M.ssim(im, img_full))
    A.log(f"multi-SR {nonlin}: PSNR {snrval:.3f} (interp {snr_interp:.3f}) "
          f"SSIM {ssimval:.3f}")

    outdir = os.path.join(results_dir, "multi_SR")
    tag = "oracle_reg" if use_gt_registration else "estim_reg"
    mat = os.path.join(outdir, f"{scale_sr}x_{nimg}images_{nonlin}_{tag}.mat")
    if common.writes_artifacts(mesh):
        os.makedirs(outdir, exist_ok=True)
        A.save_mat(mat, {"rec": img_full, "psnr_rec": snrval,
                         "ssim_rec": ssimval, "psnr_interp": snr_interp,
                         "rec_interp": im_interp})
    out = {"psnr": snrval, "ssim": ssimval, "psnr_interp": snr_interp,
           "mat": mat, "result": res}
    if not use_gt_registration:
        out["registration"] = dict(
            registered=prob["ok"].tolist(),
            **registration_errors(prob["est"], prob["mats"]))
    return out


def registration_errors(est, mats):
    """Per frame, the translation error (HR px) and the angle error (rad)
    of estimated warps W_i (frame_i(W_i p) ~ frame_0(p)) against the
    inverses of the burst's motions M_i."""
    inv = Mo.invert_regstack(mats)
    a_est = np.arctan2(est[:, 1, 0], est[:, 0, 0])
    a_true = np.arctan2(inv[:, 1, 0], inv[:, 0, 0])
    return {"translation_err_px": np.linalg.norm(
                est[:, :, 2] - inv[:, :, 2], axis=1).tolist(),
            "angle_err_rad": np.abs(a_est - a_true).tolist()}


def interp_baseline(im, imstack, Xs, Ys, scale_sr):
    """scipy griddata linear interpolation of the registered LR samples
    onto the HR grid (NaN outside their hull set to 0)."""
    from scipy import interpolate
    H, W, _ = im.shape
    Y, X = np.mgrid[:H, :W]
    Xn = 2 * X / W - 1
    Yn = 2 * Y / H - 1
    pts = np.hstack((Xs[..., ::scale_sr, ::scale_sr].reshape(-1, 1),
                     Ys[..., ::scale_sr, ::scale_sr].reshape(-1, 1)))
    im_interp = np.zeros_like(im)
    for c in range(3):
        vals = imstack[..., c].reshape(-1, 1)
        im_interp[..., c] = interpolate.griddata(
            pts, vals, (Xn, Yn), method="linear")[..., 0]
    im_interp[np.isnan(im_interp)] = 0
    return im_interp


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nonlin", default="wire")
    p.add_argument("--image", default=None,
                   help="HR image: a PNG file or a .npy array (default: "
                        "the synthetic 192^2 image)")
    p.add_argument("--results_dir", default="results")
    p.add_argument("--scale_sr", type=int, default=4)
    p.add_argument("--niters", type=int, default=2000)
    p.add_argument("--estim_reg", action="store_true",
                   help="estimate the frames' motion (register_burst) "
                        "instead of taking the known one")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="shard the fit over the N ranks of a process group "
                        "(0 = single device; see apps/common.py)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    a = p.parse_args(argv)
    run(a.nonlin, image=a.image, results_dir=a.results_dir,
        scale_sr=a.scale_sr, niters=a.niters,
        use_gt_registration=not a.estim_reg, seed=a.seed,
        mesh=common.mesh_from_arg(a.mesh, a.device), device=a.device)


if __name__ == "__main__":
    main()
