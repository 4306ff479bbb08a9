"""CT reconstruction app (port of wire_tpu/apps/ct.py): fit an INR to a
100-angle sinogram through the differentiable Radon operator.

Loop semantics: a one-channel image, normalized and area-halved; sinogram
= radon(image, linspace(0, 180, 100)) through the same method that fits
it (or a user-supplied sinogram, which routes 'auto' to the
reference-exact 'rotate'), optional sensor noise; each iteration renders
the full grid, applies radon, takes the MSE against the sinogram and steps
Adam with a per-iteration decay; the best image by MSE vs the clean image;
PSNR and SSIM reported.

    python -m wire_tpu_torch.apps.ct --config_name WIRE_s12_o8_LR5e3_E2000

``--mesh N`` renders the field in N ranks' shards
(``dist.fit_operator_sharded``; the Radon operator runs replicated); rank
0 writes the artifacts.
"""
from __future__ import annotations

import numpy as np
import torch

from wire_tpu_torch.apps import common
from wire_tpu_torch.device import resolve
from wire_tpu_torch.operators.radon import RadonOp, radon
from wire_tpu_torch.signals import coords as C, image as I, noise as N
from wire_tpu_torch.train import artifacts as A, metrics as M, profiling
from wire_tpu_torch.train.presets import get_config
from wire_tpu_torch.train.trainer import FitConfig, fit_operator

RADON_METHODS = ("auto", "rotate", "rotate_xla", "fourier", "shear")


@profiling.spanned("apps.inputs")
def ct_image(image=None, seed=0, size=512):
    """The CT protocol's field: one channel, min-max normalized, area-halved
    (size // 2 square for the procedural stand-in), float32."""
    img = common.load_image(image, size=size, channels=1, seed=seed)
    img = I.normalize(img, True)
    return I.resize_area(img, 0.5).astype(np.float32)


@profiling.spanned("apps.inputs")
def make_sinogram(img, thetas, *, radon_method="auto",
                  reference_compat=False, device=None):
    """The self-consistent measurement: radon of the clean image through
    the method that will fit it, as a float32 numpy array."""
    dev = resolve(device)
    with torch.no_grad():
        sino = radon(torch.from_numpy(np.ascontiguousarray(img)).to(dev),
                     thetas, method=radon_method,
                     reference_compat=reference_compat)
    return sino.cpu().numpy().astype(np.float32)


def build_ct_model(cfg, omega0):
    """WIRE with 300 hidden features (212 complex units), 2 hidden layers,
    2 in, 1 out (wire_tpu/apps/ct.py:62-65)."""
    return common.build_model(cfg, in_features=2, out_features=1,
                              omega0=omega0, hidden_features=300)


def run(config_name, *, image=None, results_dir="results", seed=0,
        nmeas=100, reference_compat=False, mesh=None, radon_method="auto",
        sinogram_path=None, device=None):
    dev = mesh.device if mesh is not None else resolve(device)
    cfg = get_config(config_name)
    A.log(f"Starting CT experiment ({config_name}) on {dev}")

    omega0 = cfg.omega0 if cfg.omega0 is not None else 3.0
    img = ct_image(image, seed)
    H, W = img.shape

    thetas = np.linspace(0, 180, nmeas, dtype=np.float32)
    if sinogram_path is not None:
        # a user-supplied measurement's forward model is not ours: 'auto'
        # takes the reference-exact bilinear-rotate operator, since fitting
        # through a mismatched interpolation model plateaus several dB low
        sinogram = _load_sinogram(sinogram_path).astype(np.float32)
        if sinogram.shape[0] != len(thetas):
            thetas = np.linspace(0, 180, sinogram.shape[0],
                                 dtype=np.float32)
        if radon_method == "auto" and not reference_compat:
            A.log("user-supplied sinogram: routing radon 'auto' -> 'rotate' "
                  "(reference-exact operator).  Pass --radon_method fourier "
                  "explicitly if the measurement was generated by the "
                  "fourier model.")
            reference_compat = True
    else:
        # self-consistent protocol: generate AND fit through one operator
        sinogram = make_sinogram(img, thetas, radon_method=radon_method,
                                 reference_compat=reference_compat,
                                 device=dev)
    rng = np.random.RandomState(seed)
    if cfg.added_noise:
        sinogram = N.measure_np(sinogram, cfg.noise_snr, cfg.tau,
                                rng=rng).astype(np.float32)

    coords = C.grid2d(H, W)
    model = build_ct_model(cfg, omega0)
    params = model.init(torch.Generator().manual_seed(seed), dev)
    A.log(f"Non-linearity: {cfg.nonlin}, LR: {cfg.learning_rate}, "
          f"Scale: {cfg.scale}")

    fit_cfg = FitConfig(learning_rate=cfg.learning_rate,
                        niters=cfg.niters,
                        maxpoints=cfg.maxpoints, seed=seed)
    op = RadonOp(thetas, method=radon_method,
                 reference_compat=reference_compat)
    res = fit_operator(model, params, coords, sinogram, op, fit_cfg,
                       gt_field=img, field_shape=(H, W), track="gt",
                       device=dev, mesh=mesh)

    best = res.best_rec
    psnr = float(M.psnr_ref(img, best))
    ssim = float(M.ssim(img, best, data_range=1.0))
    A.log(f"Best PSNR: {psnr}")
    A.log(f"Best SSIM: {ssim}")

    mdict = {
        "Scale": cfg.scale,
        "rec": best,
        "loss_array": res.mse_gt,
        "sinogram": sinogram,
        "gt": img,
    }
    metrics = {
        "Scale": cfg.scale,
        "Scale Tensor": np.asarray(cfg.scale_tensor),
        "Learning Rate": np.asarray(cfg.learning_rate),
        "Best PSNR": psnr,
        "Best SSIM": ssim,
    }
    path = None
    if common.writes_artifacts(mesh):
        path = common.write_run_artifacts(results_dir, "ct", cfg.name, mdict,
                                          metrics)
    A.log(f"CT experiment completed -> {path}")
    return {"psnr": psnr, "ssim": ssim, "path": path, "result": res}


def _load_sinogram(path):
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".mat"):
        from scipy import io as sio
        z = sio.loadmat(path)
        key = "sinogram" if "sinogram" in z else next(
            k for k in z if not k.startswith("__"))
        return np.asarray(z[key])
    raise ValueError(f"unsupported sinogram file {path!r} (.npy or .mat)")


def main(argv=None):
    p = common.base_parser(__doc__)
    p.add_argument("--radon_method", default="auto", choices=RADON_METHODS,
                   help="'rotate' = reference-exact bilinear semantics "
                        "(CUDA kernel on the card); 'auto' = fast "
                        "self-consistent protocol (reference-exact when "
                        "--reference_compat or --sinogram is given)")
    p.add_argument("--sinogram", default=None,
                   help="path to a user-supplied sinogram (.npy, or .mat "
                        "with a 'sinogram' key) instead of self-generating; "
                        "routes 'auto' to the reference-exact operator")
    a = p.parse_args(argv)
    run(a.config_name, image=a.image, results_dir=a.results_dir,
        seed=a.seed, reference_compat=a.reference_compat,
        radon_method=a.radon_method, sinogram_path=a.sinogram,
        device=a.device, mesh=common.mesh_from_arg(a.mesh, a.device))


if __name__ == "__main__":
    main()
