"""3-D occupancy driver (port of wire_tpu/apps/occupancy.py): fit an INR to
a binary occupancy volume, report IoU per epoch, write a marching-cubes
mesh of the best reconstruction.

Loop semantics: 3 hidden layers, 300 wide, chunks of 2e5 random voxels
over each epoch's permutation of the whole volume, the learning rate
decaying to 0.2x, the thresholded IoU per epoch, the best reconstruction
by the training loss, and a smoothened .dae of it.  The coordinates are
the implicit grid (``GridSpec``): each chunk's rows are computed on the
device from its permuted indices.  The 64^3 synthetic volume's 262,144
voxels make two chunks an epoch, the second with 62,144 valid rows.

    python -m wire_tpu_torch.apps.occupancy                 # WIRE, 64^3
    python -m wire_tpu_torch.apps.occupancy --block_perm 512
    python -m torch.distributed.run --nproc-per-node 2 \
        -m wire_tpu_torch.apps.occupancy --mesh 2

``checkpoint_path`` saves the fit's state every ``checkpoint_every``
segments of ``scan_segment`` epochs (250 by default) and resumes from it
(with a mesh, a file per rank).  With a ``mesh`` (``--mesh N``) the fit is
sharded (``fit_pointwise``'s local mode): each rank is fed only its own rows of the grid and the target
(``multihost.feed_rows``; the grid's rows are ``GridSpec``'s, computed on
the rank's device, so a world of one fits what the unsharded app fits),
and the per-epoch IoU comes from the ranks' intersection and union counts,
summed (``iou_sums``); rank 0 writes the artifacts.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from wire_tpu_torch.apps import common
from wire_tpu_torch.device import resolve
from wire_tpu_torch.nn.registry import get_inr
from wire_tpu_torch.signals import coords as C, image as I, volume as V
from wire_tpu_torch.train import artifacts as A, metrics as M
from wire_tpu_torch.train.trainer import (CheckpointSpec, FitConfig,
                                          fit_pointwise)

_LR = {"wire": 5e-3, "siren": 2e-3, "mfn": 5e-2, "relu": 1e-3,
       "posenc": 1e-3, "gauss": 2e-3}


def iou_metric(thres):
    """The per-epoch IoU at ``thres``: a two-argument (rec, target) metric
    for fit_pointwise, evaluated on the device."""

    def metric(rec, tgt):
        return M.iou(rec, tgt, thres)

    return metric


def iou_sums(thres):
    """The sharded fit's per-epoch sums: this rank's counts of the voxels
    in the intersection and in the union of ``rec >= thres`` and the
    target's nonzero voxels (wire_tpu/apps/occupancy.py:33-49)."""

    def sums(rec, tgt):
        p, g = rec >= thres, tgt != 0
        return torch.logical_and(p, g).sum(), torch.logical_or(p, g).sum()

    return sums


def best_metrics(im, best, thres=0.5):
    """(IoU, PSNR) of a best reconstruction ``best`` of volume ``im`` as the
    app reports them: the IoU of best >= thres against the nonzero voxels,
    and 10 log10(max(im) / MSE)."""
    bt = best >= thres
    inter = np.count_nonzero(np.logical_and(bt, im != 0))
    union = np.count_nonzero(np.logical_or(bt, im != 0))
    psnr = float(10.0 * np.log10(im.max() / np.mean((im - best) ** 2)))
    return inter / max(union, 1), psnr


def setup(nonlin="wire", *, volume_mat=None, seed=0, niters=200, size=64,
          scale=1.0, maxpoints=int(2e5), hidden_layers=3,
          hidden_features=300, lr_decay=0.2, block_perm=0, fused="auto"):
    """(volume, grid, target, model, fit config) of the app's problem: the
    .mat volume or the synthetic one, and the family's frequencies and
    learning rate (wire_tpu/apps/occupancy.py:64-129).  ``fused="never"``
    builds the model's plain path."""
    if volume_mat:
        im = V.load_volume_mat(volume_mat, scale=scale)
    else:
        im = I.synthetic_volume(size, seed=seed)
    H, W, T = im.shape
    maxpoints = min(H * W * T, maxpoints)
    omega0, sigma0 = 10.0, 40.0
    if nonlin == "wire":
        omega0, sigma0 = 20.0, 10.0
    elif nonlin == "siren":
        omega0 = 40.0
    elif nonlin == "gauss":
        sigma0 = 30.0
    model_nonlin, pos_encode = nonlin, False
    if nonlin == "posenc":
        model_nonlin, pos_encode = "relu", True
    model = get_inr(model_nonlin, in_features=3, out_features=1,
                    hidden_features=hidden_features,
                    hidden_layers=hidden_layers, first_omega0=omega0,
                    hidden_omega0=omega0, scale=sigma0,
                    pos_encode=pos_encode, sidelength=max(H, W, T),
                    fused=fused)
    cfg = FitConfig(learning_rate=_LR.get(nonlin, 5e-3), niters=niters,
                    maxpoints=maxpoints, lr_decay=lr_decay, seed=seed,
                    block_perm=block_perm)
    return im, C.GridSpec(H, W, T), im.reshape(-1, 1), model, cfg


def run(nonlin="wire", *, volume_mat=None, results_dir="results", seed=0,
        niters=200, size=64, scale=1.0, maxpoints=int(2e5), hidden_layers=3,
        hidden_features=300, mcubes_thres=0.5, mesh=None,
        scan_segment=None, checkpoint_path=None, checkpoint_every=1,
        lr_decay=0.2, block_perm=0, device=None):
    dev = mesh.device if mesh is not None else resolve(device)
    A.log(f"Running {nonlin} occupancy on {dev}")
    im, grid, target, model, fit_cfg = setup(
        nonlin, volume_mat=volume_mat, seed=seed, niters=niters, size=size,
        scale=scale, maxpoints=maxpoints, hidden_layers=hidden_layers,
        hidden_features=hidden_features, lr_decay=lr_decay,
        block_perm=block_perm)
    H, W, T = im.shape
    A.log(f"volume shape {im.shape}")
    params = model.init(torch.Generator().manual_seed(seed), dev)
    nparams = model.num_params(params)
    if scan_segment is not None:
        fit_cfg = dataclasses.replace(fit_cfg, scan_segment=scan_segment)
    ckpt = (CheckpointSpec(path=checkpoint_path, every=checkpoint_every)
            if checkpoint_path else None)

    if mesh is not None:
        from wire_tpu_torch.dist import multihost
        n = grid.npoints
        coords = multihost.feed_rows(mesh, lambda lo, hi: grid.rows(
            torch.arange(lo, hi, device=dev)), n)
        fed = multihost.feed_rows(mesh, lambda lo, hi: target[lo:hi], n)
        res = fit_pointwise(model, params, coords, fed, fit_cfg,
                            track="noisy", epoch_sums=iou_sums(mcubes_thres),
                            checkpoint=ckpt, mesh=mesh)
        inter, union = res.time_array
        iou_hist = inter / np.maximum(union, 1.0)
    else:
        res = fit_pointwise(model, params, grid, target, fit_cfg,
                            track="noisy",
                            epoch_metric=iou_metric(mcubes_thres),
                            checkpoint=ckpt, device=dev)
        iou_hist = res.time_array
    best = res.best_rec.reshape(H, W, T)
    best_iou, psnr = best_metrics(im, best, mcubes_thres)
    A.log(f"IoU: {best_iou}")
    A.log(f"Best PSNR: {psnr} dB")
    A.log(f"Total parameters: {nparams / 1e6} million")

    outdir = os.path.join(results_dir, "occupancy")
    mesh_path = os.path.join(outdir, f"{nonlin}.dae")
    out = {"iou": best_iou, "psnr": psnr, "mesh": mesh_path,
           "iou_array": np.asarray(iou_hist), "result": res}
    if not common.writes_artifacts(mesh):
        return out
    os.makedirs(outdir, exist_ok=True)
    A.save_mat(os.path.join(outdir, f"{nonlin}.mat"), {
        "mse_array": res.mse_noisy,
        "iou_array": np.asarray(iou_hist),
        "nparams": nparams,
        "Best PSNR": psnr,
        "Best IoU": best_iou,
        "Total time": res.wall_time_s / 60,
    })
    verts, faces = V.march_and_save(best, mcubes_thres, mesh_path,
                                    smoothen=True)
    out.update(nverts=len(verts), nfaces=len(faces))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nonlin", default="wire")
    p.add_argument("--volume_mat", default=None)
    p.add_argument("--results_dir", default="results")
    p.add_argument("--niters", type=int, default=200)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="shard the fit over the N ranks of a process group "
                        "(0 = single device; see apps/common.py)")
    p.add_argument("--lr_decay", type=float, default=0.2,
                   help="LR decay factor over niters (reference: 0.2)")
    p.add_argument("--block_perm", type=int, default=0,
                   help="permute contiguous N-point blocks instead of "
                        "points (0 = the per-point permutation)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    a = p.parse_args(argv)
    run(a.nonlin, volume_mat=a.volume_mat, results_dir=a.results_dir,
        niters=a.niters, size=a.size, seed=a.seed,
        mesh=common.mesh_from_arg(a.mesh, a.device), lr_decay=a.lr_decay,
        block_perm=a.block_perm, device=a.device)


if __name__ == "__main__":
    main()
