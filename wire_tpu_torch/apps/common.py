"""Shared plumbing for the task drivers (port of wire_tpu/apps/common.py):
input loading (a .npy file or the procedural stand-in), model construction
from a preset, artifact writing."""
from __future__ import annotations

import argparse
import os

import numpy as np

from wire_tpu_torch.nn.registry import get_inr
from wire_tpu_torch.signals import image as I
from wire_tpu_torch.train import artifacts as A


def base_parser(description):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config_name", type=str, required=True,
                   help="preset name from wire_tpu_torch.train.presets")
    p.add_argument("--image", type=str, default=None,
                   help="input image as a .npy array (default: procedural "
                        "test image)")
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p


def load_image(path, size=512, channels=3, seed=0):
    """An (H, W, 3) image, or (H, W) when ``channels == 1`` (the green
    channel of a colour file): the .npy array at ``path``, or the
    procedural natural-statistics stand-in (wire_tpu/apps/common.py:42-51)."""
    if path:
        if not path.endswith(".npy"):
            raise ValueError(f"image {path!r}: only .npy arrays are read "
                             f"(no image library in the port)")
        im = np.load(path).astype(np.float32)
        if channels == 1 and im.ndim == 3:
            im = im[..., 1]
        return im
    im = I.natural_image(size, size, channels, seed=seed)
    return im[..., 0] if channels == 1 else im


def build_model(cfg, *, in_features, out_features, omega0, hidden_layers=2,
                hidden_features=None, sidelength=512):
    """The preset's model, wired as the config-driven scripts wire it
    (wire_tpu/apps/common.py:54-81): posenc is relu with pos_encode on;
    the preset's scale, scale_tensor and scaled_hidden_features, omega0 for
    both omegas, and ``sidelength`` (posenc's frequency count) go to the
    factory; ``hidden_features`` overrides the preset's width, as the CT app
    does.  The mscale families' input widening and detach flag wait for
    those families."""
    nonlin, pos_encode = cfg.nonlin, False
    if nonlin == "posenc":
        nonlin, pos_encode = "relu", True
    return get_inr(
        nonlin,
        in_features=in_features,
        out_features=out_features,
        hidden_features=(hidden_features if hidden_features is not None
                         else cfg.hidden_features),
        hidden_layers=hidden_layers,
        scaled_hidden_features=cfg.scaled_hidden_features,
        first_omega0=omega0,
        hidden_omega0=omega0,
        scale=cfg.scale,
        scale_tensor=cfg.scale_tensor,
        pos_encode=pos_encode,
        sidelength=sidelength,
    )


def write_run_artifacts(results_dir, task_dir, run_name, mdict_entry,
                        metrics_entry):
    """info.mat / metrics.mat / metrics_table.md under
    results_dir/task_dir/<unique run folder>."""
    parent = os.path.join(results_dir, task_dir)
    os.makedirs(parent, exist_ok=True)
    folder = A.make_unique(run_name, parent)
    path = os.path.join(parent, folder)
    os.makedirs(path, exist_ok=True)
    A.save_mat(os.path.join(path, "info.mat"), {folder: mdict_entry})
    A.save_mat(os.path.join(path, "metrics.mat"), {folder: metrics_entry})
    A.tabulate_results(os.path.join(path, "metrics.mat"), path)
    return path
