"""Shared plumbing for the task drivers (port of wire_tpu/apps/common.py):
input loading (a PNG file, a .npy array or the procedural stand-in), model construction
from a preset, artifact writing, and ``--mesh``: a sharded fit over a
process group (``wire_tpu_torch.dist``)."""
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
                   help="input image: a PNG file (read as wire_tpu reads "
                        "it: min-max normalized, alpha dropped) or a .npy "
                        "array (default: procedural test image)")
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reference_compat", action="store_true",
                   help="reproduce reference defects that affected published "
                        "numbers (mscale_HL first-layer detach; CT: radon "
                        "'auto' routes to the reference-exact 'rotate')")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="shard the fit over the N ranks of a process group "
                        "(0 = single device; N > 1 under python -m "
                        "torch.distributed.run --nproc-per-node N; 1 alone "
                        "is a world of one)")
    return p


def mesh_from_arg(n, device=None):
    """0/None -> None, a single-device fit; N -> this rank's Mesh of a
    process group of N ranks: the one ``torch.distributed.run``'s
    environment describes (``multihost.initialize``), or for N = 1 without
    one a world of this process alone.  A group of another size raises:
    a sharded run is never quietly run unsharded."""
    if not n:
        return None
    import torch.distributed as dist
    from wire_tpu_torch.dist import make_mesh, multihost
    multihost.initialize(device=device)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"--mesh {n}: no process group; launch with python -m "
                f"torch.distributed.run --nproc-per-node {n} ... --mesh {n}")
        multihost.world_of_one(device=device)
    if dist.get_world_size() != n:
        raise RuntimeError(f"--mesh {n}: the process group has "
                           f"{dist.get_world_size()} ranks")
    return make_mesh(n, device)


def writes_artifacts(mesh):
    """Whether this process writes the run's files: every single-device
    run, and rank 0 of a sharded one."""
    return mesh is None or mesh.rank == 0


def load_image(path, size=512, channels=3, seed=0):
    """An (H, W, 3) image, or (H, W) when ``channels == 1`` (the green
    channel of a colour file): the file at ``path``, a .npy array as it is
    or a PNG through ``signals/image.py:imread`` (min-max normalized, as
    wire_tpu reads it), or the procedural natural-statistics stand-in
    (wire_tpu/apps/common.py:42-51)."""
    if path:
        im = np.load(path) if path.endswith(".npy") else I.imread(path)
        im = im.astype(np.float32)
        if channels == 1 and im.ndim == 3:
            im = im[..., 1]
        return im
    im = I.natural_image(size, size, channels, seed=seed)
    return im[..., 0] if channels == 1 else im


def build_model(cfg, *, in_features, out_features, omega0, hidden_layers=2,
                hidden_features=None, sidelength=512, reference_compat=False):
    """The preset's model, wired as the config-driven scripts wire it
    (wire_tpu/apps/common.py:54-81): posenc is relu with pos_encode on;
    the preset's scale, scale_tensor and scaled_hidden_features, omega0 for
    both omegas, and ``sidelength`` (posenc's frequency count) go to the
    factory; ``hidden_features`` overrides the preset's width, as the CT app
    does; ``reference_compat`` sets mscale_HL's ``detach_split``;
    mscale_1_new and repIN widen ``in_features`` to in_features x scales x
    scaled_hidden_features (wire_tpu/apps/common.py:63-65)."""
    nonlin, pos_encode = cfg.nonlin, False
    if nonlin == "posenc":
        nonlin, pos_encode = "relu", True
    if nonlin in ("bspline_mscale_1_new", "bspline_mscale_repIN"):
        in_features = (in_features * len(cfg.scale_tensor)
                       * cfg.scaled_hidden_features)
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
        detach_split=reference_compat,
    )


def write_run_artifacts(results_dir, task_dir, run_name, mdict_entry,
                        metrics_entry):
    """info.mat / metrics.mat / metrics_table.md, and Output_img.png when
    the entry has a reconstruction ``rec``, under
    results_dir/task_dir/<unique run folder>
    (wire_tpu/apps/common.py:84-99).  A sharded run calls it on rank 0
    alone (``writes_artifacts``)."""
    parent = os.path.join(results_dir, task_dir)
    os.makedirs(parent, exist_ok=True)
    folder = A.make_unique(run_name, parent)
    path = os.path.join(parent, folder)
    os.makedirs(path, exist_ok=True)
    A.save_mat(os.path.join(path, "info.mat"), {folder: mdict_entry})
    A.save_mat(os.path.join(path, "metrics.mat"), {folder: metrics_entry})
    A.tabulate_results(os.path.join(path, "metrics.mat"), path)
    if "rec" in mdict_entry:
        A.display_image(os.path.join(path, "info.mat"))
    return path
