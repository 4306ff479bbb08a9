"""Run artifacts (port of wire_tpu/train/artifacts.py): timestamped
logging, unique run folders, .mat export, the markdown metrics table,
written by hand (no pandas/tabulate), the reconstruction's
``Output_img.png`` through the port's PNG writer (no matplotlib), and
.npz parameter files.  The orbax checkpoint pair is not ported: it wraps
a JAX library."""
from __future__ import annotations

import os
import re
from datetime import datetime

import numpy as np

from wire_tpu_torch import tree


def log(message):
    """Timestamped print."""
    print(f"{datetime.now()} - {message}")


def make_unique(folder_name, folder_path):
    """Append/increment a numeric suffix until the folder is unused."""
    m = re.search(r"_(\d+)$", folder_name)
    if m:
        base, counter = folder_name[:m.start()], int(m.group(1)) + 1
    else:
        base, counter = folder_name, 1
    candidate = f"{base}_{counter}"
    while os.path.exists(os.path.join(folder_path, candidate)):
        counter += 1
        candidate = f"{base}_{counter}"
    return candidate


def save_mat(path, data):
    from scipy import io
    io.savemat(path, data)


def _cell(v):
    v = np.asarray(v)
    if v.size == 0:
        return "[]"
    if v.size > 1:
        return str(v.ravel().tolist())
    x = v.ravel()[0]
    if isinstance(x, (float, np.floating)):
        return f"{x:.3f}"
    return str(x)


def markdown_table(rows, keys):
    """A markdown table of ``rows`` ({label: {key: value}}): one row per
    label, one column per key, floats to 3 decimals, lists as lists (the
    layout of pandas' ``to_markdown(floatfmt=".3f")``)."""
    lines = ["| | " + " | ".join(keys) + " |",
             "|:--|" + "--:|" * len(keys)]
    for label, row in rows.items():
        lines.append(f"| {label} | "
                     + " | ".join(_cell(row.get(k, [])) for k in keys)
                     + " |")
    return "\n".join(lines) + "\n"


def tabulate_results(mat_file, path):
    """metrics.mat -> metrics_table.md: one row per run, one column per
    metric (``markdown_table``)."""
    from scipy import io
    mat = io.loadmat(mat_file)
    names = [k for k in mat if not k.startswith("__")]
    keys = list(mat[names[0]][0, 0].dtype.names)
    rows = {n: {k: mat[n][0, 0][k] for k in keys} for n in names}
    with open(os.path.join(path, "metrics_table.md"), "w") as f:
        f.write(markdown_table(rows, keys))


def display_image(info_mat_path):
    """Save the reconstruction ``rec`` stored in info.mat as
    Output_img.png beside it (wire_tpu/train/artifacts.py:67): |rec|
    clipped to [0, 1], an RGB image as it is and a 2-D one through the
    gray colour map, with vmin 0 and vmax 1, the pixels ``plt.imsave``
    writes (``signals/image.py:imsave``)."""
    from scipy import io
    from wire_tpu_torch.signals.image import imsave
    mat = io.loadmat(info_mat_path)
    for key in mat:
        if key.startswith("__"):
            continue
        img = mat[key][0, 0]["rec"]
        out = os.path.join(os.path.dirname(info_mat_path), "Output_img.png")
        arr = np.clip(np.abs(img), 0, 1)
        if arr.ndim == 2:
            imsave(out, arr, vmin=0.0, vmax=1.0, cmap="gray")
        else:
            imsave(out, arr, vmin=0.0, vmax=1.0)


def _key(path):
    return "/".join(str(k) for k in path)


def save_params(path, params):
    """A flat .npz of a parameter tree, one array per leaf under its tree
    path joined by '/' (wire_tpu's keys: a file of either package loads in
    the other)."""
    np.savez(path, **{_key(p): np.asarray(v.detach().cpu().numpy()
                                          if hasattr(v, "detach") else v)
                      for p, v in tree.leaves(params)})


def load_params(path, like, device="cpu"):
    """The parameters of a ``save_params`` file in the structure of
    ``like``, as float32 tensors on ``device``."""
    import torch
    with np.load(path) as data:
        flat = tree.leaves(like)
        values = [torch.tensor(np.asarray(data[_key(p)], np.float32)
                               .reshape(tuple(v.shape)), device=device)
                  for p, v in flat]
    return tree.unflatten([p for p, _ in flat], values)
