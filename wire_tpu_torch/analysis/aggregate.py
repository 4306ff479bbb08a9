"""Cross-run aggregation (port of wire_tpu/analysis/aggregate.py): the
metrics.mat files of a set of run folders in one markdown table,
Agg_results.md, and a montage of their reconstructions, Output_img.png;
written by the port's markdown table (``train/artifacts.py``) and PNG
writer (``signals/image.py:imsave``), no pandas or matplotlib.

    python -m wire_tpu_torch.analysis.aggregate --root results/denoise/T30.0_SNR2
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from wire_tpu_torch.signals.image import build_montage, imsave
from wire_tpu_torch.train.artifacts import markdown_table


def collect_runs(root):
    """{folder name: folder} of the run folders (those holding a
    metrics.mat) directly under ``root``, in sorted order."""
    runs = {}
    for m in sorted(glob.glob(os.path.join(root, "*", "metrics.mat"))):
        runs[os.path.basename(os.path.dirname(m))] = os.path.dirname(m)
    return runs


def aggregate(runs, out_dir):
    """runs: {label: folder}.  Writes ``out_dir``/Agg_results.md (a row a
    run, a column a metric: a value, or a list where the metric has
    several) and, where the runs' info.mat hold a ``rec``,
    ``out_dir``/Output_img.png: the reconstructions (channel means of RGB
    ones) cropped to the smallest, min-max normalized tile by tile, in the
    gray colour map scaled to the montage's range.  Returns the rows."""
    from scipy import io
    os.makedirs(out_dir, exist_ok=True)
    rows = {}
    recs = []
    for label, folder in runs.items():
        mat = io.loadmat(os.path.join(folder, "metrics.mat"))
        names = [k for k in mat if not k.startswith("__")]
        vals = mat[names[0]][0, 0]
        row = {}
        for key in vals.dtype.names:
            v = np.asarray(vals[key])
            row[key] = v.ravel()[0] if v.size == 1 else v.ravel().tolist()
        rows[label] = row
        ipath = os.path.join(folder, "info.mat")
        if os.path.exists(ipath):
            imat = io.loadmat(ipath)
            inames = [k for k in imat if not k.startswith("__")]
            recs.append(np.asarray(imat[inames[0]][0, 0]["rec"]))
    keys = []
    for row in rows.values():
        keys += [k for k in row if k not in keys]
    with open(os.path.join(out_dir, "Agg_results.md"), "w") as f:
        f.write(markdown_table(rows, keys))
    if recs:
        gray = [r.mean(-1) if r.ndim == 3 else r for r in recs]
        H = min(g.shape[0] for g in gray)
        W = min(g.shape[1] for g in gray)
        montage = build_montage(np.stack([g[:H, :W] for g in gray]))
        imsave(os.path.join(out_dir, "Output_img.png"),
               np.clip(montage, 0, 1), cmap="gray")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True,
                   help="directory whose subfolders are runs")
    p.add_argument("--out", default=None,
                   help="output directory (default: --root)")
    a = p.parse_args(argv)
    aggregate(collect_runs(a.root), a.out or a.root)


if __name__ == "__main__":
    main()
