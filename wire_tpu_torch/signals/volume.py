"""Occupancy-volume utilities (port of wire_tpu/signals/volume.py:21-120):
the marching-cubes mesh of an occupancy volume with the optional
binarize-and-smooth step, the .mat volume loader with its bounding-box
crop, and the chunked IoU.  Host code (numpy, scipy and the native
marching cubes); the block point clouds, ``export_mesh_from_model`` and
the jitter are later slices."""
from __future__ import annotations

import numpy as np


def march_and_save(occupancy, mcubes_thres, savename, smoothen=False):
    """Mesh the ``mcubes_thres`` level set of ``occupancy`` and write it to
    ``savename`` (.obj or .dae); with ``smoothen`` the volume is first
    binarized at the threshold, shifted by -0.5, Gaussian-filtered (sigma
    1) and meshed at 0.  Returns (vertices, faces)."""
    from wire_tpu_torch import native
    occ = np.asarray(occupancy, np.float32)
    if smoothen:
        from scipy import ndimage
        binary = (occ >= mcubes_thres).astype(np.float32)
        occ = ndimage.gaussian_filter(binary - 0.5, sigma=1.0)
        mcubes_thres = 0.0
    verts, faces = native.marching_cubes(occ, mcubes_thres)
    native.export_mesh(verts, faces, savename)
    return verts, faces


def load_volume_mat(path, key="hypercube", scale=1.0, crop_occupancy=True):
    """A volume from a .mat file, normalized by its max, zoomed by
    ``scale`` (nearest) and cropped to the bounding box of its voxels above
    0.99."""
    from scipy import io, ndimage
    im = io.loadmat(path)[key].astype(np.float32)
    im = im / im.max()
    if scale != 1.0:
        im = ndimage.zoom(im, [scale, scale, scale], order=0)
    if crop_occupancy:
        im = bbox_crop(im)
    return im


def bbox_crop(vol, thresh=0.99):
    """The volume cut to [min, max) of the indices above ``thresh`` on
    each axis (the upper bound exclusive, as the reference cuts it)."""
    hidx, widx, tidx = np.where(vol > thresh)
    return vol[hidx.min():hidx.max(), widx.min():widx.max(),
               tidx.min():tidx.max()]


def iou_batched(preds, gt, thres=None, maxpoints=2 ** 24):
    """IoU of two volumes counted in chunks of ``maxpoints`` voxels,
    ``preds`` thresholded at ``thres`` when given; the inputs are not
    modified."""
    preds = np.asarray(preds).ravel()
    gt = np.asarray(gt).ravel()
    inter = 0
    union = 0
    for b in range(0, preds.size, maxpoints):
        p = preds[b:b + maxpoints]
        g = gt[b:b + maxpoints]
        if thres is not None:
            p = (p >= thres).astype(np.float32)
        inter += np.logical_and(p != 0, g != 0).sum()
        union += np.logical_or(p != 0, g != 0).sum()
    return inter / union
