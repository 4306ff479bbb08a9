"""Occupancy-volume utilities (port of wire_tpu/signals/volume.py): the
marching-cubes mesh of an occupancy volume with the optional
binarize-and-smooth step, ``export_mesh_from_model`` (a model probed over
a cube on the device, then meshed), the block point clouds
(``BlockPointCloud``, ``block_query_coords``, ``block_partition`` and its
helpers) with the device-side ``refill``, the .mat volume loader with its
bounding-box crop, the jitter, the chunked IoU, the occupancy scatter and
the cuboid faces for 3-D plots.  Host code (numpy, scipy and the native
marching cubes) but for the probe and ``refill``, which run on torch
tensors."""
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


def _grid3d_rows(lo, hi, cube_res, device):
    """Rows [lo, hi) of ``signals/coords.py:grid3d(cube_res, cube_res,
    cube_res)`` built on ``device``: row (h R + w) R + t is (x_w, y_h,
    z_t) of one float32 linspace over [-1, 1]."""
    import torch
    lin = torch.as_tensor(np.linspace(-1, 1, cube_res, dtype=np.float32),
                          device=device)
    idx = torch.arange(lo, hi, device=device)
    t = idx % cube_res
    w = (idx // cube_res) % cube_res
    h = idx // (cube_res * cube_res)
    return torch.stack([lin[w], lin[h], lin[t]], dim=-1)


def _probe_cube(model, params, cube_res, batchsize, sigmoid, device):
    """``model`` over the ``cube_res``^3 grid of ``grid3d`` in batches of
    ``batchsize`` points without a gradient, the points made on the device
    and each batch's outputs alone copied back: the (cube_res,)^3 float32
    cube, through a sigmoid if ``sigmoid``."""
    import torch
    npts = cube_res ** 3
    occ = np.zeros((npts,), np.float32)
    with torch.no_grad():
        for b in range(0, npts, batchsize):
            hi = min(b + batchsize, npts)
            out = model.apply(params, _grid3d_rows(b, hi, cube_res, device))
            if sigmoid:
                out = torch.sigmoid(out)
            occ[b:hi] = out.reshape(-1).cpu().numpy()
    return occ.reshape(cube_res, cube_res, cube_res)


def export_mesh_from_model(model, params, cube_res, batchsize, savename,
                           thres=0.005, sigmoid=True, device=None):
    """Probe ``model`` (an INR with ``params`` on ``device``, the card
    unless a CPU device is given) over the ``cube_res``^3 grid of
    ``grid3d`` in batches of ``batchsize`` points without a gradient (WIRE
    through its forward kernel alone), take the sigmoid of the outputs if
    ``sigmoid``, and mesh the ``thres`` level set (``march_and_save``,
    no smoothing) to ``savename``.  The points are made on the device and
    each batch's occupancies alone come back to the host.  Returns the
    occupancy cube (cube_res, cube_res, cube_res) float32."""
    from wire_tpu_torch.device import resolve
    occ = _probe_cube(model, params, cube_res, batchsize, sigmoid,
                      resolve(device))
    march_and_save(occ, thres, savename)
    return occ


def block_partition(points, npoints_per_block):
    """Fold (N, d) points into (nblocks, npoints_per_block, d), the tail
    padded by repeating the last point; returns (blocks, N)."""
    pts = np.asarray(points)
    n = pts.shape[0]
    nblocks = (n + npoints_per_block - 1) // npoints_per_block
    pad = nblocks * npoints_per_block - n
    if pad:
        pts = np.concatenate([pts, np.repeat(pts[-1:], pad, 0)], 0)
    return pts.reshape(nblocks, npoints_per_block, pts.shape[-1]), n


def unfold_blocks(blocks, true_n):
    """The inverse of ``block_partition``: (nblocks, npts, d) -> (true_n,
    d)."""
    flat = np.asarray(blocks).reshape(-1, blocks.shape[-1])
    return flat[:true_n]


def downsample_blocks(blocks, factor):
    """Every ``factor``-th point of each block."""
    return np.asarray(blocks)[:, ::factor, :]


def get_query_coords(minlim, maxlim, cube_res, npoints_per_block):
    """The regular ``cube_res``^3 query grid over [minlim, maxlim] (an
    'xy' meshgrid, float32) folded by ``block_partition``."""
    return block_partition(_query_grid(minlim, maxlim, cube_res),
                           npoints_per_block)


def _query_grid(minlim, maxlim, cube_res):
    x = np.linspace(minlim[0], maxlim[0], cube_res)
    y = np.linspace(minlim[1], maxlim[1], cube_res)
    z = np.linspace(minlim[2], maxlim[2], cube_res)
    X, Y, Z = np.meshgrid(x, y, z)
    return np.stack([X.ravel(), Y.ravel(), Z.ravel()],
                    axis=-1).astype(np.float32)


def occupancy_cube_from_coords(coords, preds, sidelength, cube_res,
                               display_occupancy=None):
    """Scatter ``preds`` into a (cube_res,)^3 cube at the voxels of
    ``coords`` in [-1, 1] (floor((c + 1) / 2 sidelength), clipped); the
    rest is -1.  ``display_occupancy``, when given, is filled in place."""
    coords = np.asarray(coords).reshape(-1, 3)
    voxel_idx = np.floor((coords + 1.0) / 2.0 * sidelength).astype(np.int32)
    voxel_idx = np.clip(voxel_idx, 0, cube_res - 1)
    if display_occupancy is None:
        display_occupancy = -np.ones((cube_res, cube_res, cube_res),
                                     np.float32)
    else:
        display_occupancy[...] = -1
    p = np.asarray(preds).reshape(-1)
    display_occupancy[voxel_idx[:, 0], voxel_idx[:, 1], voxel_idx[:, 2]] = p
    return display_occupancy


class BlockPointCloud:
    """A point cloud bucketed into 2^depth cells per axis of its bounding
    box, in one stable argsort by the flat cell index x nb^2 + y nb + z.

    ``sdf`` (N, 1) rides along (default 1); a cell is occupied when it
    holds a point.  ``fill`` folds the cloud into (ncells, maxpoints, 3)
    with every cell padded by uniform points inside it (sdf 0), ``refill``
    redraws those padding points on the device, ``unfold`` reassembles
    per-cell value grids into a cube, ``downsample`` collapses cells to
    their centroids and re-buckets one level up."""

    def __init__(self, xyz, sdf=None, depth=4):
        xyz = np.asarray(xyz, np.float32)
        self.xyz = xyz
        self.depth = int(depth)
        self.sdf = (np.ones((xyz.shape[0], 1), np.float32) if sdf is None
                    else np.asarray(sdf, np.float32).reshape(-1, 1))
        self.minvals = xyz.min(0)
        self.maxvals = xyz.max(0) + 1e-6
        self._build()

    def _build(self):
        nb = 2 ** self.depth
        self.nblocks = nb
        delta = (self.maxvals - self.minvals) / nb
        self.delta = delta
        cell = np.floor((self.xyz - self.minvals) / delta).astype(np.int64)
        cell = np.clip(cell, 0, nb - 1)
        flat = (cell[:, 0] * nb + cell[:, 1]) * nb + cell[:, 2]
        order = np.argsort(flat, kind="stable")
        self._order = order
        self._sorted_xyz = self.xyz[order]
        self._sorted_sdf = self.sdf[order]
        self.counts = np.bincount(flat, minlength=nb ** 3)
        self._starts = np.concatenate([[0], np.cumsum(self.counts)[:-1]])
        self.occupied = self.counts > 0
        idx = np.arange(nb ** 3)
        all_idx = np.stack([idx // (nb * nb), (idx // nb) % nb, idx % nb],
                           axis=-1)
        self.minlim = (all_idx * delta + self.minvals).astype(np.float32)
        self.maxlim = ((all_idx + 1) * delta + self.minvals).astype(
            np.float32)

    def maxpoints(self):
        return int(self.counts.max())

    def minpoints(self, occupied_only=False):
        c = self.counts[self.occupied] if occupied_only else self.counts
        return int(c.min()) if c.size else 0

    def nchunks(self, occupied_only=True):
        return int(self.occupied.sum()) if occupied_only else self.nblocks ** 3

    def flatten(self):
        """Every point, in cell order."""
        return self._sorted_xyz.copy()

    def fill(self, rng=None, occupied_only=False):
        """(ncells, maxpoints, 3) points and (ncells, maxpoints, 1) sdf: each
        cell's own points first, then uniform points inside the cell
        (``rng``, a np.random.RandomState, the global one by default) with
        sdf 0; only the occupied cells with ``occupied_only``."""
        rng = np.random if rng is None else rng
        mp = self.maxpoints()
        nc = self.nblocks ** 3
        xyz = rng.rand(nc, mp, 3).astype(np.float32)
        xyz = self.minlim[:, None, :] + self.delta[None, None, :] * xyz
        sdf = np.zeros((nc, mp, 1), np.float32)
        slot = np.arange(mp)[None, :]
        has = slot < self.counts[:, None]
        src = np.clip(self._starts[:, None] + slot, 0,
                      max(len(self._sorted_xyz) - 1, 0))
        if len(self._sorted_xyz):
            xyz[has] = self._sorted_xyz[src[has]]
            sdf[has] = self._sorted_sdf[src[has]]
        if occupied_only:
            return xyz[self.occupied], sdf[self.occupied]
        return xyz, sdf

    def fold(self, occupied_only=False):
        """``fill`` where every folded cell holds the same number of points
        (a uniform grid does); raises ValueError otherwise."""
        counts = self.counts[self.occupied] if occupied_only else self.counts
        if counts.size and (counts != counts[0]).any():
            raise ValueError(
                "fold() needs uniform per-cell counts; use fill()")
        return self.fill(occupied_only=occupied_only)

    def refill(self, folded_xyz, folded_sdf, generator=None):
        """The folded points with every point of sdf 0 redrawn uniformly
        inside its cell, on the tensors' own device, the uniforms drawn
        from ``generator`` (a torch.Generator on that device)."""
        import torch
        u = torch.rand(folded_xyz.shape, generator=generator,
                       device=folded_xyz.device, dtype=folded_xyz.dtype)
        return self._refill(folded_xyz, folded_sdf, u)

    def _refill(self, folded_xyz, folded_sdf, u):
        """``refill`` on given uniforms ``u`` of the folded shape."""
        import torch
        kw = dict(device=folded_xyz.device, dtype=folded_xyz.dtype)
        newpts = (torch.as_tensor(self.minlim, **kw)[:, None, :]
                  + torch.as_tensor(self.delta, **kw)[None, None, :] * u)
        return folded_sdf * folded_xyz + (1.0 - folded_sdf) * newpts

    def unfold(self, sdfs, cubesize):
        """Per-cell value grids (ncells, (cubesize / nb)^3) reassembled into a
        (cubesize,)^3 cube in the order of the query grid that
        ``block_query_coords`` folded (cell blocks, then the meshgrid's
        'xy' transposes)."""
        nb = self.nblocks
        bs = cubesize // nb
        blocks = np.asarray(sdfs).reshape(nb, nb, nb, bs, bs, bs)
        blocks = np.transpose(blocks, (0, 1, 2, 4, 3, 5))
        cube = np.transpose(blocks, (0, 3, 1, 4, 2, 5)).reshape(
            cubesize, cubesize, cubesize)
        return np.transpose(cube, (1, 0, 2))

    def downsample(self, ndepths=1, targetdepth=None):
        """A new cloud: ``ndepths`` times each occupied cell collapsed to its
        centroid and the centroids re-bucketed one level up, then bucketed
        at ``targetdepth`` when given."""
        if ndepths == 0 and targetdepth is None:
            return self
        pts = self.xyz
        depth = self.depth
        for _ in range(ndepths):
            bpc = BlockPointCloud(pts, depth=depth)
            sums = np.zeros((bpc.nblocks ** 3, 3), np.float64)
            nb = bpc.nblocks
            cell = np.clip(np.floor((pts - bpc.minvals) / bpc.delta), 0,
                           nb - 1).astype(np.int64)
            flat = (cell[:, 0] * nb + cell[:, 1]) * nb + cell[:, 2]
            np.add.at(sums, flat, pts)
            occ = bpc.counts > 0
            pts = (sums[occ] / bpc.counts[occ][:, None]).astype(np.float32)
            depth -= 1
        return BlockPointCloud(
            pts, depth=depth if targetdepth is None else targetdepth)


def block_query_coords(minlim, maxlim, cube_res, depth):
    """The query grid of ``get_query_coords`` bucketed at 2^depth cells per
    axis: (folded chunks (ncells, (cube_res / 2^depth)^3, 3), the
    ``BlockPointCloud`` whose ``unfold`` reassembles their values)."""
    ds = BlockPointCloud(_query_grid(minlim, maxlim, cube_res), depth=depth)
    chunks, _ = ds.fold()
    return chunks, ds


def jitter_volume(volume, max_shift, rng=None):
    """A binary volume resampled (nearest) at its grid positions moved by
    uniform offsets of up to ``max_shift`` voxels per axis (clipped to
    [-1, 1]), transposed to the meshgrid's 'xy' order and re-binarized at
    0.5; ``rng`` a np.random.RandomState (the global one by default)."""
    from scipy.interpolate import RegularGridInterpolator as rgi
    rng = np.random if rng is None else rng
    H, W, T = volume.shape
    x = np.linspace(-1, 1, H)
    y = np.linspace(-1, 1, W)
    z = np.linspace(-1, 1, T)
    X, Y, Z = np.meshgrid(x, y, z)
    Xn = np.clip(X + (2 * rng.rand(H, W, T) - 1) * max_shift / H, -1, 1)
    Yn = np.clip(Y + (2 * rng.rand(H, W, T) - 1) * max_shift / W, -1, 1)
    Zn = np.clip(Z + (2 * rng.rand(H, W, T) - 1) * max_shift / T, -1, 1)
    func = rgi((x, y, z), volume, method="nearest")
    coords = np.stack([Xn.ravel(), Yn.ravel(), Zn.ravel()], axis=-1)
    noisy = func(coords).reshape(H, W, T).astype(np.float32)
    noisy = np.transpose(noisy, [1, 0, 2])
    return (noisy > 0.5).astype(np.float32)


def cuboid_data(origin, size=(1, 1, 1)):
    """(X, Y, Z), each (4, 5): the four side faces of an axis-aligned
    cuboid at ``origin`` (each edge 0.01 short), as surface meshes for a
    3-D plot."""
    o = origin
    l, w, h = size
    eps = 0.01
    l, w, h = l - eps, w - eps, h - eps
    x = [[o[0], o[0] + l, o[0] + l, o[0], o[0]]] * 4
    y = [[o[1], o[1], o[1] + w, o[1] + w, o[1]],
         [o[1], o[1], o[1] + w, o[1] + w, o[1]],
         [o[1], o[1], o[1], o[1], o[1]],
         [o[1] + w, o[1] + w, o[1] + w, o[1] + w, o[1] + w]]
    z = [[o[2]] * 5,
         [o[2] + h] * 5,
         [o[2], o[2], o[2] + h, o[2] + h, o[2]],
         [o[2], o[2], o[2] + h, o[2] + h, o[2]]]
    return np.array(x), np.array(y), np.array(z)


def plot_cube_at(pos=(0, 0, 0), size=(1, 1, 1), color="b", edgecolor="k",
                 alpha=1.0, ax=None, **kwargs):
    """Draw one cuboid on the caller's 3-D axis ``ax`` (its
    ``plot_surface``); nothing without one."""
    if ax is None:
        return
    X, Y, Z = cuboid_data(pos, size)
    ax.plot_surface(X, Y, Z, color=color, rstride=1, cstride=1, alpha=alpha,
                    edgecolors=edgecolor, linewidth=0.1, **kwargs)


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
