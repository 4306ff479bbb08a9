"""Coordinate grids in [-1, 1] (port of wire_tpu/signals/coords.py:19-138):
the 2-D and 3-D grids, rows of the 3-D grid by flat index, the implicit
grid ``GridSpec`` whose rows are computed on the device, and ``jgrid2d``,
the 2-D grid made on a device."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def grid2d(H, W, dtype=np.float32):
    """(H*W, 2) coords, x fastest: ``meshgrid(linspace(W), linspace(H))``
    with 'xy' indexing, flattened row-major and stacked (x, y)."""
    x = np.linspace(-1, 1, W, dtype=dtype)
    y = np.linspace(-1, 1, H, dtype=dtype)
    X, Y = np.meshgrid(x, y)
    return np.stack([X.ravel(), Y.ravel()], axis=-1)


def grid3d(H, W, T, dtype=np.float32):
    """(H*W*T, 3) coords: ``meshgrid(linspace(W), linspace(H),
    linspace(T))`` with 'xy' indexing, shape (H, W, T), so x samples the W
    axis and y the H axis."""
    x = np.linspace(-1, 1, W, dtype=dtype)
    y = np.linspace(-1, 1, H, dtype=dtype)
    z = np.linspace(-1, 1, T, dtype=dtype)
    X, Y, Z = np.meshgrid(x, y, z)
    return np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)


def get_coords(H, W, T=None, dtype=np.float32):
    """The 2-D grid, or the 3-D one when T is given."""
    if T is None:
        return grid2d(H, W, dtype)
    return grid3d(H, W, T, dtype)


def grid_rows(H, W, T, lo, hi, dtype=np.float32):
    """Rows [lo, hi) of ``grid3d(H, W, T)`` from their flat indices: n =
    i*(W*T) + j*T + k has coords (x_W[j], y_H[i], z_T[k])."""
    n = np.arange(lo, hi, dtype=np.int64)
    x = np.linspace(-1, 1, W, dtype=dtype)
    y = np.linspace(-1, 1, H, dtype=dtype)
    z = np.linspace(-1, 1, T, dtype=dtype)
    i = n // (W * T)
    j = (n // T) % W
    k = n % T
    return np.stack([x[j], y[i], z[k]], axis=-1)


def _axis(j, num):
    """linspace(-1, 1, num)[j] in float32 on j's device, endpoints exact; a
    size-1 axis is [-1.0], as np.linspace gives it."""
    if num == 1:
        return torch.full(j.shape, -1.0, dtype=torch.float32,
                          device=j.device)
    step = float(np.float32(2.0 / (num - 1)))
    v = -1.0 + j.to(torch.float32) * step
    return torch.where(j == num - 1, torch.ones_like(v), v)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """The (npoints, d) grid of ``get_coords`` described by its shape: the
    chunked trainer computes a chunk's rows on the device from the permuted
    flat indices (``rows``), so no (npoints, d) table is stored or
    gathered.  Rows equal ``get_coords``'s to float32 rounding: linspace
    computes in float64 and rounds once, ``rows`` in float32, so an
    interior value may differ by an ulp or two of 1.0."""
    H: int
    W: int
    T: int | None = None

    @property
    def npoints(self):
        return self.H * self.W * (self.T or 1)

    @property
    def in_features(self):
        return 2 if self.T is None else 3

    @property
    def shape(self):
        return (self.npoints, self.in_features)

    def rows(self, idx):
        """(n,) int64 tensor of flat indices -> (n, d) float32 rows on its
        device."""
        if self.T is None:
            r = idx // self.W
            c = idx % self.W
            return torch.stack([_axis(c, self.W), _axis(r, self.H)], dim=-1)
        W, T = self.W, self.T
        i = idx // (W * T)
        j = (idx // T) % W
        k = idx % T
        return torch.stack([_axis(j, W), _axis(i, self.H), _axis(k, T)],
                           dim=-1)

    def materialize(self):
        """The full host array (= get_coords(H, W, T))."""
        return get_coords(self.H, self.W, self.T)


def jgrid2d(H, W, device="cpu", dtype=torch.float32):
    """The (H*W, 2) grid of ``grid2d`` made on ``device`` by torch
    (wire_tpu/signals/coords.py:133): torch.linspace rounds an interior
    value to within an ulp or two of numpy's."""
    x = torch.linspace(-1, 1, W, dtype=dtype, device=device)
    y = torch.linspace(-1, 1, H, dtype=dtype, device=device)
    Y, X = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([X.reshape(-1), Y.reshape(-1)], dim=-1)
