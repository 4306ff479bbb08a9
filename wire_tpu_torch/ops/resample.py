"""Differentiable bilinear resampling, image rotation and box averages
(port of wire_tpu/ops/resample.py:17-103).

The rotation follows the kornia/OpenCV convention of the reference's Radon
operator: rotation by ``angle`` degrees about the pixel centre
((W-1)/2, (H-1)/2), positive = counter-clockwise on screen, bilinear,
zero padding.  Both functions are plain PyTorch (gathers and lerps), so
autograd differentiates them in the image and in the angle.
``sum(rotate(img, a), 0)`` is the plain version of the rotate-project
kernel (ops/rotsum.py).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


def bilinear_sample(img, xs, ys):
    """Sample ``img`` (H, W) or (H, W, C) at float pixel coords (xs, ys) of
    any matching shape, bilinear with zero padding outside."""
    H, W = img.shape[0], img.shape[1]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    wx = xs - x0
    wy = ys - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def tap(yi, xi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = img[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
        if img.ndim == 3:
            inb = inb[..., None]
        return torch.where(inb, v, torch.zeros((), dtype=v.dtype,
                                               device=v.device))

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    if img.ndim == 3:
        wx = wx[..., None]
        wy = wy[..., None]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def rotate(img, angle_degrees):
    """Rotate an (H, W[, C]) image by ``angle_degrees`` (a float or a
    0-d tensor) about the pixel centre, bilinear, zero padding."""
    H, W = img.shape[0], img.shape[1]
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    t = torch.as_tensor(angle_degrees, dtype=torch.float32,
                        device=img.device) * (math.pi / 180.0)
    cos, sin = torch.cos(t), torch.sin(t)
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=img.device) - cy,
        torch.arange(W, dtype=torch.float32, device=img.device) - cx,
        indexing="ij")
    # dst(x, y) = src(R^{-1}(x, y)); the y axis points down, so CCW on
    # screen is this matrix (getRotationMatrix2D + warpAffine)
    sx = cos * xs - sin * ys + cx
    sy = sin * xs + cos * ys + cy
    return bilinear_sample(img, sx, sy)


def rotate_stack(img, angles_degrees):
    """``rotate`` at each angle: (H, W[, C]) -> (nangles, H, W[, C])
    (wire_tpu/ops/resample.py:68)."""
    return torch.stack([rotate(img, a) for a in angles_tensor(
        angles_degrees, img.device)])


def grid_sample(img, grid, align_corners=True):
    """``torch.nn.functional.grid_sample`` of one image, written out as
    wire_tpu's: img (H, W[, C]), grid (..., 2) normalized (x, y) in
    [-1, 1]; bilinear, zero padding."""
    H, W = img.shape[0], img.shape[1]
    gx = grid[..., 0]
    gy = grid[..., 1]
    if align_corners:
        xs = (gx + 1) * (W - 1) / 2
        ys = (gy + 1) * (H - 1) / 2
    else:
        xs = ((gx + 1) * W - 1) / 2
        ys = ((gy + 1) * H - 1) / 2
    return bilinear_sample(img, xs, ys)


@functools.lru_cache(maxsize=64)
def _cached_angles(key, device):
    return torch.tensor(key, dtype=torch.float32, device=device)


def angles_tensor(angles_degrees, device):
    """Angles as a float32 tensor on ``device``.  A tensor passes through
    (autograd follows it); a sequence or numpy array is a constant, copied
    to the device once and cached, so a loop that reuses it makes no
    host-to-device copy (which would stall the host) per call."""
    if isinstance(angles_degrees, torch.Tensor):
        return angles_degrees.to(device, torch.float32)
    key = tuple(np.asarray(angles_degrees, np.float32).ravel().tolist())
    return _cached_angles(key, torch.device(device))


def avg_pool2d(img_nchw, k):
    """AvgPool2d(k) with stride k as an exact reshape-mean (wire_tpu/ops/
    resample.py:90-95); H and W must be divisible by k."""
    N, C, H, W = img_nchw.shape
    x = img_nchw.reshape(N, C, H // k, k, W // k, k)
    return x.mean(dim=(3, 5))


def area_downsample_hwc(img_hwc, k):
    """Box-average downsample of (H, W[, C]) by the integer factor k."""
    H, W = img_hwc.shape[0], img_hwc.shape[1]
    x = img_hwc.reshape(H // k, k, W // k, k, -1)
    return x.mean(dim=(1, 3)).reshape(H // k, W // k, *img_hwc.shape[2:])
