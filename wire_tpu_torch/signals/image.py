"""Host-side image plumbing (port of wire_tpu/signals/image.py): the
normalization, cv2's INTER_AREA and INTER_LINEAR resizes, and the
procedural test images and occupancy volume.  numpy only (the GPU machine has no cv2): each
resize is cv2's own per-axis weight table applied separably as two small
matrices, so a 512^2 image at fx = 1/3 gives cv2's 171^2, not a box
average's 170^2."""
from __future__ import annotations

import math

import numpy as np


def normalize(x, fullnormalize=False):
    """Scale to [0, 1]: max-only by default, min-max if fullnormalize."""
    x = np.asarray(x)
    if x.sum() == 0:
        return x
    xmax = x.max()
    xmin = x.min() if fullnormalize else 0
    return (x - xmin) / (xmax - xmin)


def _dsize(ssize, f):
    """cv2's output size for a scale factor: the nearest integer."""
    return int(np.rint(ssize * f))


def _area_matrix(ssize, dsize, scale):
    """(dsize, ssize) weights of cv2's INTER_AREA downscale along one axis
    (computeResizeAreaTab): the overlap of [d s, (d + 1) s) with each source
    pixel, over the cell's width inside the image."""
    m = np.zeros((dsize, ssize))
    for dx in range(dsize):
        f1 = dx * scale
        f2 = f1 + scale
        cell = min(scale, ssize - f1)
        s2 = min(math.floor(f2), ssize - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            m[dx, s1 - 1] += (s1 - f1) / cell
        for sx in range(s1, s2):
            m[dx, sx] += 1.0 / cell
        if f2 - s2 > 1e-3:
            m[dx, s2] += min(min(f2 - s2, 1.0), cell) / cell
    return m


def _linear_matrix(ssize, dsize, scale):
    """(dsize, ssize) weights of cv2's INTER_LINEAR along one axis:
    half-pixel centres, source index and weight in float32 as cv2 computes
    them, edges clamped."""
    m = np.zeros((dsize, ssize))
    for dx in range(dsize):
        f = np.float32((dx + 0.5) * scale - 0.5)
        sx = int(np.floor(f))
        f = float(f - np.float32(sx))
        if sx < 0:
            f, sx = 0.0, 0
        if sx >= ssize - 1:
            f, sx = 0.0, ssize - 1
        m[dx, sx] += 1.0 - f
        if f > 0:
            m[dx, sx + 1] += f
    return m


def _separable(im, my, mx):
    """my @ im @ mx^T over the first two axes, in float64."""
    x = np.asarray(im, np.float64)
    H, W = x.shape[:2]
    rows = (my @ x.reshape(H, -1)).reshape(my.shape[0], W, -1)
    out = np.matmul(mx, rows)
    return out.reshape(my.shape[0], mx.shape[0],
                       *x.shape[2:]).astype(np.float32)


def resize_area(im, fx, fy=None):
    """cv2.resize(im, None, fx=fx, fy=fy, interpolation=INTER_AREA) for a
    downscale (fx, fy <= 1), at any ratio: the output is round(H fy) x
    round(W fx)."""
    fy = fx if fy is None else fy
    if fx > 1 or fy > 1:
        raise NotImplementedError("resize_area: INTER_AREA upscaling is not "
                                  "ported (the apps only downscale)")
    H, W = im.shape[:2]
    sy, sx = 1.0 / fy, 1.0 / fx
    if sy == int(sy) and sx == int(sx) and H % int(sy) == W % int(sx) == 0:
        # whole cells: the box average, as wire_tpu's fallback computes it
        sy, sx = int(sy), int(sx)
        return im.reshape(H // sy, sy, W // sx, sx, *im.shape[2:]).mean(
            (1, 3))
    return _separable(im, _area_matrix(H, _dsize(H, fy), sy),
                      _area_matrix(W, _dsize(W, fx), sx))


def resize_linear(im, fx, fy=None):
    """cv2.resize(im, None, fx=fx, fy=fy, interpolation=INTER_LINEAR)."""
    fy = fx if fy is None else fy
    H, W = im.shape[:2]
    return _separable(im, _linear_matrix(H, _dsize(H, fy), 1.0 / fy),
                      _linear_matrix(W, _dsize(W, fx), 1.0 / fx))


def synthetic_image(H=256, W=256, channels=3, seed=0):
    """A smooth + textured multi-frequency test image in [0, 1]."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    y, x = y / H, x / W
    chans = []
    for c in range(channels):
        img = 0.5 + 0.25 * np.sin(2 * np.pi * (3 + c) * x) * np.cos(
            2 * np.pi * (2 + c) * y)
        img += 0.15 * np.sin(2 * np.pi * (17 + 5 * c) * (x + y))
        img += 0.1 * np.cos(2 * np.pi * 31 * (x - 0.3 * y + 0.1 * c))
        blobs = np.zeros_like(img)
        for _ in range(6):
            cx, cy = rng.uniform(0.2, 0.8, 2)
            s = rng.uniform(0.02, 0.12)
            blobs += rng.uniform(-0.3, 0.3) * np.exp(
                -((x - cx) ** 2 + (y - cy) ** 2) / (2 * s * s))
        img = img + blobs
        chans.append(img)
    im = np.stack(chans, axis=-1)
    return normalize(im.astype(np.float32), True)


def natural_image(H=512, W=512, channels=3, seed=0, beta=1.2):
    """Random image with a natural-image (1/f^beta) amplitude spectrum and a
    few sharp-edged regions: the denoise app's default input."""
    rng = np.random.default_rng(seed)
    fy = np.fft.fftfreq(H)[:, None]
    fx = np.fft.fftfreq(W)[None, :]
    radius = np.sqrt(fy * fy + fx * fx)
    amp = 1.0 / np.maximum(radius, 1.0 / max(H, W)) ** beta
    chans = []
    base_phase = np.exp(2j * np.pi * rng.random((H, W)))
    for c in range(channels):
        phase = base_phase * np.exp(0.35j * 2 * np.pi * rng.random((H, W)))
        img = np.real(np.fft.ifft2(amp * phase))
        chans.append(img)
    im = np.stack(chans, axis=-1).astype(np.float32)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    for _ in range(4):
        cx, cy = rng.uniform(0.2, 0.8, 2)
        r = rng.uniform(0.08, 0.25)
        m = (((x / W - cx) ** 2 + (y / H - cy) ** 2) < r * r)
        im[m] += rng.uniform(-0.25, 0.25, channels).astype(np.float32)
    return normalize(im, True)


def synthetic_volume(N=64, seed=0):
    """A blobby occupancy volume in {0, 1}: five Gaussian blobs with
    centres and widths drawn from ``seed``, thresholded at 0.6
    (wire_tpu/signals/image.py:182)."""
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[-1:1:N * 1j, -1:1:N * 1j, -1:1:N * 1j].astype(
        np.float32)
    f = np.zeros((N, N, N), np.float32)
    for _ in range(5):
        cx, cy, cz = rng.uniform(-0.5, 0.5, 3)
        s = rng.uniform(0.15, 0.4)
        f += np.exp(-((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2)
                    / (2 * s * s))
    return (f > 0.6).astype(np.float32)
