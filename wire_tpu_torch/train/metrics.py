"""Quality metrics (port of wire_tpu/train/metrics.py), on the host.

PSNR reproduces the reference's nonstandard formula ``10*log10(max(x)/MSE)``
(psnr_ref); ``mse_db`` is -10 log10(MSE).  SSIM follows skimage's
structural_similarity defaults (7x7 uniform window, K1=0.01, K2=0.03,
unbiased covariance, win//2 border crop, channel mean), computed in float64
because E[x^2]-mu^2 cancels in float32 on smooth images.  MS-SSIM follows
pytorch_msssim's defaults (11-tap Gaussian, sigma 1.5, valid filtering, 5
scales with the standard weights, 2x2 average pooling between them).
"""
from __future__ import annotations

import numpy as np


def psnr_ref(x, xhat):
    """10*log10(max(x) / mean((x - xhat)^2))."""
    x = np.asarray(x)
    xhat = np.asarray(xhat)
    mse = np.mean((x - xhat) ** 2)
    return float(10.0 * np.log10(np.max(x) / mse))


def mse_db(mse):
    """-10*log10(MSE), the scripts' inline 'PSNR' / 'Best MSE'."""
    return float(-10.0 * np.log10(mse))


def _uniform_filter(img, size):
    pad = size // 2
    k = np.ones((size,), np.float64) / size
    out = img
    for axis in range(img.ndim):
        out = np.apply_along_axis(
            lambda v: np.convolve(v, k, mode="same"), axis, out)
    return out, pad


def _ssim_single(x, y, data_range, win_size):
    K1, K2 = 0.01, 0.03
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    NP = win_size ** x.ndim
    cov_norm = NP / (NP - 1.0)
    ux, pad = _uniform_filter(x, win_size)
    uy, _ = _uniform_filter(y, win_size)
    uxx, _ = _uniform_filter(x * x, win_size)
    uyy, _ = _uniform_filter(y * y, win_size)
    uxy, _ = _uniform_filter(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    A1 = 2 * ux * uy + C1
    A2 = 2 * vxy + C2
    B1 = ux * ux + uy * uy + C1
    B2 = vx + vy + C2
    S = (A1 * A2) / (B1 * B2)
    sl = tuple(slice(pad, s - pad) for s in S.shape)
    return float(np.mean(S[sl]))


def ssim(x, y, data_range=1.0, win_size=7):
    """SSIM of 2D arrays, or 3D with the last axis as channels (channel
    mean)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if x.ndim == 2:
        return _ssim_single(x, y, data_range, win_size)
    return float(np.mean([_ssim_single(x[..., c], y[..., c], data_range,
                                       win_size)
                          for c in range(x.shape[-1])]))


def _gaussian_kernel1d(size=11, sigma=1.5):
    half = (size - 1) / 2.0
    coords = np.arange(size, dtype=np.float64) - half
    g = np.exp(-(coords ** 2) / (2 * sigma * sigma))
    return g / np.sum(g)


def _gauss_filter(img, k):
    """Separable valid-mode Gaussian filter over the last two axes."""
    n = len(k)
    H, W = img.shape[-2:]
    out = sum(k[i] * img[..., i:H - n + 1 + i, :] for i in range(n))
    return sum(k[i] * out[..., i:W - n + 1 + i] for i in range(n))


def _ssim_gauss(x, y, data_range, k):
    K1, K2 = 0.01, 0.03
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    mx = _gauss_filter(x, k)
    my = _gauss_filter(y, k)
    # centred second moments, as wire_tpu's _ssim_gauss
    cx, cy = np.mean(x), np.mean(y)
    xs, ys = x - cx, y - cy
    mxs, mys = mx - cx, my - cy
    vx = _gauss_filter(xs * xs, k) - mxs * mxs
    vy = _gauss_filter(ys * ys, k) - mys * mys
    vxy = _gauss_filter(xs * ys, k) - mxs * mys
    cs = (2 * vxy + C2) / (vx + vy + C2)
    ssim_map = ((2 * mx * my + C1) / (mx * mx + my * my + C1)) * cs
    return np.mean(ssim_map), np.mean(cs)


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _to_chw(x):
    x = np.asarray(x, np.float64)
    return x[None] if x.ndim == 2 else np.moveaxis(x, -1, 0)


def _pool2(x):
    """2 x 2 average pooling, an odd edge zero-padded (and divided by 4)."""
    C, H, W = x.shape
    x = np.pad(x, ((0, 0), (0, H % 2), (0, W % 2)))
    return x.reshape(C, (H + 1) // 2, 2, (W + 1) // 2, 2).sum((2, 4)) / 4.0


def ms_ssim(x, y, data_range=1.0, win_size=11, sigma=1.5,
            weights=_MSSSIM_WEIGHTS):
    """Multi-scale SSIM of (H, W) or (H, W, C) images (pytorch_msssim
    defaults, wire_tpu/train/metrics.py:128-207)."""
    x3, y3 = _to_chw(x), _to_chw(y)
    k = _gaussian_kernel1d(win_size, sigma)
    mcs = []
    for i in range(len(weights)):
        s, cs = _ssim_gauss(x3, y3, data_range, k)
        if i < len(weights) - 1:
            mcs.append(max(cs, 0.0))
            x3, y3 = _pool2(x3), _pool2(y3)
    vals = np.asarray(mcs + [max(s, 0.0)])
    return float(np.prod(vals ** np.asarray(weights)))
