"""The apps' inputs worked out again from a fit's seed: the procedural
natural-statistics stand-in image, its area halving in cv2's float32
order, the photon + readout noise on numpy's RandomState stream, the
coordinate grid (frozen copies of the arithmetic of
``signals/image.py:natural_image``, ``normalize``, ``_area_fast``,
``signals/noise.py:measure_np`` and ``signals/coords.py:grid2d``)."""
from __future__ import annotations

import numpy as np


def normalize(x, full=False):
    x = np.asarray(x)
    if x.sum() == 0:
        return x
    lo = x.min() if full else 0
    return (x - lo) / (x.max() - lo)


def natural_image(H, W, channels, seed, beta=1.2):
    """A random image with a 1/f^beta amplitude spectrum and four
    sharp-edged discs, min-max normalized, (H, W, channels) float32."""
    rng = np.random.default_rng(seed)
    fy = np.fft.fftfreq(H)[:, None]
    fx = np.fft.fftfreq(W)[None, :]
    amp = 1.0 / np.maximum(np.sqrt(fy * fy + fx * fx), 1.0 / max(H, W)) ** beta
    base = np.exp(2j * np.pi * rng.random((H, W)))
    chans = [np.real(np.fft.ifft2(amp * (base * np.exp(
        0.35j * 2 * np.pi * rng.random((H, W)))))) for _ in range(channels)]
    im = np.stack(chans, axis=-1).astype(np.float32)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    for _ in range(4):
        cx, cy = rng.uniform(0.2, 0.8, 2)
        r = rng.uniform(0.08, 0.25)
        disc = ((x / W - cx) ** 2 + (y / H - cy) ** 2) < r * r
        im[disc] += rng.uniform(-0.25, 0.25, channels).astype(np.float32)
    return normalize(im, True)


def area_half(im):
    """cv2.resize(im, fx=0.5, fy=0.5, INTER_AREA) for even sizes: each 2 x 2
    cell summed in cv2's order ((a + b) + (c + d) for one channel, else
    ((a + b) + c) + d), times 0.25, in float32."""
    im = np.asarray(im, np.float32)
    a, b, c, d = im[0::2, 0::2], im[0::2, 1::2], im[1::2, 0::2], im[1::2, 1::2]
    acc = (a + b) + (c + d) if im.ndim == 2 else ((a + b) + c) + d
    return (acc * np.float32(0.25)).astype(np.float32)


def noisy(x, snr, tau, seed):
    """Poisson photons at integration time tau, signed by the intensity's
    sign, plus Gaussian readout noise of sigma ``snr`` electrons, over tau;
    the draws of numpy's RandomState(seed) in the apps' order."""
    rng = np.random.RandomState(seed)
    x = np.asarray(x)
    readout = rng.randn(x.size).reshape(x.shape) * snr
    xm = x * tau
    photons = np.empty_like(xm)
    pos = x > 0
    photons[pos] = rng.poisson(xm[pos])
    photons[~pos] = -rng.poisson(-xm[~pos])
    return ((photons + readout) / tau).astype(np.float32)


def grid2d(H, W):
    """(H W, 2) coordinates in [-1, 1], x fastest, float32."""
    X, Y = np.meshgrid(np.linspace(-1, 1, W, dtype=np.float32),
                       np.linspace(-1, 1, H, dtype=np.float32))
    return np.stack([X.ravel(), Y.ravel()], axis=-1)


def denoise_images(seed, traffic):
    """(clean, noisy) of the denoise protocol: the stand-in, halved, and its
    noised copy."""
    s = traffic["image_size"]
    im = area_half(natural_image(s, s, 3, seed))
    return im, noisy(im, traffic["noise_snr"], traffic["tau"], seed)


def ct_image(seed, traffic):
    """The CT protocol's field: one channel of the stand-in, min-max
    normalized, halved."""
    s = traffic["image_size"]
    img = normalize(natural_image(s, s, 1, seed)[..., 0], True)
    return area_half(img)
