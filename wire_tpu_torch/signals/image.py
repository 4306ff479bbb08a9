"""Host-side image plumbing (port of wire_tpu/signals/image.py): PNG
reading (``imread``, through the port's own codec ``signals/png.py``), the
normalization, cv2's INTER_AREA and INTER_LINEAR resizes, the montage, the
inpainting masks, and the procedural test images, the Shepp-Logan phantom
and the occupancy volume.  numpy only (the GPU machine has no cv2,
matplotlib or Pillow): each resize is cv2's own per-axis weight table
applied separably as two small matrices, so a 512^2 image at fx = 1/3
gives cv2's 171^2, not a box average's 170^2."""
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


def imread(path, normalize_full=True):
    """A PNG file as float32 (wire_tpu/signals/image.py:30): the values
    ``plt.imread`` gives (``png.to_float``), the alpha channel of a
    four-channel image dropped, then min-max normalized to [0, 1] unless
    ``normalize_full`` is False.  Only PNG is read: any other file
    raises."""
    from wire_tpu_torch.signals import png
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != png.SIGNATURE:
        raise ValueError(f"imread: {path!r} is not a PNG file (the port "
                         f"reads PNG images and .npy arrays)")
    im = png.to_float(png.decode(data))
    if im.ndim == 3 and im.shape[-1] == 4:
        im = im[..., :3]
    return normalize(im, True) if normalize_full else im


def to_rgba(arr, cmap="viridis", vmin=None, vmax=None):
    """(H, W, 4) uint8 of an image as ``plt.imsave`` colours it: an (H, W)
    array normalized by ``vmin``/``vmax`` (each float64; default its min
    and max) and looked up in colour map ``cmap`` (``signals/colormaps.py``:
    x 256, truncated; 1.0 the last entry, below 0 the first, NaN
    transparent); an (H, W, 3) float array in [0, 1] taken as RGB and
    scaled by 255 with truncation in its own dtype (NaN pixels transparent
    black), opaque.  The colour map and limits do not touch an RGB array,
    as in matplotlib."""
    from wire_tpu_torch.signals import colormaps
    x = np.asarray(arr)
    if x.ndim == 3:
        if x.shape[2] != 3 or x.dtype.kind != "f":
            raise ValueError(f"to_rgba: an RGB image is (H, W, 3) floating "
                             f"point; got {x.shape} {x.dtype}")
        xx = np.empty(x.shape[:2] + (4,), x.dtype)
        xx[..., :3] = x
        xx[..., 3] = 1
        nans = np.isnan(x)
        if nans.any():
            xx[nans.any(axis=2), :] = 0
        if xx.max() > 1 or xx.min() < 0:
            raise ValueError("to_rgba: floating point RGB values must be in "
                             "the 0..1 range")
        return (xx * 255).astype(np.uint8)
    if x.ndim != 2:
        raise ValueError(f"to_rgba: expected a 2-D or 3-D array, got "
                         f"{x.shape}")
    dtype = x.dtype
    if dtype.kind in "biu":
        dtype = np.promote_types(dtype, np.float32)
    data = np.array(x, dtype=dtype, copy=True)
    lo = np.float64(data.min() if vmin is None else vmin)
    hi = np.float64(data.max() if vmax is None else vmax)
    if lo == hi:
        data.fill(0)
    elif lo > hi:
        raise ValueError("to_rgba: vmin must be less than or equal to vmax")
    else:
        data -= lo
        data /= (hi - lo)
    n = 256
    data *= n
    data[data == n] = n - 1
    under, over, bad = data < 0, data >= n, np.isnan(data)
    with np.errstate(invalid="ignore"):
        idx = data.astype(int)
    idx[under] = 0
    idx[over] = n - 1
    idx[bad] = 0
    lut = np.concatenate([colormaps.table(cmap),
                          np.full((n, 1), 255, np.uint8)], axis=1)
    rgba = lut[idx]
    rgba[bad] = 0
    return rgba


def imsave(path, arr, vmin=None, vmax=None, cmap="viridis"):
    """Write ``arr`` as an 8-bit RGBA PNG with the pixels ``plt.imsave``
    writes (``to_rgba``; matplotlib's default colour map is viridis),
    through the port's codec (``signals/png.py``)."""
    from wire_tpu_torch.signals import png
    png.write_rgba(path, to_rgba(arr, cmap, vmin, vmax))


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


def build_montage(images):
    """Grid montage of an (nimg, H, W) stack: ceil(sqrt(nimg)) rows, each
    tile min-max normalized, float32 (wire_tpu/signals/image.py:66)."""
    nimg, H, W = images.shape
    nrows = int(np.ceil(np.sqrt(nimg)))
    ncols = int(np.ceil(nimg / nrows))
    montage = np.zeros((H * nrows, W * ncols), dtype=np.float32)
    for cnt in range(nimg):
        r, c = divmod(cnt, ncols)
        montage[r * H:(r + 1) * H, c * W:(c + 1) * W] = normalize(
            images[cnt], True)
    return montage


def inpainting_mask(imsize, mask_type="random2d", mask_frac=0.5, rng=None):
    """An (H, W) float32 sampling mask (wire_tpu/signals/image.py:84):
    'random2d' keeps each pixel with probability ``mask_frac``, 'random1d'
    whole columns, 'bayer' every other pixel of every other row; ``rng`` a
    numpy RandomState (default the global one)."""
    rng = np.random if rng is None else rng
    H, W = imsize
    if mask_type == "random2d":
        mask = rng.rand(H, W) < mask_frac
    elif mask_type == "random1d":
        mask_row = rng.rand(1, W) < mask_frac
        mask = np.ones((H, 1)).dot(mask_row)
    elif mask_type == "bayer":
        mask = np.zeros((H, W))
        mask[::2, ::2] = 1
    else:
        raise ValueError(mask_type)
    return mask.astype(np.float32)


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


def shepp_logan(N=256):
    """The Shepp-Logan head phantom, (N, N) float32 clipped at 0
    (wire_tpu/signals/image.py:157; its ten ellipses as intensity, half
    axes, centre and angle in degrees)."""
    ellipses = [
        (1.0, 0.69, 0.92, 0.0, 0.0, 0),
        (-0.8, 0.6624, 0.8740, 0.0, -0.0184, 0),
        (-0.2, 0.1100, 0.3100, 0.22, 0.0, -18),
        (-0.2, 0.1600, 0.4100, -0.22, 0.0, 18),
        (0.1, 0.2100, 0.2500, 0.0, 0.35, 0),
        (0.1, 0.0460, 0.0460, 0.0, 0.1, 0),
        (0.1, 0.0460, 0.0460, 0.0, -0.1, 0),
        (0.1, 0.0460, 0.0230, -0.08, -0.605, 0),
        (0.1, 0.0230, 0.0230, 0.0, -0.606, 0),
        (0.1, 0.0230, 0.0460, 0.06, -0.605, 0),
    ]
    y, x = np.mgrid[-1:1:N * 1j, -1:1:N * 1j].astype(np.float32)
    img = np.zeros((N, N), np.float32)
    for A, a, b, x0, y0, phi in ellipses:
        t = np.deg2rad(phi)
        xr = (x - x0) * np.cos(t) + (y - y0) * np.sin(t)
        yr = -(x - x0) * np.sin(t) + (y - y0) * np.cos(t)
        img += A * ((xr / a) ** 2 + (yr / b) ** 2 <= 1)
    return np.clip(img, 0, None)


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
