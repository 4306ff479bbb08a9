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


def _fma32(a, b, c):
    """a b + c of float32 arrays rounded once to float32 (the product of
    two float32 is exact in float64)."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _along(x, axis, idx):
    return np.take(x, idx, axis=axis)


def _bcast(t, x, axis):
    """The per-index weights ``t`` shaped to broadcast along ``axis``."""
    shape = [1] * x.ndim
    shape[axis] = len(t)
    return t.reshape(shape)


def _clamped(ssize, sx, t):
    """cv2's edge rule: a source index past the last pixel takes it with
    weight 0, a negative one the first."""
    t = np.where(sx < 0, 0, t)
    sx = np.maximum(sx, 0)
    t = np.where(sx >= ssize - 1, 0, t)
    sx = np.minimum(sx, ssize - 1)
    return sx, t.astype(np.float32)


def _linear_axis(x, axis, dsize, inv_scale):
    """One axis of cv2's INTER_LINEAR: at destination d the source
    position (d + 0.5) / inv_scale - 0.5 in float64, its floor and the
    float32 fraction t, and the lerp x0 + (x1 - x0) t fused into one
    rounding."""
    ssize = x.shape[axis]
    f = (np.arange(dsize) + 0.5) * (1.0 / inv_scale) - 0.5
    sx = np.floor(f).astype(np.int64)
    sx, t = _clamped(ssize, sx, (f - sx).astype(np.float32))
    x0 = _along(x, axis, sx)
    x1 = _along(x, axis, np.minimum(sx + 1, ssize - 1))
    return _fma32((x1 - x0).astype(np.float32), _bcast(t, x, axis), x0)


def _area_up_axis(x, axis, dsize, inv_scale):
    """One axis of cv2's INTER_AREA upscale: sx = floor(d scale), the
    weight of sx + 1 the fractional part of (d + 1) - (sx + 1) / scale
    where that is positive (so integer factors replicate pixels), and the
    float32 blend x0 (1 - t) + x1 t."""
    ssize = x.shape[axis]
    d = np.arange(dsize)
    sx = np.floor(d * (1.0 / inv_scale)).astype(np.int64)
    t = ((d + 1) - (sx + 1) * inv_scale).astype(np.float32)
    t = np.where(t <= 0, np.float32(0), t - np.floor(t)).astype(np.float32)
    sx, t = _clamped(ssize, sx, t)
    x0 = _along(x, axis, sx)
    x1 = _along(x, axis, np.minimum(sx + 1, ssize - 1))
    tb = _bcast(t, x, axis)
    return (x0 * (np.float32(1) - tb) + x1 * tb).astype(np.float32)


def _area_tab(ssize, dsize, scale):
    """cv2's INTER_AREA downscale table along one axis
    (computeResizeAreaTab): (destination, source, float32 weight), the
    overlap of [d s, (d + 1) s) with each source pixel over the cell's
    width inside the image."""
    tab = []
    for dx in range(dsize):
        f1 = dx * scale
        f2 = f1 + scale
        cell = min(scale, ssize - f1)
        s2 = min(math.floor(f2), ssize - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            tab.append((dx, s1 - 1, np.float32((s1 - f1) / cell)))
        for sx in range(s1, s2):
            tab.append((dx, sx, np.float32(1.0 / cell)))
        if f2 - s2 > 1e-3:
            tab.append((dx, s2, np.float32(min(min(f2 - s2, 1.0), cell)
                                           / cell)))
    return tab


def _area_general(im, Hd, Wd, sy, sx):
    """cv2's INTER_AREA downscale at a fractional ratio, in its float32
    order: each source row spread over the destination columns table
    entry by table entry, then the rows summed into the destination rows
    the same way."""
    im = np.asarray(im, np.float32)
    rows = np.zeros((im.shape[0], Wd) + im.shape[2:], np.float32)
    for d, s, a in _area_tab(im.shape[1], Wd, sx):
        rows[:, d] = rows[:, d] + im[:, s] * a
    out = np.zeros((Hd, Wd) + im.shape[2:], np.float32)
    for d, s, a in _area_tab(im.shape[0], Hd, sy):
        out[d] = out[d] + a * rows[s]
    return out


def _area_fast(im, sy, sx):
    """cv2's INTER_AREA downscale by integer factors that divide the image,
    in its float32 order: a 2 x 2 cell of one or four channels as
    (a + b) + (c + d), any other cell summed row by row, four taps at a
    time, then scaled by 1 / (sx sy)."""
    im = np.asarray(im, np.float32)
    H, W = im.shape[:2]
    taps = [im[i::sy, j::sx][:H // sy, :W // sx]
            for i in range(sy) for j in range(sx)]
    channels = im.shape[2] if im.ndim == 3 else 1
    if sy == sx == 2 and channels in (1, 4):
        acc = (taps[0] + taps[1]) + (taps[2] + taps[3])
    else:
        acc = np.zeros_like(taps[0])
        k = 0
        while k + 4 <= len(taps):
            acc = acc + (((taps[k] + taps[k + 1]) + taps[k + 2])
                         + taps[k + 3])
            k += 4
        for tap in taps[k:]:
            acc = acc + tap
    return (acc * np.float32(1.0 / (sx * sy))).astype(np.float32)


def _factors(im, fx, fy, dsize):
    """cv2.resize's output size (H, W) and its inverse scales (fy, fx):
    ``dsize`` = (W, H) sets the size and the scales are its ratios to the
    input's; otherwise the scales set the size, rounded to the nearest."""
    H, W = im.shape[:2]
    if dsize is not None:
        Wd, Hd = dsize
        return (Hd, Wd), (Hd / H, Wd / W)
    fy = fx if fy is None else fy
    return (_dsize(H, fy), _dsize(W, fx)), (fy, fx)


def resize_area(im, fx=None, fy=None, dsize=None):
    """cv2.resize(im, dsize, fx=fx, fy=fy, interpolation=INTER_AREA) in
    cv2's float32 arithmetic: the output is ``dsize`` = (W, H) when given,
    else round(H fy) x round(W fx), and a copy where that is the input's
    size.  A downscale on both axes averages over each destination cell;
    any upscale takes INTER_AREA's upscale weights on both axes."""
    (Hd, Wd), (fy, fx) = _factors(im, fx, fy, dsize)
    H, W = im.shape[:2]
    if (Hd, Wd) == (H, W):
        return np.array(im, np.float32)   # cv2 copies a same-size resize
    sy, sx = 1.0 / fy, 1.0 / fx
    if sy < 1 or sx < 1:
        return _area_up_axis(_area_up_axis(np.asarray(im, np.float32), 1,
                                           Wd, fx), 0, Hd, fy)
    if sy == int(sy) and sx == int(sx) and H % int(sy) == W % int(sx) == 0:
        return _area_fast(im, int(sy), int(sx))
    return _area_general(im, Hd, Wd, sy, sx)


def resize_linear(im, fx=None, fy=None, dsize=None):
    """cv2.resize(im, dsize, fx=fx, fy=fy, interpolation=INTER_LINEAR),
    sized as ``resize_area``, in cv2's float32 arithmetic: columns first,
    then rows."""
    (Hd, Wd), (fy, fx) = _factors(im, fx, fy, dsize)
    H, W = im.shape[:2]
    if (Hd, Wd) == (H, W):
        return np.array(im, np.float32)
    cols = _linear_axis(np.asarray(im, np.float32), 1, Wd, fx)
    return _linear_axis(cols, 0, Hd, fy)


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
