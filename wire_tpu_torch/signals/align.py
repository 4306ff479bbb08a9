"""Image alignment and dense optical flow on the host, written from
OpenCV's definitions so that the port needs no cv2: the enhanced
correlation coefficient alignment of ``cv2.findTransformECC`` (translation,
euclidean, affine and homography warps) and the dense two-frame flow of
``cv2.calcOpticalFlowFarneback`` (its box-window variant), with the
bilinear warps both use.  numpy and scipy.ndimage, float32 where OpenCV
keeps float32 and float64 for its sums.

Conventions shared with OpenCV:

- Gaussian blurs are separable, border reflect-101 (``d c b | a b c d``);
  a kernel of up to 7 taps with sigma 0 is the binomial one.
- Warps map destination pixels to source pixels (``WARP_INVERSE_MAP``):
  the sample of pixel p is src(W p), bilinear, zero outside the source.
- A warp is a float32 (2, 3) matrix, or (3, 3) for a homography.
"""
from __future__ import annotations

import numpy as np

MOTIONS = ("translation", "euclidean", "affine", "homography")

_BINOMIAL = {1: (1.0,), 3: (0.25, 0.5, 0.25),
             5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
             7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                 0.03125)}


def gaussian_kernel(n, sigma):
    """The float32 taps of OpenCV's ``getGaussianKernel(n, sigma)``: the
    binomial table for sigma <= 0 and n <= 7, otherwise exp(-x^2 / (2
    sigma^2)) normalised, sigma defaulting to 0.3 ((n - 1) / 2 - 1) + 0.8."""
    if sigma <= 0 and n in _BINOMIAL:
        return np.asarray(_BINOMIAL[n], np.float32)
    s = sigma if sigma > 0 else ((n - 1) * 0.5 - 1) * 0.3 + 0.8
    x = np.arange(n) - (n - 1) * 0.5
    k = np.exp(-0.5 / (s * s) * x * x)
    return (k / k.sum()).astype(np.float32)


def _correlate(im, taps, axis):
    from scipy import ndimage
    return ndimage.correlate1d(im, np.asarray(taps, np.float64), axis=axis,
                               mode="mirror")


def gaussian_blur(im, n, sigma=0.0):
    """``cv2.GaussianBlur(im, (n, n), sigma)`` of a 2-D float image."""
    k = gaussian_kernel(n, sigma)
    x = _correlate(np.asarray(im, np.float64), k, 1)
    return _correlate(x, k, 0).astype(np.float32)


def gradients(im):
    """(d/dx, d/dy) of ``im`` by the centred difference [-0.5, 0, 0.5]
    (``cv2.filter2D`` with reflect-101 borders)."""
    x = np.asarray(im, np.float64)
    return (_correlate(x, (-0.5, 0.0, 0.5), 1).astype(np.float32),
            _correlate(x, (-0.5, 0.0, 0.5), 0).astype(np.float32))


def warp_coords(warp, shape):
    """Source coordinates (xs, ys), float64, of every pixel of an image of
    ``shape`` (H, W) under ``warp``; a homography divides by its third
    row (0 where that is 0)."""
    H, W = shape
    Y, X = np.mgrid[:H, :W].astype(np.float64)
    w = np.asarray(warp, np.float64)
    xs = w[0, 0] * X + w[0, 1] * Y + w[0, 2]
    ys = w[1, 0] * X + w[1, 1] * Y + w[1, 2]
    if w.shape[0] == 3:
        d = w[2, 0] * X + w[2, 1] * Y + w[2, 2]
        d = np.divide(1.0, d, out=np.zeros_like(d), where=d != 0)
        xs, ys = xs * d, ys * d
    return xs, ys


def remap(im, xs, ys):
    """``im`` (H, W[, C]) sampled at (xs, ys), bilinear, zero outside, in
    the image's dtype (``cv2.remap`` / ``cv2.warpAffine`` /
    ``cv2.warpPerspective`` with INTER_LINEAR and a constant 0 border,
    and wire_tpu's numpy remap bit for bit)."""
    im = np.asarray(im)
    H, W = im.shape[:2]
    x0 = np.floor(xs).astype(np.int64)
    y0 = np.floor(ys).astype(np.int64)
    wx = xs - x0
    wy = ys - y0
    if im.ndim == 3:
        wx, wy = wx[..., None], wy[..., None]

    def tap(yy, xx):
        inb = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        if im.ndim == 3:
            inb = inb[..., None]
        return np.where(inb, im[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)],
                        0.0)

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return (top * (1 - wy) + bot * wy).astype(im.dtype)


def warp(im, matrix, shape=None):
    """``im`` warped by ``matrix`` (2 x 3 affine or 3 x 3 homography) with
    the inverse map onto a grid of ``shape`` (the image's own by
    default)."""
    shape = np.asarray(im).shape[:2] if shape is None else shape
    return remap(im, *warp_coords(matrix, shape))


def _inside_nearest(xs, ys, shape):
    """The pixels whose nearest source pixel lies in an image of ``shape``
    (the mask that an all-ones mask warps to with INTER_NEAREST)."""
    H, W = shape
    xi = np.floor(xs + 0.5)
    yi = np.floor(ys + 0.5)
    return (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)


def _jacobian(motion, gx, gy, X, Y, w):
    """The image's Jacobian in the warp parameters, one (H, W) float32
    block per parameter, in OpenCV's parameter order."""
    if motion == "translation":
        return [gx, gy]
    if motion == "euclidean":
        c, s = w[0, 0], w[1, 0]
        hat_x = -(X * s) - (Y * c)
        hat_y = (X * c) - (Y * s)
        return [gx * hat_x + gy * hat_y, gx, gy]
    if motion == "affine":
        return [gx * X, gy * X, gx * Y, gy * Y, gx, gy]
    den = X * w[2, 0] + Y * w[2, 1] + np.float32(1.0)
    hat_x = (-X * w[0, 0] - Y * w[0, 1] - w[0, 2]) / den
    hat_y = (-X * w[1, 0] - Y * w[1, 1] - w[1, 2]) / den
    gxd = gx / den
    gyd = gy / den
    t = hat_x * gxd + hat_y * gyd
    return [gxd * X, gyd * X, t * X, gxd * Y, gyd * Y, t * Y, gxd, gyd]


# the warp entries each parameter of an affine or homography update adds to
_UPDATE_AT = {"translation": ((0, 2), (1, 2)),
              "affine": ((0, 0), (1, 0), (0, 1), (1, 1), (0, 2), (1, 2)),
              "homography": ((0, 0), (1, 0), (2, 0), (0, 1), (1, 1), (2, 1),
                             (0, 2), (1, 2))}


def _update(w, dp, motion):
    """OpenCV's warp update: added entries, or for a euclidean warp the
    angle added to asin(w[1, 0]) and the matrix rebuilt from it."""
    if motion != "euclidean":
        for (r, c), d in zip(_UPDATE_AT[motion], dp):
            w[r, c] += d
        return w
    theta = float(dp[0]) + np.arcsin(float(w[1, 0]))
    w[0, 2] += dp[1]
    w[1, 2] += dp[2]
    w[0, 0] = w[1, 1] = np.float32(np.cos(theta))
    w[1, 0] = np.float32(np.sin(theta))
    w[0, 1] = -w[1, 0]
    return w


def find_transform_ecc(template, image, warp_init, motion="affine",
                       niters=50, eps=1e-3, gauss_size=5):
    """``cv2.findTransformECC(template, image, warp_init, motion,
    (COUNT | EPS, niters, eps), None, gauss_size)``: the warp W that
    maximises the enhanced correlation coefficient between template(p) and
    image(W p), by OpenCV's forward-additive Gauss-Newton iterations.

    Both images are Gaussian-blurred (``gauss_size`` taps, sigma 0) and
    the image's gradients taken once.  Each iteration warps the image and
    its gradients onto the template's grid (bilinear) and the valid mask
    (the pixels whose nearest source pixel is inside), zero-means both
    images over the mask (the warped image keeps its values outside it,
    as OpenCV's masked subtract leaves them), forms the Jacobian, the
    Gauss-Newton Hessian and the projections, and updates the warp by the
    step that accounts for a gain between the images.  It stops after
    ``niters`` iterations or when the coefficient moves by less than
    ``eps`` (never, for eps < 0).  Returns (rho, warp float32); raises
    RuntimeError where OpenCV raises (no convergence)."""
    if motion not in MOTIONS:
        raise ValueError(f"find_transform_ecc: motion {motion!r} is not one "
                         f"of {sorted(MOTIONS)}")
    w = np.array(warp_init, np.float32)
    want = (3, 3) if motion == "homography" else (2, 3)
    if w.shape != want:
        raise ValueError(f"find_transform_ecc: a {motion} warp is {want}, "
                         f"got {w.shape}")
    tmpl = gaussian_blur(template, gauss_size)
    img = gaussian_blur(image, gauss_size)
    gx, gy = gradients(img)
    H, W = tmpl.shape
    Y, X = np.mgrid[:H, :W].astype(np.float32)
    t64 = tmpl.astype(np.float64)
    rho, last = -1.0, -eps
    it = 1
    while it <= niters and abs(rho - last) >= eps:
        xs, ys = warp_coords(w, (H, W))
        warped = remap(img, xs, ys)
        gxw = remap(gx, xs, ys)
        gyw = remap(gy, xs, ys)
        mask = _inside_nearest(xs, ys, img.shape)
        count = int(mask.sum())
        if count == 0:
            raise RuntimeError("find_transform_ecc: the warped image does "
                               "not overlap the template")
        w_in = warped[mask].astype(np.float64)
        t_in = t64[mask]
        im_mean, t_mean = w_in.mean(), t_in.mean()
        im_var = max((w_in * w_in).sum() / count - im_mean * im_mean, 0.0)
        t_var = max((t_in * t_in).sum() / count - t_mean * t_mean, 0.0)
        img_norm = np.sqrt(count * im_var)
        tmpl_norm = np.sqrt(count * t_var)
        warped = np.where(mask, warped - np.float32(im_mean), warped) \
            .astype(np.float32).astype(np.float64)
        tzm = np.where(mask, tmpl - np.float32(t_mean), 0) \
            .astype(np.float32).astype(np.float64)
        jac = [j.astype(np.float32).ravel().astype(np.float64)
               for j in _jacobian(motion, gxw, gyw, X, Y, w)]
        J = np.stack(jac)                                  # (n, H W)
        hess = (J @ J.T).astype(np.float32).astype(np.float64)
        try:
            hinv = np.linalg.inv(hess).astype(np.float32).astype(np.float64)
        except np.linalg.LinAlgError:     # OpenCV's inverse of a singular
            hinv = np.zeros_like(hess)    # matrix is zero
        corr = float(tzm.ravel() @ warped.ravel())
        last = rho
        with np.errstate(divide="ignore", invalid="ignore"):
            rho = corr / (img_norm * tmpl_norm)
        if np.isnan(rho):
            raise RuntimeError("find_transform_ecc: NaN encountered")
        i_proj = (J @ warped.ravel()).astype(np.float32).astype(np.float64)
        t_proj = (J @ tzm.ravel()).astype(np.float32).astype(np.float64)
        i_proj_h = (hinv @ i_proj).astype(np.float32).astype(np.float64)
        lam_n = img_norm * img_norm - float(i_proj @ i_proj_h)
        lam_d = corr - float(t_proj @ i_proj_h)
        if lam_d <= 0.0:
            raise RuntimeError(
                "find_transform_ecc: the algorithm stopped before its "
                "convergence; the images may be uncorrelated or not "
                "overlap")
        err = (lam_n / lam_d * tzm - warped).astype(np.float32)
        e_proj = (J @ err.ravel().astype(np.float64)).astype(np.float32)
        dp = (hinv @ e_proj.astype(np.float64)).astype(np.float32)
        w = _update(w, dp, motion)
        it += 1
    return rho, w


# ---------------------------------------------------------------------------
# Farnebäck dense optical flow
# ---------------------------------------------------------------------------

def _poly_gaussian(n, sigma):
    """The applicability taps g, x g, x^2 g (float32) over [-n, n] and the
    four entries of the inverted moment matrix the expansion needs."""
    if sigma < np.finfo(np.float32).eps:
        sigma = n * 0.3
    x = np.arange(-n, n + 1)
    g = np.exp(-x * x / (2 * sigma * sigma)).astype(np.float32)
    g = (g * (1.0 / g.astype(np.float64).sum())).astype(np.float32)
    xg = (x * g).astype(np.float32)
    xxg = (x * x * g).astype(np.float32)
    gd = g.astype(np.float64)
    gg = np.outer(gd, gd)                    # [y, x]
    xx = (x * x).astype(np.float64)
    G = np.zeros((6, 6))
    G[0, 0] = gg.sum()
    G[1, 1] = (gg * xx[None, :]).sum()
    G[3, 3] = (gg * (xx * xx)[None, :]).sum()
    G[5, 5] = (gg * xx[None, :] * xx[:, None]).sum()
    G[2, 2] = G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = G[1, 1]
    G[4, 4] = G[3, 3]
    G[3, 4] = G[4, 3] = G[5, 5]
    ig = np.linalg.inv(G)
    return g, xg, xxg, ig[1, 1], ig[0, 3], ig[3, 3], ig[5, 5]


def poly_expansion(src, n, sigma):
    """Farnebäck's quadratic expansion of a float32 image: per pixel the
    five coefficients (r_y, r_x, r_yy, r_xx, r_xy) in OpenCV's channel
    order, from separable applicability-weighted moments over a (2n + 1)^2
    window, the borders replicated."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_gaussian(n, sigma)
    s = np.asarray(src, np.float32)
    H, W = s.shape
    rows = np.arange(H)
    v0 = s * g[n]
    v1 = np.zeros_like(s)
    v2 = np.zeros_like(s)
    for k in range(1, n + 1):
        up = s[np.maximum(rows - k, 0)]
        dn = s[np.minimum(rows + k, H - 1)]
        p = up + dn
        v0 = v0 + g[n + k] * p
        v1 = v1 + xg[n + k] * (dn - up)
        v2 = v2 + xxg[n + k] * p
    cols = np.arange(W)

    def at(v, k):
        return v[:, np.clip(cols + k, 0, W - 1)].astype(np.float64)

    b1 = v0.astype(np.float64) * g[n]
    b3 = v1.astype(np.float64) * g[n]
    b5 = v2.astype(np.float64) * g[n]
    b2 = np.zeros((H, W))
    b4 = np.zeros((H, W))
    b6 = np.zeros((H, W))
    for k in range(1, n + 1):
        right, left = at(v0, k), at(v0, -k)
        b1 += (right + left) * g[n + k]
        b4 += (right + left) * xxg[n + k]
        b2 += (right - left) * xg[n + k]
        b3 += (at(v1, k) + at(v1, -k)) * g[n + k]
        b6 += (at(v1, k) - at(v1, -k)) * xg[n + k]
        b5 += (at(v2, k) + at(v2, -k)) * g[n + k]
    R = np.empty((H, W, 5), np.float32)
    R[..., 0] = b3 * ig11
    R[..., 1] = b2 * ig11
    R[..., 2] = b1 * ig03 + b5 * ig33
    R[..., 3] = b1 * ig03 + b4 * ig33
    R[..., 4] = b6 * ig55
    return R


_BORDER = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], np.float32)


def _border_weights(size):
    """Per index the product of OpenCV's border attenuation from the low
    and the high edge (1 beyond 5 pixels of both)."""
    i = np.arange(size)
    lo = np.where(i < 5, _BORDER[np.minimum(i, 4)], 1).astype(np.float32)
    hi = np.where(i >= size - 5, _BORDER[np.clip(size - i - 1, 0, 4)],
                  1).astype(np.float32)
    return lo * hi


def _flow_matrices(R0, R1, flow):
    """The per-pixel normal equations (G11, G12, G22, h1, h2) of the
    displacement, from the two expansions with R1 sampled bilinearly at
    the displaced positions, attenuated within 5 pixels of the border."""
    f32 = np.float32
    H, W = flow.shape[:2]
    dx, dy = flow[..., 0], flow[..., 1]
    Y, X = np.mgrid[:H, :W]
    fx = (X + dx).astype(f32)
    fy = (Y + dy).astype(f32)
    x1 = np.floor(fx).astype(np.int64)
    y1 = np.floor(fy).astype(np.int64)
    fx = fx - x1.astype(f32)
    fy = fy - y1.astype(f32)
    inside = (x1 >= 0) & (x1 < W - 1) & (y1 >= 0) & (y1 < H - 1)
    xc = np.clip(x1, 0, W - 2)
    yc = np.clip(y1, 0, H - 2)
    r = (((1 - fx) * (1 - fy))[..., None] * R1[yc, xc]
         + (fx * (1 - fy))[..., None] * R1[yc, xc + 1]
         + ((1 - fx) * fy)[..., None] * R1[yc + 1, xc]
         + (fx * fy)[..., None] * R1[yc + 1, xc + 1]).astype(f32)
    r2 = np.where(inside, r[..., 0], 0)
    r3 = np.where(inside, r[..., 1], 0)
    r4 = np.where(inside, (R0[..., 2] + r[..., 2]) * f32(0.5), R0[..., 2])
    r5 = np.where(inside, (R0[..., 3] + r[..., 3]) * f32(0.5), R0[..., 3])
    r6 = np.where(inside, (R0[..., 4] + r[..., 4]) * f32(0.25),
                  R0[..., 4] * f32(0.5))
    r2 = (R0[..., 0] - r2) * f32(0.5) + (r4 * dy + r6 * dx)
    r3 = (R0[..., 1] - r3) * f32(0.5) + (r6 * dy + r5 * dx)
    scale = _border_weights(H)[:, None] * _border_weights(W)[None, :]
    r2, r3, r4, r5, r6 = (v * scale for v in (r2, r3, r4, r5, r6))
    M = np.empty((H, W, 5), f32)
    M[..., 0] = r4 * r4 + r6 * r6
    M[..., 1] = (r4 + r5) * r6
    M[..., 2] = r5 * r5 + r6 * r6
    M[..., 3] = r4 * r2 + r6 * r3
    M[..., 4] = r6 * r2 + r5 * r3
    return M


def _box_mean(M, size):
    """Mean of each channel over a size x size window, borders
    replicated, in float64."""
    m = size // 2
    H, W = M.shape[:2]
    x = M.astype(np.float64)
    rows = x[np.clip(np.arange(-m, H + m), 0, H - 1)]
    c = np.concatenate([np.zeros((1, W, 5)), np.cumsum(rows, 0)])
    v = c[2 * m + 1:] - c[:-2 * m - 1]
    cols = v[:, np.clip(np.arange(-m, W + m), 0, W - 1)]
    c = np.concatenate([np.zeros((H, 1, 5)), np.cumsum(cols, 1)], 1)
    return (c[:, 2 * m + 1:] - c[:, :-2 * m - 1]) / (size * size)


def _solve_flow(M, winsize):
    s = _box_mean(M, winsize)
    g11, g12, g22, h1, h2 = (s[..., i] for i in range(5))
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    flow = np.empty(M.shape[:2] + (2,), np.float32)
    flow[..., 0] = (g11 * h2 - g12 * h1) * idet
    flow[..., 1] = (g22 * h1 - g12 * h2) * idet
    return flow


def farneback_flow(prev, nxt, pyr_scale=0.5, levels=3, winsize=15,
                   iterations=3, poly_n=5, poly_sigma=1.2):
    """``cv2.calcOpticalFlowFarneback(prev, nxt, None, pyr_scale, levels,
    winsize, iterations, poly_n, poly_sigma, 0)``: the dense flow (H, W, 2)
    float32 with nxt(p + flow(p)) ~ prev(p), coarse to fine.

    The pyramid has ``levels`` levels below the image while both sides
    stay at or above 32 pixels.  At each level both frames are blurred at
    full size (sigma (1/scale - 1) / 2, at least 3 taps) and resized
    linearly, and expanded into quadratic polynomials (``poly_n``,
    ``poly_sigma``); the coarser level's flow, resized linearly and
    divided by ``pyr_scale``, starts it.  ``iterations`` times the normal
    equations of the displacement are box-filtered over ``winsize`` and
    solved per pixel, the equations rebuilt from the new flow between
    iterations."""
    from wire_tpu_torch.signals.image import resize_linear
    prev = np.asarray(prev, np.float32)
    nxt = np.asarray(nxt, np.float32)
    H, W = prev.shape
    scale, top = 1.0, 0
    while top < levels:
        scale *= pyr_scale
        if W * scale < 32 or H * scale < 32:
            break
        top += 1
    flow = None
    for k in range(top, -1, -1):
        scale = 1.0
        for _ in range(k):
            scale *= pyr_scale
        sigma = (1.0 / scale - 1) * 0.5
        ksize = max(int(np.rint(sigma * 5)) | 1, 3)
        w, h = int(np.rint(W * scale)), int(np.rint(H * scale))
        if flow is None:
            flow = np.zeros((h, w, 2), np.float32)
        else:
            flow = (resize_linear(flow, dsize=(w, h))
                    * np.float32(1.0 / pyr_scale)).astype(np.float32)
        R0, R1 = (poly_expansion(resize_linear(gaussian_blur(f, ksize, sigma),
                                               dsize=(w, h)),
                                 poly_n, poly_sigma) for f in (prev, nxt))
        M = _flow_matrices(R0, R1, flow)
        for i in range(iterations):
            flow = _solve_flow(M, winsize)
            if i < iterations - 1:
                M = _flow_matrices(R0, R1, flow)
    return flow
