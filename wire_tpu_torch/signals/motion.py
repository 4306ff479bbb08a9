"""Multi-frame super-resolution data: synthetic shifted/rotated bursts,
Euclidean transforms, registration and frame datasets (port of
wire_tpu/signals/motion.py).

The port has no cv2, so each function takes the branch wire_tpu takes
without it:

- ``make_burst``         random Euclidean warps of an HR image (numpy
                         bilinear remap, zero border) and the per-frame
                         warped coordinate grids in [-1, 1]
- ``downsample_burst``   per-frame box mean
- ``pyramid_register``   coarse-to-fine rigid registration: an FFT phase
                         correlation over trial rotations at the coarsest
                         level, then Gauss-Newton refinement
                         (``native.rigid_register``) at each level
- ``register_burst``     every frame against frame 0, and the warped HR
                         coordinate grids of the inverted warps
- ``FrameDataset``       per-frame (coords, pixels, mask) arrays

plus the affine toolbox (``xy_mgrid``, ``invert_regstack``, ``mat2coords``,
``param2theta``, ``affine2rigid``, ``get_transformed_coords``) and the
differentiable ``interp_lr`` on torch tensors.  What wire_tpu does only
through cv2 (``shifted_downsampled_burst``, ``optical_flow``, ``ecc_flow``,
``flow2rgb``, ``prune_stack``, and the resizes of ``make_burst`` at
``scale != 1`` and of ``mat2coords`` at ``low_res != full_res``) raises
NotImplementedError (ROADMAP section A, item 8).
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _needs_cv2(what):
    return NotImplementedError(
        f"motion.{what} needs cv2, which the port does not use; not ported "
        f"yet (ROADMAP §A.8)")


def euclidean_matrix(theta, shift):
    """The 2 x 3 rigid transform of angle ``theta`` and ``shift``."""
    return np.array([[np.cos(theta), -np.sin(theta), shift[0]],
                     [np.sin(theta), np.cos(theta), shift[1]]])


def make_burst(im, shift_max=10, theta_max=np.pi / 12, nframes=5, rng=None,
               scale=1):
    """``nframes`` randomly shifted and rotated copies of ``im`` (H, W, 3)
    and their warped coordinate grids: (imstack (n, H, W, 3), Xstack
    (n, H, W), Ystack, mats (n, 2, 3)), X and Y normalized to [-1, 1];
    frame 0 is the identity.  ``rng`` is a np.random.RandomState (the
    global one by default)."""
    if scale != 1:
        raise _needs_cv2("make_burst at scale != 1")
    rng = np.random if rng is None else rng
    H, W, _ = im.shape
    shifts = rng.randint(-shift_max, shift_max, size=[nframes, 2])
    thetas = (2 * rng.rand(nframes) - 1) * theta_max
    shifts[0, :] = 0
    thetas[0] = 0

    Y, X = np.mgrid[:H, :W]
    ones = np.ones((H * W, 1))
    coords = np.hstack((X.reshape(-1, 1), Y.reshape(-1, 1), ones))

    imstack = np.zeros((nframes, H, W, 3), np.float32)
    Xstack = np.zeros((nframes, H, W), np.float32)
    Ystack = np.zeros_like(Xstack)
    mats = np.zeros((nframes, 2, 3))
    for idx in range(nframes):
        mat = euclidean_matrix(thetas[idx], shifts[idx])
        mats[idx] = mat
        cn = coords @ mat.T
        Xn = cn[:, 0].reshape(H, W).astype(np.float32)
        Yn = cn[:, 1].reshape(H, W).astype(np.float32)
        imstack[idx] = _remap(im, Xn, Yn)
        Xstack[idx] = 2 * Xn / W - 1
        Ystack[idx] = 2 * Yn / H - 1
    return imstack, Xstack, Ystack, mats


def _remap(im, Xn, Yn):
    """``im`` sampled at pixel coordinates (Xn, Yn), bilinear, zero
    outside."""
    H, W = im.shape[:2]
    x0 = np.floor(Xn).astype(int)
    y0 = np.floor(Yn).astype(int)
    wx = (Xn - x0)[..., None]
    wy = (Yn - y0)[..., None]

    def tap(yy, xx):
        inb = ((xx >= 0) & (xx < W) & (yy >= 0) & (yy < H))[..., None]
        v = im[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)]
        return np.where(inb, v, 0.0)

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return (top * (1 - wy) + bot * wy).astype(im.dtype)


def downsample_burst(imstack_hr, scale):
    """Per-frame box mean by ``scale`` of (n, H, W, C) frames."""
    n, H, W, c = imstack_hr.shape
    out = np.zeros((n, H // scale, W // scale, c), np.float32)
    for i in range(n):
        out[i] = imstack_hr[i][:H // scale * scale, :W // scale * scale]\
            .reshape(H // scale, scale, W // scale, scale, c).mean((1, 3))
    return out


def _resize(im, size_wh, interp="linear"):
    """Resize to (W, H) = ``size_wh`` on scipy.ndimage.map_coordinates, with
    cv2's pixel-centre convention src = (dst + 0.5) * src_size / dst_size -
    0.5; 'cubic' is a cubic spline, 'linear' and 'area' are linear."""
    from scipy import ndimage
    Wd, Hd = size_wh
    H, W = im.shape[:2]
    ys = (np.arange(Hd) + 0.5) * H / Hd - 0.5
    xs = (np.arange(Wd) + 0.5) * W / Wd - 0.5
    Yq, Xq = np.meshgrid(ys, xs, indexing="ij")
    order = 3 if interp == "cubic" else 1
    return ndimage.map_coordinates(im.astype(np.float32), [Yq, Xq],
                                   order=order, mode="nearest")


def _ecc_refine(ref, mov, warp, niters, eps, mask=None):
    """One Gauss-Newton refinement of ``warp`` (mov(W p) ~ ref(p)) by the
    native ``rigid_register``; ``mask`` is not used (nor is it by wire_tpu's
    native branch).  Returns (warp, converged)."""
    from wire_tpu_torch.native import rigid_register
    try:
        w = rigid_register(ref, mov, max_iters=niters, eps=eps,
                           init_warp=warp)
        return np.asarray(w, np.float32), True
    except Exception:
        return warp, False


def _coarse_init(ref, mov, theta_max=0.4, ntheta=17):
    """A global rigid start at the coarse scale: for each trial rotation
    about the image centre, de-rotate the moving frame (bilinear) and
    phase-correlate it against the reference (FFT) for the translation;
    keep the candidate with the highest correlation peak.  Returns a
    (2, 3) warp W with mov(W p) ~ ref(p)."""
    H, W = ref.shape
    c = np.array([(W - 1) / 2.0, (H - 1) / 2.0])
    best = (-np.inf, np.eye(2, 3, dtype=np.float32))
    for theta in np.linspace(-theta_max, theta_max, ntheta):
        R = np.array([[np.cos(theta), -np.sin(theta)],
                      [np.sin(theta), np.cos(theta)]], np.float32)
        Rc = np.hstack([R, ((np.eye(2) - R) @ c)[:, None]]).astype(
            np.float32)
        Y, X = np.mgrid[:H, :W]
        pts = Rc @ np.stack([X.ravel(), Y.ravel(), np.ones(H * W)])
        mov_r = _remap(mov[..., None], pts[0].reshape(H, W)
                       .astype(np.float32),
                       pts[1].reshape(H, W).astype(np.float32))[..., 0]
        F = np.fft.fft2(ref) * np.conj(np.fft.fft2(mov_r))
        r = np.fft.ifft2(F / (np.abs(F) + 1e-9)).real
        iy, ix = np.unravel_index(np.argmax(r), r.shape)
        resp = r[iy, ix]
        d = -np.array([ix if ix <= W // 2 else ix - W,
                       iy if iy <= H // 2 else iy - H], np.float64)
        if resp > best[0]:
            # mov(R_c (p + d)) ~ ref(p)  =>  W = [R | R d + (I - R) c]
            t = R @ d + (np.eye(2) - R) @ c
            best = (resp, np.hstack([R, t[:, None]]).astype(np.float32))
    return best[1]


def pyramid_register(ref, mov, levels=None, min_size=48, niters=200,
                     eps=1e-7, mask=None):
    """Coarse-to-fine rigid registration: the Euclidean warp W with
    mov(W p) ~ ref(p), by Gauss-Newton over an image pyramid, each level
    started from the previous one's warp.  Levels halve with the
    pixel-centre resize, so a warp lifts to the finer level as
    t' = 2 t + (I - R) 0.5; the finest level runs 4x the iterations at a
    tenth of ``eps``.  Returns (warp (2, 3) float32, ok)."""
    H, W = ref.shape
    if levels is None:
        levels = 1
        while min(H, W) // (2 ** levels) >= min_size:
            levels += 1
    pyr_ref, pyr_mov = [ref.astype(np.float32)], [mov.astype(np.float32)]
    if mask is None:
        mask = (np.abs(mov) > 1e-6).astype(np.float32)
    pyr_mask = [mask.astype(np.float32)]
    for _ in range(levels - 1):
        h, w = pyr_ref[-1].shape
        pyr_ref.append(_resize(pyr_ref[-1], (w // 2, h // 2), "area"))
        pyr_mov.append(_resize(pyr_mov[-1], (w // 2, h // 2), "area"))
        pyr_mask.append(_resize(pyr_mask[-1], (w // 2, h // 2), "area"))

    warp = _coarse_init(pyr_ref[-1], pyr_mov[-1])
    ok_any = False
    for lvl in range(levels - 1, -1, -1):
        is_finest = lvl == 0
        mlvl = (pyr_mask[lvl] > 0.999).astype(np.uint8)
        warp, ok = _ecc_refine(pyr_ref[lvl], pyr_mov[lvl], warp,
                               niters if not is_finest else 4 * niters,
                               eps if not is_finest else eps * 1e-1,
                               mask=mlvl)
        ok_any = ok_any or ok
        if lvl > 0:
            R = warp[:, :2]
            t = warp[:, 2]
            warp = warp.copy()
            warp[:, 2] = 2 * t + 0.5 * ((np.eye(2) - R) @ np.ones(2))
    return warp.astype(np.float32), ok_any


def register_burst(imstack, full_size):
    """Rigid warps of each frame against frame 0 and the warped HR
    coordinate grids in [-1, 1].  Each LR frame is upsampled (cubic) to the
    HR grid ``full_size`` = (H, W) and registered there by
    ``pyramid_register``, with the moving frame's nonzero pixels (from the
    LR frame, lifted linearly) as its mask.  The warps W_i follow
    frame_i(W_i p) ~ frame_0(p); the grids take M_i = W_i^{-1}.

    imstack: (n, h, w) or (n, h, w, C) LR frames.  Returns (Xstack,
    Ystack, ok (n,), mats (n, 2, 3) = the W_i in HR pixels)."""
    n = imstack.shape[0]
    Hf, Wf = full_size
    if imstack.ndim == 4:
        gray = imstack.mean(-1).astype(np.float32)
    else:
        gray = imstack.astype(np.float32)
    up = [_resize(g, (Wf, Hf), "cubic") for g in gray]
    upmask = []
    for g in gray:
        mlr = (np.abs(g) > 1e-6).astype(np.float32)
        upmask.append((_resize(mlr, (Wf, Hf), "linear") > 0.999)
                      .astype(np.float32))
    Y, X = np.mgrid[:Hf, :Wf]
    ones = np.ones((Hf * Wf, 1))
    coords = np.hstack((X.reshape(-1, 1), Y.reshape(-1, 1), ones))
    Xstack = np.zeros((n, Hf, Wf), np.float32)
    Ystack = np.zeros_like(Xstack)
    ok = np.ones(n, np.float32)
    mats = np.zeros((n, 2, 3), np.float32)
    last = np.array([[0.0, 0.0, 1.0]])
    for i in range(n):
        warp = np.eye(2, 3, dtype=np.float32)
        if i > 0:
            warp, converged = pyramid_register(up[0], up[i], mask=upmask[i])
            ok[i] = float(converged)
        mats[i] = warp
        minv = np.linalg.inv(np.vstack([warp, last]))[:2]
        cn = coords @ minv.T
        Xstack[i] = cn[:, 0].reshape(Hf, Wf)
        Ystack[i] = cn[:, 1].reshape(Hf, Wf)
    Xstack = 2 * Xstack / Wf - 1
    Ystack = 2 * Ystack / Hf - 1
    return Xstack, Ystack, ok, mats


def get_sr_data(im, scale, nimg=10, simulation=True, get_gt=False,
                shift_max=10, theta_max=np.pi / 12, rng=None):
    """An SR burst and its registration matrices, from one HR image
    (``simulation``: a burst of ``nimg`` frames downsampled by ``scale``)
    or from a captured stack (the first ``nimg`` frames).  The matrices
    are the burst's inverted motions with ``get_gt``, else
    ``register_burst``'s warps of the LR frames.  Returns (imstack
    (n, h, w[, C]), mats (n, 2, 3))."""
    rng = np.random if rng is None else rng
    if simulation:
        if im.ndim == 2:
            im = im[..., None].repeat(3, -1)
        imstack_hr, _, _, mats = make_burst(im, shift_max, theta_max, nimg,
                                            rng=rng)
        imstack = (downsample_burst(imstack_hr, scale) if scale > 1
                   else imstack_hr)
        if get_gt:
            ecc = invert_regstack(mats)
        else:
            gray = imstack.mean(-1)
            _, _, _, ecc = register_burst(gray, gray.shape[1:3])
        return imstack, ecc
    imstack = np.copy(im[:nimg], order="C")
    gray = imstack.mean(-1) if imstack.ndim == 4 else imstack
    _, _, _, ecc = register_burst(gray, gray.shape[1:3])
    return imstack, ecc


def shifted_downsampled_burst(*_args, **_kwargs):
    raise _needs_cv2("shifted_downsampled_burst")


def xy_mgrid(H, W):
    """(H*W, 2) grid of (x, y) in [-1, 1], corners included."""
    Y, X = np.mgrid[:H, :W]
    X = (2 * X / (W - 1) - 1).astype(np.float32)
    Y = (2 * Y / (H - 1) - 1).astype(np.float32)
    return np.stack([X, Y], axis=-1).reshape(-1, 2)


def invert_regstack(regstack):
    """The inverses of a stack of (2, 3) affine matrices."""
    out = np.zeros_like(regstack)
    last = np.array([[0.0, 0.0, 1.0]])
    for i in range(regstack.shape[0]):
        out[i] = np.linalg.inv(np.vstack([regstack[i], last]))[:2]
    return out


def mat2coords(reg_stack, full_res, low_res):
    """Warped [-1, 1] coordinate grids (Xs, Ys), each (n, H, W), of the
    inverses of ``reg_stack``; ``low_res`` must equal ``full_res``."""
    nimg = reg_stack.shape[0]
    H, W = full_res
    if tuple(low_res) != (H, W):
        raise _needs_cv2("mat2coords at low_res != full_res")
    Y, X = np.mgrid[:H, :W]
    coords = np.hstack((X.reshape(-1, 1), Y.reshape(-1, 1),
                        np.ones((H * W, 1))))
    Xs = np.zeros((nimg, H, W), np.float32)
    Ys = np.zeros_like(Xs)
    last = np.array([[0.0, 0.0, 1.0]])
    for i in range(nimg):
        mat = np.linalg.inv(np.vstack([reg_stack[i], last]))
        cn = coords @ mat.T
        Xs[i] = (2 * cn[:, 0].reshape(H, W) / W - 1).astype(np.float32)
        Ys[i] = (2 * cn[:, 1].reshape(H, W) / H - 1).astype(np.float32)
    return Xs, Ys


def param2theta(params, w, h):
    """Pixel-space affines -> normalized thetas of the affine_grid
    convention."""
    last = np.zeros((1, 3), np.float32)
    last[0, 2] = 1
    theta = np.zeros_like(params)
    for i in range(params.shape[0]):
        m = np.linalg.inv(np.vstack([params[i], last]))
        theta[i, 0, 0] = m[0, 0]
        theta[i, 0, 1] = m[0, 1] * h / w
        theta[i, 0, 2] = m[0, 2] * 2 / w + theta[i, 0, 0] + theta[i, 0, 1] - 1
        theta[i, 1, 0] = m[1, 0] * w / h
        theta[i, 1, 1] = m[1, 1]
        theta[i, 1, 2] = m[1, 2] * 2 / h + theta[i, 1, 0] + theta[i, 1, 1] - 1
    return theta


def affine2rigid(mats):
    """(angles, translations) of affine matrices."""
    angles = np.arccos(np.clip(mats[:, 0, 0], -1, 1))
    translations = mats[:, :, 2]
    return angles, translations


def get_transformed_coords(theta, imsize):
    """Normalized sampling grids (B, H*W, 2) of a batch of thetas over the
    pixel centres (affine_grid with align_corners=False)."""
    B = theta.shape[0]
    H, W = imsize
    xs = (2 * (np.arange(W) + 0.5) / W - 1).astype(np.float32)
    ys = (2 * (np.arange(H) + 0.5) / H - 1).astype(np.float32)
    X, Y = np.meshgrid(xs, ys)
    base = np.stack([X, Y, np.ones_like(X)], axis=-1).reshape(-1, 3)
    out = np.zeros((B, H * W, 2), np.float32)
    for i in range(B):
        out[i] = base @ theta[i].T
    return out


def interp_lr(imref, coords, downsample_scale):
    """Differentiable: the reference ``imref`` (H, W[, C]) sampled at each
    of B transformed HR grids ``coords`` (B, H*W, 2) (grid_sample,
    align_corners=False), then box-downsampled by ``downsample_scale``:
    (B, H/s, W/s, C).  Tensors in, a tensor out (numpy arrays are taken as
    float32 CPU tensors)."""
    import torch
    from wire_tpu_torch.ops.resample import area_downsample_hwc, grid_sample
    imref = torch.as_tensor(imref, dtype=torch.float32)
    coords = torch.as_tensor(coords, dtype=torch.float32,
                             device=imref.device)
    B = coords.shape[0]
    Hh, Wh = imref.shape[0], imref.shape[1]
    cf = coords.reshape(B, Hh, Wh, 2)
    hrs = torch.stack([grid_sample(imref, c, align_corners=False)
                       for c in cf]).reshape(B, Hh, Wh, -1)
    return torch.stack([area_downsample_hwc(h, downsample_scale)
                        for h in hrs])


def optical_flow(*_args, **_kwargs):
    raise _needs_cv2("optical_flow")


def ecc_flow(*_args, **_kwargs):
    raise _needs_cv2("ecc_flow")


def flow2rgb(*_args, **_kwargs):
    raise _needs_cv2("flow2rgb")


def prune_stack(*_args, **_kwargs):
    raise _needs_cv2("prune_stack")


@dataclasses.dataclass
class FrameDataset:
    """Per-frame arrays: coords (n, H*W, 2) warped HR grids, pixels
    (n, h*w, C) LR frames, masks (n, h*w, C) validity masks, all float32."""
    coords: np.ndarray
    pixels: np.ndarray
    masks: np.ndarray

    @classmethod
    def build(cls, imstack_lr, Xstack, Ystack, masks=None):
        n, Hl, Wl, c = imstack_lr.shape
        coords = np.stack([Xstack, Ystack], axis=-1).reshape(n, -1, 2)
        pixels = imstack_lr.reshape(n, -1, c)
        if masks is None:
            masks = np.ones_like(pixels)
        else:
            masks = masks.reshape(n, -1, c)
        return cls(coords.astype(np.float32), pixels.astype(np.float32),
                   masks.astype(np.float32))
