"""Multi-frame super-resolution data: synthetic shifted/rotated bursts,
Euclidean transforms, registration, flow and frame datasets (port of
wire_tpu/signals/motion.py).

The port has no cv2.  Where wire_tpu calls it, the port has its own
version of what cv2 computes: the resizes (``signals/image.py``:
``resize_area`` and ``resize_linear``, INTER_AREA and INTER_LINEAR),
the ECC alignment and Farnebäck flow (``signals/align.py``), and the
HSV colouring of ``flow2rgb``.  Where wire_tpu has a branch without cv2,
the port takes that branch:

- ``make_burst``         random Euclidean warps of an HR image (numpy
                         bilinear remap, zero border) and the per-frame
                         warped coordinate grids in [-1, 1], resized
                         linearly at ``scale != 1``
- ``downsample_burst``   per-frame box mean
- ``shifted_downsampled_burst``  shift, then rotate about the centre;
                         area-resized grids, bilinear frames
- ``pyramid_register``   coarse-to-fine rigid registration: an FFT phase
                         correlation over trial rotations at the coarsest
                         level, then Gauss-Newton refinement
                         (``native.rigid_register``) at each level
- ``register_burst``     every frame against frame 0, and the warped HR
                         coordinate grids of the inverted warps
- ``optical_flow``, ``ecc_flow``, ``flow2rgb``  dense Farnebäck flow, ECC
                         alignment of a pair, the HSV picture of a flow
- ``prune_stack``        frames whose warped difference to frame 0 is
                         large, dropped (the warp on the device)
- ``FrameDataset``       per-frame (coords, pixels, mask) arrays

plus the affine toolbox (``xy_mgrid``, ``invert_regstack``, ``mat2coords``,
``param2theta``, ``affine2rigid``, ``get_transformed_coords``) and the
differentiable ``interp_lr`` on torch tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# the frames' bilinear sampler, zero outside: wire_tpu's numpy remap
from wire_tpu_torch.signals.align import remap as _remap
from wire_tpu_torch.signals.image import _fma32


def euclidean_matrix(theta, shift):
    """The 2 x 3 rigid transform of angle ``theta`` and ``shift``."""
    return np.array([[np.cos(theta), -np.sin(theta), shift[0]],
                     [np.sin(theta), np.cos(theta), shift[1]]])


def make_burst(im, shift_max=10, theta_max=np.pi / 12, nframes=5, rng=None,
               scale=1):
    """``nframes`` randomly shifted and rotated copies of ``im`` (H, W, 3)
    and their warped coordinate grids: (imstack (n, h, w, 3), Xstack
    (n, h, w), Ystack, mats (n, 2, 3)), X and Y normalized to [-1, 1];
    frame 0 is the identity.  (h, w) = (int(H / scale), int(W / scale)):
    at ``scale != 1`` the grids are resized linearly to it before the
    frames are sampled at them.  ``rng`` is a np.random.RandomState (the global one by
    default)."""
    from wire_tpu_torch.signals.image import resize_linear
    rng = np.random if rng is None else rng
    H, W, _ = im.shape
    shifts = rng.randint(-shift_max, shift_max, size=[nframes, 2])
    thetas = (2 * rng.rand(nframes) - 1) * theta_max
    shifts[0, :] = 0
    thetas[0] = 0

    Y, X = np.mgrid[:H, :W]
    ones = np.ones((H * W, 1))
    coords = np.hstack((X.reshape(-1, 1), Y.reshape(-1, 1), ones))

    Hl, Wl = int(H / scale), int(W / scale)
    imstack = np.zeros((nframes, Hl, Wl, 3), np.float32)
    Xstack = np.zeros((nframes, Hl, Wl), np.float32)
    Ystack = np.zeros_like(Xstack)
    mats = np.zeros((nframes, 2, 3))
    for idx in range(nframes):
        mat = euclidean_matrix(thetas[idx], shifts[idx])
        mats[idx] = mat
        cn = coords @ mat.T
        Xn = cn[:, 0].reshape(H, W).astype(np.float32)
        Yn = cn[:, 1].reshape(H, W).astype(np.float32)
        if scale != 1:
            Xn = resize_linear(Xn, dsize=(Wl, Hl))
            Yn = resize_linear(Yn, dsize=(Wl, Hl))
        imstack[idx] = _remap(im, Xn, Yn)
        Xstack[idx] = 2 * Xn / W - 1
        Ystack[idx] = 2 * Yn / H - 1
    return imstack, Xstack, Ystack, mats


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


def shifted_downsampled_burst(im, scale, shift_max=10,
                              theta_max=np.pi / 12, nshifts=5,
                              perturb_coords=False, rng=None):
    """A burst of ``nshifts`` frames of the grey image ``im`` (H, W), each
    shifted by a random integer (frame 0 by none) and then rotated about
    the image centre by a random angle: the warped pixel grids are
    area-resized to (int(H / scale), int(W / scale)) and the frames
    sampled at them (bilinear, zero outside).  ``perturb_coords`` adds unit
    normal noise to the grids after sampling.  Returns (imstack (n, h, w),
    Xstack, Ystack in [-1, 1])."""
    from wire_tpu_torch.signals.image import resize_area
    rng = np.random if rng is None else rng
    H, W = im.shape
    shifts = rng.randint(-shift_max, shift_max, size=[nshifts, 2])
    thetas = (2 * rng.rand(nshifts) - 1) * theta_max
    shifts[0, :] = 0
    thetas[0] = 0
    Y, X = np.mgrid[:H, :W]
    Hl, Wl = int(H / scale), int(W / scale)
    imstack = np.zeros((nshifts, Hl, Wl), np.float32)
    Xstack = np.zeros_like(imstack)
    Ystack = np.zeros_like(imstack)
    for i in range(nshifts):
        Xs = X - shifts[i, 1]
        Ys = Y - shifts[i, 0]
        c, s = np.cos(thetas[i]), np.sin(thetas[i])
        Xr = (Xs - W / 2) * c - (Ys - H / 2) * s + W / 2
        Yr = (Xs - W / 2) * s + (Ys - H / 2) * c + H / 2
        Xn = resize_area(Xr.astype(np.float32), dsize=(Wl, Hl))
        Yn = resize_area(Yr.astype(np.float32), dsize=(Wl, Hl))
        imstack[i] = _remap(im.astype(np.float32), Xn, Yn)
        if perturb_coords:
            Xn = Xn + rng.randn(Hl, Wl).astype(np.float32)
            Yn = Yn + rng.randn(Hl, Wl).astype(np.float32)
        Xstack[i] = 2 * Xn / W - 1
        Ystack[i] = 2 * Yn / H - 1
    return imstack, Xstack, Ystack


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
    inverses of ``reg_stack`` over the ``full_res`` (H, W) pixel grid,
    area-resized to ``low_res`` (h, w): each (n, h, w)."""
    from wire_tpu_torch.signals.image import resize_area
    nimg = reg_stack.shape[0]
    H, W = full_res
    Hl, Wl = low_res
    Y, X = np.mgrid[:H, :W]
    coords = np.hstack((X.reshape(-1, 1), Y.reshape(-1, 1),
                        np.ones((H * W, 1))))
    Xs = np.zeros((nimg, Hl, Wl), np.float32)
    Ys = np.zeros_like(Xs)
    last = np.array([[0.0, 0.0, 1.0]])
    for i in range(nimg):
        mat = np.linalg.inv(np.vstack([reg_stack[i], last]))
        cn = coords @ mat.T
        Xn = (2 * cn[:, 0].reshape(H, W) / W - 1).astype(np.float32)
        Yn = (2 * cn[:, 1].reshape(H, W) / H - 1).astype(np.float32)
        if (Hl, Wl) != (H, W):
            Xn = resize_area(Xn, dsize=(Wl, Hl))
            Yn = resize_area(Yn, dsize=(Wl, Hl))
        Xs[i], Ys[i] = Xn, Yn
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


def optical_flow(frame1, frame2):
    """Dense Farnebäck flow from ``frame1`` to ``frame2`` (pyramid scale
    0.5, 3 levels, a 15-pixel box window, 3 iterations, poly_n 5, sigma
    1.2; ``signals/align.py:farneback_flow``) and ``frame2`` sampled along
    it, bilinear.  Float frames are first scaled by their joint max to
    bytes, as 8-bit frames are what the flow takes.  Returns (flow (H, W, 2)
    float32, warped float32)."""
    from wire_tpu_torch.signals.align import farneback_flow
    H, W = frame1.shape
    Y, X = np.mgrid[:H, :W]
    f1, f2 = frame1, frame2
    if f1.dtype != np.uint8:
        scale = max(f1.max(), f2.max(), 1e-8)
        f1 = np.clip(f1 / scale * 255, 0, 255).astype(np.uint8)
        f2 = np.clip(f2 / scale * 255, 0, 255).astype(np.uint8)
    flow = farneback_flow(f1, f2, 0.5, 3, 15, 3, 5, 1.2)
    warped = _remap(frame2.astype(np.float32),
                   (X + flow[..., 0]).astype(np.float32),
                   (Y + flow[..., 1]).astype(np.float32))
    return flow, warped


def ecc_flow(im1, im2, motion="homography", niters=1000, eps=-1):
    """ECC alignment of ``im2`` to ``im1`` (``signals/align.py:
    find_transform_ecc`` from the identity, a 5-tap Gaussian pre-filter;
    ``motion`` one of translation, euclidean, affine, homography): returns
    (warp float32 (2, 3) or (3, 3), im2 warped onto im1's grid by it,
    flow (H, W, 2) float32), the flow being the warp's displacement of each
    pixel normalised to [-1, 1] units (dx 2/W, dy 2/H)."""
    from wire_tpu_torch.signals.align import find_transform_ecc, warp
    H, W = im1.shape[:2]
    init = (np.eye(3, dtype=np.float32) if motion == "homography"
            else np.eye(2, 3, dtype=np.float32))
    _, mat = find_transform_ecc(im1.astype(np.float32),
                                im2.astype(np.float32), init, motion,
                                niters, eps, gauss_size=5)
    aligned = warp(im2, mat, (H, W))
    Y, X = np.mgrid[:H, :W]
    coords = np.stack([X.ravel(), Y.ravel(), np.ones(H * W)], axis=0)
    cn = mat @ coords
    if motion == "homography":
        cn = cn[:2] / cn[2]
    flow = np.zeros((H, W, 2), np.float32)
    flow[..., 0] = (cn[0] - coords[0]).reshape(H, W) * (2 / W)
    flow[..., 1] = (cn[1] - coords[1]).reshape(H, W) * (2 / H)
    return mat, aligned, flow


# OpenCV's polynomial arctangent (degrees) and its sector table of HSV -> RGB
_ATAN_P = tuple(np.float32(p * np.float32(180 / np.pi)) for p in (
    0.9997878412794807, -0.3258083974640975, 0.1555786518463281,
    -0.04432655554792128))
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                         [0, 1, 3], [2, 1, 0]])


def _cart_to_polar(x, y):
    """``cv2.cartToPolar(x, y)`` of float32 arrays: (magnitude, angle in
    radians in [0, 2 pi)), the angle by OpenCV's polynomial arctangent."""
    f32 = np.float32
    mag = np.sqrt(_fma32(x, x, (y * y).astype(f32)))
    ax, ay = np.abs(x), np.abs(y)
    c = (np.minimum(ax, ay)
         / (np.maximum(ax, ay) + f32(np.finfo(np.float64).eps))).astype(f32)
    cc = (c * c).astype(f32)
    p1, p3, p5, p7 = _ATAN_P
    a = (_fma32(_fma32(_fma32(cc, p7, p5), cc, p3), cc, p1) * c).astype(f32)
    a = np.where(ax >= ay, a, f32(90) - a)
    a = np.where(x < 0, f32(180) - a, a)
    a = np.where(y < 0, f32(360) - a, a)
    return mag, (a * f32(np.pi / 180)).astype(f32)


def _minmax_255(v):
    """``cv2.normalize(v, None, 0, 255, NORM_MINMAX)`` of a float32 array:
    v scale + shift with the scale and shift rounded to float32."""
    lo, hi = float(v.min()), float(v.max())
    scale = 255.0 * (1.0 / (hi - lo) if hi - lo > np.finfo(float).eps
                     else 0.0)
    scale = float(np.float32(scale))
    shift = -float(np.float32(lo * scale))
    return _fma32(v, np.float32(scale), np.float32(shift))


def _hsv_to_rgb(hsv):
    """``cv2.cvtColor(hsv, COLOR_HSV2RGB)`` of a uint8 (H, W, 3) image, hue
    in [0, 180), by OpenCV's vector rule: float32 h = 6 H / 180, s = S /
    255, v = V / 255, the sector floor(h) and its fraction f, the ramps
    v (1 - s f) and v (1 - s (1 - f)) with s f fused into one rounding,
    and each channel 255 x truncated to a byte.  (OpenCV converts the last
    W mod 32 pixels of a row on its scalar path, which rounds instead; a
    byte there can be one higher.)"""
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * f32(6 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1 / 255.0)
    h = np.fmod(h, f32(6))
    sector = np.floor(h).astype(np.int64)
    f = (h - sector).astype(f32)
    one = f32(1)
    tab = np.stack([v, v * (one - s), v * _fma32(-s, f, one),
                    v * _fma32(-s, (one - f).astype(f32), one)],
                   -1).astype(f32)
    bgr = np.take_along_axis(tab, _HSV_SECTORS[sector % 6], -1)
    rgb = (bgr[..., ::-1] * f32(255)).astype(f32)
    return np.clip(np.trunc(rgb), 0, 255).astype(np.uint8)


def flow2rgb(flow):
    """The HSV picture of a flow (H, W, 2) as uint8 RGB: hue the angle
    (degrees / 2, truncated to a byte), full saturation, value the
    magnitude min-max normalised to [0, 255] and truncated; converted to
    RGB by ``_hsv_to_rgb``."""
    H, W, _ = flow.shape
    hsv = np.zeros((H, W, 3), dtype=np.uint8)
    hsv[..., 1] = 255
    mag, ang = _cart_to_polar(np.asarray(flow[..., 0], np.float32),
                              np.asarray(flow[..., 1], np.float32))
    f32 = np.float32
    hsv[..., 0] = ang * f32(180) / f32(np.pi) / f32(2)
    hsv[..., 2] = _minmax_255(mag)
    return _hsv_to_rgb(hsv)


def prune_stack(imstack, ecc_mats, full_res, thres=1.0, device=None):
    """Drop the frames registered badly: frame 0 is area-resized to
    ``full_res`` (H, W), warped by each frame's matrix over the frames' own
    pixel grid (``ops/resample.py:bilinear_sample`` on ``device``, the card
    unless a CPU device is given) and compared with the frame; a frame is
    kept where its mean relative difference |warped - frame| / (frame +
    0.01 max) is under ``thres``.  Returns numpy (kept frames, their
    matrices, the keep mask (n,), the absolute differences (n, h, w))."""
    import torch
    from wire_tpu_torch.ops.resample import bilinear_sample
    from wire_tpu_torch.device import resolve
    from wire_tpu_torch.signals.image import resize_area
    dev = resolve(device)
    nimg, Hl, Wl = imstack.shape[:3]
    H, W = full_res
    imref = torch.as_tensor(resize_area(imstack[0], dsize=(W, H)),
                            device=dev)
    Y, X = np.mgrid[:Hl, :Wl]
    diffs = []
    for i in range(nimg):
        m = ecc_mats[i]
        xs = m[0, 0] * X + m[0, 1] * Y + m[0, 2]
        ys = m[1, 0] * X + m[1, 1] * Y + m[1, 2]
        warped = bilinear_sample(
            imref, torch.as_tensor(xs, dtype=torch.float32, device=dev),
            torch.as_tensor(ys, dtype=torch.float32, device=dev))
        diffs.append(np.abs(warped.cpu().numpy() - imstack[i]))
    imdiff = np.stack(diffs)
    denom = imstack + 1e-2 * imstack.max()
    diff_array = (imdiff / denom).mean((-1, -2))
    mask = diff_array < thres
    return (np.copy(imstack[mask]), np.copy(ecc_mats[mask]), mask, imdiff)


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
