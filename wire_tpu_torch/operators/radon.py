"""Differentiable Radon transform (port of wire_tpu/operators/radon.py:
radon, _resolve_auto, RadonOp, radon_batch, _fft_size, _radon_fourier,
_radon_shear).

- ``method='rotate'``: the reference operator's semantics, per-angle
  bilinear rotation (kornia/OpenCV convention, zero padding) then row sum.
  On CUDA it is ``ops/rotsum.py:rotate_project``, the CUDA rotate-project
  kernels (angles constant, any H x W image); on the CPU ``rotate_xla``.
- ``method='rotate_xla'``: the plain gather path (the name is the JAX
  package's), ``sum(rotate(img, a), 0)`` in PyTorch ops; the only path that
  differentiates through the angles.
- ``method='fourier'``: projection-slice theorem: one oversampled 2-D FFT
  of the image, bilinear samples of the centred, fftshifted spectrum along
  each angle's central slice, one small inverse FFT per angle.  On CUDA
  the samples are one gather kernel on the unshifted spectrum that folds
  in the shift, the centring phase, the periodic halo and the un-centring,
  and its backward one scatter kernel (``ops/line_sample.py:
  sample_spectrum``): no PyTorch kernel runs between the FFTs.
- ``method='shear'``: FFT three-shear rotation, plain PyTorch (the JAX
  package has no kernel for it either).

The FFTs are ``torch.fft``.  Every method is linear in the image, so its
gradient there is exact.  The methods are different forward models: a
sinogram made by one and fitted through another plateaus several dB low,
so 'auto' is safe only when one radon() call makes and fits the
measurement.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from wire_tpu_torch.ops import line_sample as LS
from wire_tpu_torch.ops import rotsum
from wire_tpu_torch.ops.resample import angles_tensor

_TWO_PI = np.float32(2.0 * np.pi)


def radon(img, angles_degrees, *, method="auto", reference_compat=False):
    """img (H, W), angles (A,) in degrees (a sequence, numpy array or
    tensor) -> (A, W) sinogram: the sum over rows of each rotated image.

    method='auto': rotate on the CPU; on CUDA 'fourier' for 24 or more
    angles and 'shear' below that.  reference_compat=True routes 'auto' to
    'rotate', the reference's exact bilinear-rotate semantics."""
    method = _resolve_auto(method, len(angles_degrees), img.device.type,
                           reference_compat)
    if method == "rotate":
        # the kernel on CUDA (as the JAX package takes its Pallas kernel on
        # the TPU), which launches or raises; the plain gather path elsewhere
        if img.device.type == "cuda":
            return rotsum.rotate_project(img, angles_degrees)
        method = "rotate_xla"
    if method == "rotate_xla":
        return rotsum.rotate_project_plain(img, angles_degrees)
    if method == "shear":
        return _radon_shear(img, angles_tensor(angles_degrees, img.device))
    if method == "fourier":
        return _radon_fourier(img, angles_degrees)
    raise ValueError(method)


def _resolve_auto(method, n_angles, device_type, reference_compat):
    """'auto' routing: reference_compat always wins (the reference-exact
    rotate operator); otherwise fourier/shear on CUDA for speed, rotate
    elsewhere (the JAX rule with 'cuda' in the place of 'tpu')."""
    if method != "auto":
        return method
    if reference_compat:
        return "rotate"
    if device_type == "cuda":
        return "fourier" if n_angles >= 24 else "shear"
    return "rotate"


class RadonOp:
    """The Radon forward operator of one set of angles, as a callable
    ``op(field) -> sinogram``.  The angles are constants, kept on the host;
    the kernel path (rotate on the card) refuses to differentiate
    through them, ``method='rotate_xla'`` does.  For that path the
    operator keeps the kernels' angle parts on the device, made at its
    first call on a device and shape class, so a call does no host work on
    the angles."""

    def __init__(self, angles_degrees, *, method="auto",
                 reference_compat=False):
        self.angles = np.asarray(angles_degrees, np.float32).ravel()
        self.method = method
        self.reference_compat = reference_compat
        self._rotsum_parts = {}

    def __call__(self, field):
        if field.device.type == "cuda" and _resolve_auto(
                self.method, len(self.angles), "cuda",
                self.reference_compat) == "rotate":
            key = (field.device, field.shape[-2] == field.shape[-1])
            parts = self._rotsum_parts.get(key)
            if parts is None:
                parts = self._rotsum_parts[key] = rotsum.angle_parts_tensor(
                    self.angles, key[1], field.device)
            return rotsum.rotate_project(field, self.angles, parts=parts)
        return radon(field, self.angles, method=self.method,
                     reference_compat=self.reference_compat)


def radon_batch(imgs, angles_degrees, **kw):
    """(nimg, H, W) -> (nimg, A, W)."""
    return torch.stack([radon(im, angles_degrees, **kw) for im in imgs])


# ---------------------------------------------------------------------------
# FFT helpers
# ---------------------------------------------------------------------------

def _fft_size(minimum):
    """Smallest 2^a * 3^b size >= minimum (FFT-friendly)."""
    best = 1 << (int(minimum) - 1).bit_length()
    p3 = 1
    while p3 < best:
        p2 = 1
        while p2 * p3 < minimum:
            p2 *= 2
        best = min(best, p2 * p3)
        p3 *= 3
    return best


def _rfftfreq(n, device):
    return torch.arange(n // 2 + 1, dtype=torch.float32, device=device) / n


def _expi(phase):
    """exp(1j * phase) for a float32 phase, as complex64."""
    return torch.polar(torch.ones_like(phase), phase)


def _pad_center(img, P):
    H, W = img.shape
    py0, px0 = (P - H) // 2, (P - W) // 2
    return F.pad(img, (px0, P - W - px0, py0, P - H - py0)), py0, px0


# ---------------------------------------------------------------------------
# Fourier-slice path (central-slice theorem)
# ---------------------------------------------------------------------------

def _fourier_consts_of(P, theta):
    """The image-independent factors of the fourier method for angles
    theta (radians): the centring phase (P, P), the slice positions gy, gx
    (A, K) and the x un-centring phase (1, K)."""
    dev = theta.device
    c = (P - 1) / 2.0
    # phase-centre the shifted spectrum at the rotate() convention's
    # (P-1)/2 pixel centre, so the sampled function is smooth
    f = (torch.arange(P, dtype=torch.float32, device=dev) - P // 2) / P
    centre = _expi(((f[:, None] + f[None, :]) * _TWO_PI) * c)
    # the theta-rotated image's projection is the slice of F at
    # (ky, kx) = k (sin, cos)(theta), position k + P/2 in the shifted frame
    kx = _rfftfreq(P, dev)
    k_idx = kx * P
    gy = k_idx[None, :] * torch.sin(theta)[:, None] + P // 2
    gx = k_idx[None, :] * torch.cos(theta)[:, None] + P // 2
    uncentre = _expi((kx * -_TWO_PI) * c)[None, :]
    return centre, gy, gx, uncentre


@functools.lru_cache(maxsize=16)
def _cached_fourier_consts(P, key, device):
    return _fourier_consts_of(P, torch.deg2rad(torch.tensor(
        key, dtype=torch.float32, device=device)))


def _fourier_consts(P, angles_degrees, device):
    """Cached for constant angles (a sequence or numpy array); computed
    from a tensor each call, so autograd follows it."""
    if isinstance(angles_degrees, torch.Tensor):
        return _fourier_consts_of(P, torch.deg2rad(
            angles_degrees.to(device, torch.float32)))
    key = tuple(np.asarray(angles_degrees, np.float32).ravel().tolist())
    return _cached_fourier_consts(P, key, torch.device(device))


def _radon_fourier(img, angles_degrees, oversample=4, sampler="auto"):
    """Radon via the projection-slice theorem: ONE 2-D FFT of the padded
    image, bilinear samples of the spectrum along each angle's central
    slice, one 1-D inverse FFT per angle.  Interpolation is Fourier-domain
    bilinear with ``oversample``x zero padding, so it differs from
    rotate/shear to interpolation error.

    sampler='auto' samples through ``sample_spectrum`` (the CUDA gather and
    scatter kernels for CUDA tensors); 'plain' through its plain version on
    any device (the JAX package's sampler='xla')."""
    H, W = img.shape
    S = max(H, W)
    P = _fft_size(oversample * S)
    pad, _, px0 = _pad_center(img, P)
    centre, gy, gx, uncentre = _fourier_consts(P, angles_degrees, img.device)
    sample = {"auto": LS.sample_spectrum,
              "plain": LS.sample_spectrum_plain}[sampler]

    # the slice of the full 2-D DFT, fftshift-ed and phase-centred, with the
    # x centring phase undone; then back to the spatial projection
    slice_hat = sample(torch.fft.fftn(pad), centre, gy, gx, uncentre)
    proj = torch.fft.irfft(slice_hat, n=P, dim=1)
    return proj[:, px0:px0 + W]


# ---------------------------------------------------------------------------
# FFT three-shear path
# ---------------------------------------------------------------------------

def _shear_x_from_rfft(Fr, ty, P):
    """Per-row fractional translate from the row rfft (batched over a
    leading axis): out[..., y, x] = in[..., y, x - ty[..., y]]."""
    k = _rfftfreq(P, ty.device)
    phase = (k * -_TWO_PI)[None, None, :] * ty[..., None]
    return torch.fft.irfft(Fr * _expi(phase), n=P, dim=-1)


def _shear_x(im, ty):
    return _shear_x_from_rfft(torch.fft.rfft(im, dim=-1), ty, im.shape[-1])


def _shear_y(im, tx):
    n = im.shape[-2]
    Fr = torch.fft.rfft(im, dim=-2)
    k = _rfftfreq(n, im.device)
    phase = (k * -_TWO_PI)[None, :, None] * tx[:, None, :]
    return torch.fft.irfft(Fr * _expi(phase), n=n, dim=-2)


def _radon_shear(img, angles_degrees):
    """Each rotation is a lattice-exact 90-degree pre-rotation plus a
    residual in [-45, 45] degrees applied as three Fourier-phase shears of
    the 2x-padded image (periodic-sinc interpolation)."""
    H, W = img.shape
    S = max(H, W)
    P = _fft_size(int(np.ceil(1.6 * S)) + 2)
    pad, _, px0 = _pad_center(img, P)
    dev = img.device
    cy = (P - 1) / 2.0
    yy = torch.arange(P, dtype=torch.float32, device=dev) - cy
    xx = yy

    theta = torch.deg2rad(angles_degrees.to(torch.float32))
    k = torch.clamp(torch.round(theta / (math.pi / 2)).to(torch.int64), 0, 2)
    phi = theta - k.to(torch.float32) * (math.pi / 2)

    # three 90-degree pre-rotations (exact); their row rffts are shared by
    # every angle with the same k
    variants = torch.stack([pad, torch.rot90(pad, 1, dims=(0, 1)),
                            torch.rot90(pad, 2, dims=(0, 1))])
    F1 = torch.fft.rfft(variants, dim=2)[k]

    # inverse-warp shears for dst(x, y) = src(R(phi)(x, y)):
    # R(phi) = Shx(a) Shy(b) Shx(a), a = tan(phi / 2), b = -sin(phi)
    a = torch.tan(phi / 2)
    b = -torch.sin(phi)
    im1 = _shear_x_from_rfft(F1, a[:, None] * yy[None, :], P)
    im2 = _shear_y(im1, b[:, None] * xx[None, :])
    im3 = _shear_x(im2, a[:, None] * yy[None, :])
    return torch.sum(im3, dim=1)[:, px0:px0 + W]
