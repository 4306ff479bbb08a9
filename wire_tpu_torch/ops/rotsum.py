"""Rotate-and-row-sum, the reference-exact Radon operator: the hand-written
CUDA kernels (``csrc/rotsum.cu``) and their plain PyTorch version.

Replaces wire_tpu/ops/pallas/rotsum.py:rotate_project (forward and adjoint
Pallas calls).  ``rotate_project(img, angles)`` maps an (H, W) image and
(A,) angles in degrees to the (A, W) sinogram
``sino[a] = sum_y rotate(img, angles[a])[y]``.

Host side (rotsum.py:_angle_parts, _variant_planes, _fold_variants): for a
square image each angle is split as theta = 90 k + phi with |phi| <= 45
deg, and the kernel reads the lattice-exact rot90(img, k) plane and
rotates by phi only.  A non-square image (rot90 would change its shape) is
one plane rotated by the whole angle, with the plain version's own cos and
sin.  The TPU planes are zero-padded to a 128-multiple for block slicing;
the CUDA kernels bounds-check every tap, so the planes here are the
(H, W) images and no row outside them enters a sum.

The gradient flows to the image through a ``torch.autograd.Function``
whose backward is the adjoint kernel.  The angles are constants: a tensor
that requires grad raises, pointing to the plain method ``rotate_xla``
(operators/radon.py), which autograd differentiates in the angles too.

``rotate_project`` runs the plain version for tensors on the CPU, and for
CUDA tensors launches the kernels or raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from wire_tpu_torch.ops import build
from wire_tpu_torch.ops.resample import angles_tensor, rotate

# kernel launches of this module, by direction: a run resets and reads them
launches = {"forward": 0, "adjoint": 0}


def rotate_project_plain(img, angles_degrees):
    """``sum(rotate(img, a), 0)`` for every angle: (A, S) for an (H, W)
    image; autograd differentiates it in the image and the angles."""
    angles = angles_tensor(angles_degrees, img.device)
    return torch.sum(rotate(img, angles[:, None, None]), dim=-2)


def whole_angle_parts(angles_degrees):
    """(cos theta, sin theta, 0) as numpy arrays, computed as ``rotate``
    computes them (float32 radians, torch's cos and sin): the parts of a
    non-square image's single plane."""
    t = torch.as_tensor(np.asarray(angles_degrees, np.float32)) * (
        math.pi / 180.0)
    return (torch.cos(t).numpy(), torch.sin(t).numpy(),
            np.zeros(t.shape, np.int32))


def angle_parts(angles_degrees):
    """(cos phi, sin phi, k) as numpy float32/int32 arrays, with
    theta = 90 k + phi, k in 0..3 (mod 360), |phi| <= 45 deg."""
    theta = np.asarray(angles_degrees, np.float32)
    k = np.round(theta / np.float32(90.0)).astype(np.int32)
    phi = np.deg2rad(theta - k.astype(np.float32) * np.float32(90.0))
    return (np.cos(phi).astype(np.float32), np.sin(phi).astype(np.float32),
            (k % 4).astype(np.int32))


def variant_planes(img):
    """The four lattice-exact 90-degree pre-rotations of a square image,
    (4, S, S): rotate(img, 90 k + phi) == rotate(rot90(img, k), phi)."""
    return torch.stack([torch.rot90(img, k, dims=(0, 1))
                        for k in range(4)]).contiguous()


def fold_variants(planes):
    """Adjoint of ``variant_planes``: un-rotate each plane and sum."""
    return (planes[0] + torch.rot90(planes[1], -1, dims=(0, 1))
            + torch.rot90(planes[2], -2, dims=(0, 1))
            + torch.rot90(planes[3], -3, dims=(0, 1)))


def sample_flops(A, S):
    """fp32 operations of one direction: A * S * S bilinear samples of 4
    weighted taps (4 products, 3 sums, the 2 x 2 weights) plus the sum."""
    return 10 * A * S * S


_PTR = ctypes.c_void_p
_INT = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("rotsum")
    for fn in (lib.rotsum_forward, lib.rotsum_adjoint):
        fn.argtypes = [_PTR] * 5 + [_INT] * 4 + [_PTR]
        fn.restype = _INT
    lib.rotsum_error_string.argtypes = [_INT]
    lib.rotsum_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=64)
def _device_parts(key, square, device):
    parts = angle_parts if square else whole_angle_parts
    cphi, sphi, kidx = parts(np.asarray(key, np.float32))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (cphi, sphi, kidx))


def _run(fn, what, ptrs, A, P, H, W, device):
    lib = _lib()
    rc = getattr(lib, fn)(*[t.data_ptr() for t in ptrs], A, P, H, W,
                          torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rotsum {what} kernel launch failed: CUDA error "
                           f"{rc} ({lib.rotsum_error_string(rc).decode()})")
    launches[what] += 1


class _RotateProject(torch.autograd.Function):

    @staticmethod
    def forward(ctx, img, cphi, sphi, kidx):
        H, W = img.shape
        A = cphi.shape[0]
        square = H == W
        planes = variant_planes(img) if square else img[None].contiguous()
        sino = torch.empty((A, W), dtype=torch.float32, device=img.device)
        _run("rotsum_forward", "forward", (planes, cphi, sphi, kidx, sino),
             A, planes.shape[0], H, W, img.device)
        ctx.save_for_backward(cphi, sphi, kidx)
        ctx.shape = (planes.shape[0], H, W)
        return sino

    @staticmethod
    def backward(ctx, cot):
        cphi, sphi, kidx = ctx.saved_tensors
        P, H, W = ctx.shape
        A = cot.shape[0]
        cot = cot.to(torch.float32).contiguous()
        planes_bar = torch.empty((P, H, W), dtype=torch.float32,
                                 device=cot.device)
        _run("rotsum_adjoint", "adjoint", (cot, cphi, sphi, kidx, planes_bar),
             A, P, H, W, cot.device)
        img_bar = fold_variants(planes_bar) if P == 4 else planes_bar[0]
        return img_bar, None, None, None


def rotate_project(img, angles_degrees):
    """(H, W) image, (A,) angles in degrees -> (A, W) sinogram, the
    reference operator ``sum_y rotate(img, angle)[y]``, differentiable in
    the image.  The angles are constants (a sequence, a numpy array or a
    tensor that does not require grad)."""
    if isinstance(angles_degrees, torch.Tensor):
        if angles_degrees.requires_grad:
            raise ValueError(
                "rotate_project treats the projection ANGLES as constants: "
                "it cannot differentiate through them.  Use radon(..., "
                "method='rotate_xla') to differentiate through angles "
                "(see operators/radon.py).")
        angles_degrees = angles_degrees.detach().cpu().numpy()
    key = tuple(np.asarray(angles_degrees, np.float32).ravel().tolist())
    if img.device.type == "cpu":
        return rotate_project_plain(img, np.asarray(key, np.float32))
    if img.device.type != "cuda":
        raise ValueError(f"rotate_project: unsupported device {img.device}")
    if img.ndim != 2:
        raise ValueError(f"rotate_project: the kernel needs an (H, W) "
                         f"image, got {tuple(img.shape)}")
    if img.dtype != torch.float32:
        raise TypeError(f"rotate_project: image has dtype {img.dtype}, "
                        f"expected float32")
    cphi, sphi, kidx = _device_parts(key, img.shape[0] == img.shape[1],
                                     img.device)
    return _RotateProject.apply(img, cphi, sphi, kidx)
