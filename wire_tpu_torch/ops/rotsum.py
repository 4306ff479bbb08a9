"""Rotate-and-row-sum, the reference-exact Radon operator: the hand-written
CUDA kernels (``csrc/rotsum.cu``) and their plain PyTorch version.

Replaces wire_tpu/ops/pallas/rotsum.py:rotate_project (forward and adjoint
Pallas calls).  ``rotate_project(img, angles)`` maps an (H, W) image and
(A,) angles in degrees to the (A, W) sinogram
``sino[a] = sum_y rotate(img, angles[a])[y]``.

Host side: for a square image each angle is split as theta = 90 k + phi
with |phi| <= 45 deg, and the kernels read the lattice-exact
rot90(img, k) through an index map (``plane_index``) and rotate by phi
only; no rotated plane is built in device memory, and the adjoint writes
the image's gradient directly.  A non-square image (rot90 would change its
shape) takes k = 0 and the whole angle, with the plain version's own cos
and sin.  The parts (cos phi, sin phi, k) are one (3, A) tensor on the
device, made once per operator (``angle_parts_tensor``; ``RadonOp`` keeps
it), so a call is one autograd Function, one forward kernel and one
adjoint kernel.  The TPU planes are zero-padded to a 128-multiple for
block slicing; the CUDA kernels bounds-check every tap instead.

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


def angle_parts_tensor(angles_degrees, square, device):
    """The kernels' angle parts, (3, A) float32 on ``device``: cos phi,
    sin phi and k (``angle_parts`` for a square image, else
    ``whole_angle_parts``)."""
    parts = angle_parts if square else whole_angle_parts
    cphi, sphi, k = parts(np.asarray(angles_degrees, np.float32).ravel())
    return torch.from_numpy(np.stack([cphi, sphi, k.astype(np.float32)])).to(
        device)


def plane_index(S, k):
    """(rows, cols), each (S, S) int64, with rot90(img, k)[i, j] =
    img[rows[i, j], cols[i, j]]: the index map the kernels apply to a square
    image (csrc/rotsum.cu:tap), and, read backwards, the adjoint's."""
    i, j = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    rows, cols = ((i, j), (j, S - 1 - i), (S - 1 - i, S - 1 - j),
                  (S - 1 - j, i))[k % 4]
    return torch.from_numpy(rows.copy()), torch.from_numpy(cols.copy())


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
        fn.argtypes = [_PTR] * 3 + [_INT] * 3 + [_PTR]
        fn.restype = _INT
    lib.rotsum_error_string.argtypes = [_INT]
    lib.rotsum_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=64)
def _device_parts(key, square, device):
    return angle_parts_tensor(np.asarray(key, np.float32), square, device)


def _run(what, a, parts, out, A, H, W):
    lib = _lib()
    fn = lib.rotsum_forward if what == "forward" else lib.rotsum_adjoint
    rc = fn(a.data_ptr(), parts.data_ptr(), out.data_ptr(), A, H, W,
            torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rotsum {what} kernel launch failed: CUDA error "
                           f"{rc} ({lib.rotsum_error_string(rc).decode()})")
    launches[what] += 1


class _RotateProject(torch.autograd.Function):

    @staticmethod
    def forward(ctx, img, parts):
        H, W = img.shape
        A = parts.shape[1]
        sino = torch.empty((A, W), dtype=torch.float32, device=img.device)
        _run("forward", img, parts, sino, A, H, W)
        ctx.save_for_backward(parts)
        ctx.shape = (H, W)
        return sino

    @staticmethod
    def backward(ctx, cot):
        (parts,) = ctx.saved_tensors
        H, W = ctx.shape
        A = parts.shape[1]
        cot = cot.to(torch.float32).contiguous()
        img_bar = torch.empty((H, W), dtype=torch.float32, device=cot.device)
        _run("adjoint", cot, parts, img_bar, A, H, W)
        return img_bar, None


def rotate_project(img, angles_degrees, parts=None):
    """(H, W) image, (A,) angles in degrees -> (A, W) sinogram, the
    reference operator ``sum_y rotate(img, angle)[y]``, differentiable in
    the image.  The angles are constants (a sequence, a numpy array or a
    tensor that does not require grad).  ``parts``, the angles'
    ``angle_parts_tensor`` on the image's device for its squareness, spares
    a caller that holds them (``RadonOp``) their lookup."""
    if isinstance(angles_degrees, torch.Tensor):
        if angles_degrees.requires_grad:
            raise ValueError(
                "rotate_project treats the projection ANGLES as constants: "
                "it cannot differentiate through them.  Use radon(..., "
                "method='rotate_xla') to differentiate through angles "
                "(see operators/radon.py).")
        angles_degrees = angles_degrees.detach().cpu().numpy()
    if img.device.type == "cpu":
        return rotate_project_plain(
            img, np.asarray(angles_degrees, np.float32).ravel())
    if img.device.type != "cuda":
        raise ValueError(f"rotate_project: unsupported device {img.device}")
    if img.ndim != 2:
        raise ValueError(f"rotate_project: the kernel needs an (H, W) "
                         f"image, got {tuple(img.shape)}")
    if img.dtype != torch.float32:
        raise TypeError(f"rotate_project: image has dtype {img.dtype}, "
                        f"expected float32")
    if parts is None:
        key = tuple(np.asarray(angles_degrees, np.float32).ravel().tolist())
        parts = _device_parts(key, img.shape[0] == img.shape[1], img.device)
    return _RotateProject.apply(img.contiguous(), parts)
