"""Bilinear sampling of a 2-D spectrum along radial lines, the hot gather
and scatter of the Fourier-slice Radon operator: the hand-written CUDA
kernels (``csrc/line_sample.cu``) and their plain PyTorch version.

Replaces wire_tpu/ops/pallas/line_sample.py:sample_lines (gather and
scatter Pallas calls); ``sample_lines_plain`` is the port of
``sample_lines_xla``, the JAX package's fallback and oracle.

Contract (established by operators/radon.py): ``fre``, ``fim`` are the real
and imaginary (Ph, Ph) planes of the fftshifted spectrum with 2 periodic
halo lines on the high side (Ph = P + 2; the TPU's 128-line halo was a lane
artifact); ``gy``, ``gx`` are (A, K) float positions with
0 <= floor(g) and floor(g) + 1 <= Ph - 1.  The result is the (A, K) re and
im samples; the gradient flows to the planes through a
``torch.autograd.Function`` whose backward is the scatter kernel.  The
positions are constants.

``sample_lines`` runs the plain version for tensors on the CPU, and for
CUDA tensors launches the kernels or raises; there is no fallback.  The
scatter adds with float atomics, so its last bits vary from run to run.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from wire_tpu_torch.ops import build

# kernel launches of this module, by direction: a run resets and reads them
launches = {"gather": 0, "scatter": 0}


def sample_lines_plain(fre, fim, gy, gx):
    """Bilinear samples of both planes at (gy, gx) by indexing; autograd's
    backward is the scatter-add."""
    y0 = torch.floor(gy)
    x0 = torch.floor(gx)
    wy = gy - y0
    wx = gx - x0
    y0 = y0.to(torch.int64)
    x0 = x0.to(torch.int64)

    def bil(f):
        v00 = f[y0, x0]
        v01 = f[y0, x0 + 1]
        v10 = f[y0 + 1, x0]
        v11 = f[y0 + 1, x0 + 1]
        return ((1 - wy) * ((1 - wx) * v00 + wx * v01)
                + wy * ((1 - wx) * v10 + wx * v11))
    return bil(fre), bil(fim)


def sample_flops(A, K):
    """fp32 operations of one direction: per sample and plane, 4 weighted
    taps (4 products, 3 sums) and the 2 x 2 weights."""
    return 2 * 9 * A * K


_PTR = ctypes.c_void_p
_INT = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("line_sample")
    for fn in (lib.line_sample_gather, lib.line_sample_scatter):
        fn.argtypes = [_PTR] * 6 + [_INT, _INT, _PTR]
        fn.restype = _INT
    lib.line_sample_error_string.argtypes = [_INT]
    lib.line_sample_error_string.restype = ctypes.c_char_p
    return lib


def _run(fn, what, ptrs, n, ph, device):
    lib = _lib()
    rc = getattr(lib, fn)(*[t.data_ptr() for t in ptrs], n, ph,
                          torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"line_sample {what} kernel launch failed: CUDA error {rc} "
            f"({lib.line_sample_error_string(rc).decode()})")
    launches[what] += 1


class _SampleLines(torch.autograd.Function):

    @staticmethod
    def forward(ctx, fre, fim, gy, gx):
        ph = fre.shape[0]
        sre = torch.empty(gy.shape, dtype=torch.float32, device=gy.device)
        sim = torch.empty_like(sre)
        _run("line_sample_gather", "gather", (fre, fim, gy, gx, sre, sim),
             gy.numel(), ph, gy.device)
        ctx.save_for_backward(gy, gx)
        ctx.ph = ph
        return sre, sim

    @staticmethod
    def backward(ctx, gre, gim):
        gy, gx = ctx.saved_tensors
        ph = ctx.ph
        gre = gre.to(torch.float32).contiguous()
        gim = gim.to(torch.float32).contiguous()
        fre_bar = torch.empty((ph, ph), dtype=torch.float32, device=gy.device)
        fim_bar = torch.empty_like(fre_bar)
        _run("line_sample_scatter", "scatter",
             (gre, gim, gy, gx, fre_bar, fim_bar), gy.numel(), ph, gy.device)
        return fre_bar, fim_bar, None, None


def _check(name, t, device):
    if t.device != device:
        raise ValueError(f"sample_lines: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype != torch.float32:
        raise TypeError(f"sample_lines: {name} has dtype {t.dtype}, "
                        f"expected float32")


def sample_lines(fre, fim, gy, gx):
    """(Ph, Ph) re/im planes, (A, K) positions -> (A, K) re/im bilinear
    samples, differentiable in the planes."""
    if fre.device.type == "cpu":
        return sample_lines_plain(fre, fim, gy, gx)
    if fre.device.type != "cuda":
        raise ValueError(f"sample_lines: unsupported device {fre.device}")
    for name, t in (("fre", fre), ("fim", fim), ("gy", gy), ("gx", gx)):
        _check(name, t, fre.device)
    if fre.ndim != 2 or fre.shape[0] != fre.shape[1] or \
            fim.shape != fre.shape:
        raise ValueError(f"sample_lines: planes must be square and alike, "
                         f"got {tuple(fre.shape)} and {tuple(fim.shape)}")
    if gy.shape != gx.shape:
        raise ValueError(f"sample_lines: positions {tuple(gy.shape)} and "
                         f"{tuple(gx.shape)} differ")
    if gy.requires_grad or gx.requires_grad:
        raise ValueError("sample_lines treats the positions as constants")
    return _SampleLines.apply(fre.contiguous(), fim.contiguous(),
                              gy.contiguous(), gx.contiguous())
