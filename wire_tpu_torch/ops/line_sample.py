"""Bilinear sampling of the 2-D spectrum along radial lines, the hot gather
and scatter of the Fourier-slice Radon operator: the hand-written CUDA
kernels (``csrc/line_sample.cu``) and their plain PyTorch version.

Replaces wire_tpu/ops/pallas/line_sample.py:sample_lines (gather and
scatter Pallas calls) together with the plane-building of
wire_tpu/operators/radon.py:_radon_fourier around them;
``sample_lines_plain`` is the port of ``sample_lines_xla``, the JAX
package's fallback and oracle.

Contract (established by operators/radon.py): ``F`` is the unshifted (P, P)
complex64 spectrum, as ``torch.fft.fftn`` gives it; ``centre`` the (P, P)
centring phase of the fftshifted frame; ``gy``, ``gx`` the (A, K) float32
slice positions in that frame, 0 <= floor(g) and floor(g) + 1 <= P + 1; and
``uncentre`` the (1, K) un-centring phase.  ``sample_spectrum`` returns the
(A, K) complex64 slice ``uncentre * bilinear(fftshift(F) * centre)``, where
a tap on line P or P + 1 (a sample on the Nyquist line) reads line 0 or 1:
the periodic halo.  On CUDA tensors the gather kernel does all of that in
one launch, the shift and the halo as index arithmetic mod P; the gradient
flows to ``F`` through a ``torch.autograd.Function`` whose backward is the
scatter kernel.  The tables are constants.

``sample_spectrum`` runs the plain version (``sample_spectrum_plain``, the
shift, the phase, the two halo lines and ``sample_lines_plain`` written
out) for tensors on the CPU, and for CUDA tensors launches the kernels or
raises; there is no fallback.  The scatter adds with atomics, so its last
bits vary from run to run.

A stack of M spectra (M, P, P) goes to (M, A, K) slices with the shared
tables, one gather and one scatter launch for all M (wire_tpu vmaps the
Pallas calls in its batched CT fits); replica r's gather is bit-equal to
an unbatched call on its spectrum.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from wire_tpu_torch.ops import build
from wire_tpu_torch.train import profiling

# kernel launches of this module, by direction
for _direction in ("gather", "scatter"):
    profiling.count(f"launches.line_sample.{_direction}", 0)


def sample_lines_plain(fre, fim, gy, gx):
    """Bilinear samples of both (Ph, Ph) planes at (gy, gx) by indexing;
    autograd's backward is the scatter-add."""
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


def sample_spectrum_plain(F, centre, gy, gx, uncentre):
    """The slice of the unshifted spectrum ``F`` in PyTorch ops: fftshift,
    the centring phase, two periodic halo lines on the high side (a sample
    on the Nyquist line, position P, reads lines P and P + 1, which alias to
    0 and 1), the bilinear samples of the re and im planes and the
    un-centring phase; autograd gives the adjoint.  A stack (M, P, P) is
    sampled one spectrum at a time."""
    if F.ndim == 3:
        return torch.stack([sample_spectrum_plain(f, centre, gy, gx,
                                                  uncentre) for f in F])
    Fs = torch.fft.fftshift(F) * centre
    Fh = torch.cat([Fs, Fs[:2]], 0)
    Fh = torch.cat([Fh, Fh[:, :2]], 1)
    sre, sim = sample_lines_plain(torch.real(Fh), torch.imag(Fh), gy, gx)
    return torch.complex(sre, sim) * uncentre


def sample_flops(A, K):
    """fp32 operations of one direction: per sample, 4 taps, each a complex
    product with the centring phase (6) and a weighted complex sum (4), the
    2 x 2 weights (4) and the product with the un-centring phase (6)."""
    return 50 * A * K


_PTR = ctypes.c_void_p
_INT = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("line_sample")
    for fn in (lib.spectrum_gather, lib.spectrum_scatter):
        fn.argtypes = [_PTR] * 6 + [_INT] * 4 + [_PTR]
        fn.restype = _INT
    lib.line_sample_error_string.argtypes = [_INT]
    lib.line_sample_error_string.restype = ctypes.c_char_p
    return lib


def _run(fn, what, ptrs, n, k, p, reps, device):
    lib = _lib()
    with profiling.span(f"kernels.line_sample.{what}"):
        rc = getattr(lib, fn)(*[t.data_ptr() for t in ptrs], n, k, p, reps,
                              torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"line_sample {what} kernel launch failed: CUDA error {rc} "
            f"({lib.line_sample_error_string(rc).decode()})")
    profiling.count(f"launches.line_sample.{what}")


class _SampleSpectrum(torch.autograd.Function):

    @staticmethod
    @profiling.spanned("wrappers.line_sample.gather")
    def forward(ctx, F, centre, gy, gx, uncentre):
        lead = tuple(F.shape[:-2])
        reps = F.shape[0] if lead else 1
        out = torch.empty(lead + tuple(gy.shape), dtype=torch.complex64,
                          device=F.device)
        _run("spectrum_gather", "gather", (F, centre, gy, gx, uncentre, out),
             gy.numel(), gy.shape[1], F.shape[-1], reps, F.device)
        # the tables are constants of the operator: kept as they are, not
        # saved for autograd's version checks
        ctx.tables = (centre, gy, gx, uncentre)
        ctx.lead = lead
        return out

    @staticmethod
    @profiling.spanned("wrappers.line_sample.scatter")
    def backward(ctx, cot):
        centre, gy, gx, uncentre = ctx.tables
        reps = ctx.lead[0] if ctx.lead else 1
        cot = cot.contiguous()  # irfft's backward hands a contiguous one
        f_bar = torch.empty(ctx.lead + tuple(centre.shape),
                            dtype=torch.complex64, device=cot.device)
        _run("spectrum_scatter", "scatter",
             (cot, centre, gy, gx, uncentre, f_bar), gy.numel(),
             gy.shape[1], centre.shape[0], reps, cot.device)
        return f_bar, None, None, None, None


def _check(F, centre, gy, gx, uncentre):
    P = F.shape[-1] if F.ndim in (2, 3) else -1
    A, K = gy.shape if gy.ndim == 2 else (-1, -1)
    lead = tuple(F.shape[:-2]) if F.ndim == 3 else ()
    for name, t, dtype, shape in (
            ("F", F, torch.complex64, lead + (P, P)),
            ("centre", centre, torch.complex64, (P, P)),
            ("gy", gy, torch.float32, (A, K)),
            ("gx", gx, torch.float32, (A, K)),
            ("uncentre", uncentre, torch.complex64, (1, K))):
        if t.device != F.device:
            raise ValueError(f"sample_spectrum: {name} is on {t.device}, "
                             f"expected {F.device}")
        if t.dtype != dtype:
            raise TypeError(f"sample_spectrum: {name} has dtype {t.dtype}, "
                            f"expected {dtype}")
        if P < 1 or A < 1 or tuple(t.shape) != shape:
            raise ValueError(f"sample_spectrum: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape} (F square "
                             f"or a stack of squares, positions (A, K))")
        if not t.is_contiguous():
            raise ValueError(f"sample_spectrum: {name} is not contiguous")
        if t is not F and t.requires_grad:
            raise ValueError(f"sample_spectrum treats {name} as a constant "
                             f"(method='rotate_xla' differentiates through "
                             f"the angles)")


def sample_spectrum(F, centre, gy, gx, uncentre):
    """(P, P) unshifted complex spectrum -> (A, K) complex slice, or an
    (M, P, P) stack -> (M, A, K), differentiable in F (see the module's
    contract)."""
    if F.device.type == "cpu":
        return sample_spectrum_plain(F, centre, gy, gx, uncentre)
    if F.device.type != "cuda":
        raise ValueError(f"sample_spectrum: unsupported device {F.device}")
    _check(F, centre, gy, gx, uncentre)
    return _SampleSpectrum.apply(F, centre, gy, gx, uncentre)
