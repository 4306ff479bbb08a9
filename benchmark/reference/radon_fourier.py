"""The Fourier-slice Radon transform in plain PyTorch: the image zero-padded
into a P x P frame (P the least 2^a 3^b >= 4 max(H, W)), one 2-D FFT,
bilinear samples of the fftshifted spectrum, phase-centred on the
(P - 1) / 2 pixel, along each angle's central slice (k sin, k cos) for
k = 0 .. P/2, with the periodic halo on the high side, the x centring
phase undone, one inverse real FFT per angle, cropped to W.  Autograd
gives the adjoint.  A frozen copy of the arithmetic of
``operators/radon.py:_radon_fourier`` with its plain sampler
(``ops/line_sample.py:sample_spectrum_plain``)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

TWO_PI = np.float32(2.0 * np.pi)


def fft_size(minimum):
    best = 1 << (int(minimum) - 1).bit_length()
    p3 = 1
    while p3 < best:
        p2 = 1
        while p2 * p3 < minimum:
            p2 *= 2
        best = min(best, p2 * p3)
        p3 *= 3
    return best


def _expi(phase):
    return torch.polar(torch.ones_like(phase), phase)


def constants(P, angles_degrees, device):
    """(centre (P, P), gy (A, K), gx (A, K), uncentre (1, K))."""
    theta = torch.deg2rad(torch.tensor(
        np.asarray(angles_degrees, np.float32), device=device))
    c = (P - 1) / 2.0
    f = (torch.arange(P, dtype=torch.float32, device=device) - P // 2) / P
    centre = _expi(((f[:, None] + f[None, :]) * TWO_PI) * c)
    kx = torch.arange(P // 2 + 1, dtype=torch.float32, device=device) / P
    k = kx * P
    gy = k[None, :] * torch.sin(theta)[:, None] + P // 2
    gx = k[None, :] * torch.cos(theta)[:, None] + P // 2
    uncentre = _expi((kx * -TWO_PI) * c)[None, :]
    return centre, gy, gx, uncentre


def _bilinear(f, gy, gx):
    y0, x0 = torch.floor(gy), torch.floor(gx)
    wy, wx = gy - y0, gx - x0
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    return ((1 - wy) * ((1 - wx) * f[y0, x0] + wx * f[y0, x0 + 1])
            + wy * ((1 - wx) * f[y0 + 1, x0] + wx * f[y0 + 1, x0 + 1]))


def radon(img, angles_degrees):
    """(H, W) -> (A, W) sinogram."""
    H, W = img.shape
    P = fft_size(4 * max(H, W))
    py0, px0 = (P - H) // 2, (P - W) // 2
    pad = F.pad(img, (px0, P - W - px0, py0, P - H - py0))
    centre, gy, gx, uncentre = constants(P, angles_degrees, img.device)
    spec = torch.fft.fftshift(torch.fft.fftn(pad, dim=(-2, -1))) * centre
    spec = torch.cat([spec, spec[:2]], 0)
    spec = torch.cat([spec, spec[:, :2]], 1)
    line = torch.complex(_bilinear(spec.real, gy, gx),
                         _bilinear(spec.imag, gy, gx)) * uncentre
    return torch.fft.irfft(line, n=P, dim=-1)[..., px0:px0 + W]

