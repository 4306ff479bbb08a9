"""INR activations (port of wire_tpu/nn/activations.py:26-152, with
``bspline_sigmoid`` at :109).

Complex quantities are explicit ``(re, im)`` pairs of real tensors.  The
real activations are plain PyTorch ops that autograd differentiates; the
canonical kernels' bases and their explicit derivatives live in
``ops/real_mlp.py``.
"""
from __future__ import annotations

import math

import torch


def complex_gabor(zr, zi, omega0, sigma0):
    """exp(1j*omega0*z - |sigma0*z|^2) for z = zr + 1j*zi, as (re, im)."""
    mag = torch.exp(-omega0 * zi - (sigma0 * sigma0) * (zr * zr + zi * zi))
    phase = omega0 * zr
    return mag * torch.cos(phase), mag * torch.sin(phase)


def complex_gabor_real_input(z, omega0, sigma0):
    """Same activation with a real pre-activation (first WIRE layer)."""
    mag = torch.exp(-(sigma0 * sigma0) * (z * z))
    phase = omega0 * z
    return mag * torch.cos(phase), mag * torch.sin(phase)


def complex_gabor2d(lin_r, lin_i, orth_r, orth_i, omega0, sigma0):
    """WIRE-2D: exp(1j*omega0*lin) * exp(-sigma0^2 (|lin|^2 + |orth|^2)), as
    (re, im).  exp(1j*omega0*lin) for a complex lin brings the magnitude
    exp(-omega0*lin_i), taken in the same exp as the Gaussian: e^{-w li}
    alone can overflow where the Gaussian is 0."""
    arg = lin_r * lin_r + lin_i * lin_i + orth_r * orth_r + orth_i * orth_i
    mag = torch.exp(-omega0 * lin_i - (sigma0 * sigma0) * arg)
    phase = omega0 * lin_r
    return mag * torch.cos(phase), mag * torch.sin(phase)


def sine(z, omega0):
    return torch.sin(omega0 * z)


def gauss(z, scale):
    s = scale * z
    return torch.exp(-(s * s))


def relu(z):
    return torch.relu(z)


def _qrelu(x):
    r = torch.relu(x)
    return r * r


def _crelu(x):
    r = torch.relu(x)
    return r * r * r


def bspline_quadratic(z):
    """Quadratic B-spline from 4 shifted relu^2 terms; z is the already
    scaled argument."""
    return (0.5 * _qrelu(z + 1.5)
            - 1.5 * _qrelu(z + 0.5)
            + 1.5 * _qrelu(z - 0.5)
            - 0.5 * _qrelu(z - 1.5))


def bspline_cubic(z):
    """Cubic B-spline from 5 shifted relu^3 terms."""
    return ((1.0 / 6.0) * _crelu(z + 2.0)
            - (2.0 / 3.0) * _crelu(z + 1.0)
            + _crelu(z)
            - (2.0 / 3.0) * _crelu(z - 1.0)
            + (1.0 / 6.0) * _crelu(z - 2.0))


def bspline_srelu(z, sigma0):
    """(relu(1 - sigma0 z) * relu(sigma0 z))^2."""
    s = sigma0 * z
    v = torch.relu(1.0 - s) * torch.relu(s)
    return v * v


def bspline_sigmoid(z, first_coord_negative, omega0, sigma0):
    """The sigmoid-pair B-spline bump: sigmoid(s z - s w) where the first
    input coordinate is negative, sigmoid(-s z - s w) elsewhere (s =
    sigma0, w = omega0), selected per element; ``first_coord_negative`` a
    bool tensor that broadcasts against z's batch dimensions."""
    scale_in = sigma0 * z
    shift = sigma0 * omega0
    neg = torch.sigmoid(scale_in - shift)
    pos = torch.sigmoid(-scale_in - shift)
    return torch.where(first_coord_negative, neg, pos)


def bspline_deboor(z, knots, degree=2):
    """The B-spline basis N_{2, degree} by the De Boor recursion on a fixed
    knot vector (a sequence of floats), unrolled statically."""
    knots = [float(k) for k in knots]

    def basis(i, k):
        if k == 0:
            return ((knots[i] <= z) & (z < knots[i + 1])).to(z.dtype)
        d1 = knots[i + k] - knots[i]
        d2 = knots[i + k + 1] - knots[i + 1]
        t1 = (z - knots[i]) / d1 if d1 != 0 else torch.zeros_like(z)
        t2 = ((knots[i + k + 1] - z) / d2 if d2 != 0
              else torch.zeros_like(z))
        return t1 * basis(i, k - 1) + t2 * basis(i + 1, k - 1)

    return basis(2, degree)


def posenc(coords, num_frequencies, in_features):
    """NeRF-style positional encoding: after the coordinates, for each
    frequency i and input channel j, sin(2^i pi c_j) and cos(2^i pi c_j), in
    the reference's interleaving order."""
    parts = [coords]
    for i in range(num_frequencies):
        for j in range(in_features):
            c = coords[..., j:j + 1]
            parts.append(torch.sin((2.0 ** i) * math.pi * c))
            parts.append(torch.cos((2.0 ** i) * math.pi * c))
    return torch.cat(parts, dim=-1)
