"""Frozen counts of the Fourier-slice Radon operator's hand-written kernels
(``csrc/line_sample.cu``: one gather forward, one scatter backward an
iteration; copies of ``ops/line_sample.py:sample_flops`` and
``chip_smoke.py:line_sample_bytes``).  The FFTs are cuFFT's and are not
counted: the roofline's denominator leaves cuFFT out too.  Bytes: per
spectrum the distinct taps its stencils read (8 bytes each, the halo
wrapped), the slice out and its cotangent in and the (P, P) complex
gradient out; once for all spectra the centring table's taps, the
positions and the un-centring phase."""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import radon_fourier as RF

ENGINE = "fp32"


def sample_flops(A, K):
    """One direction: per sample 4 taps, each a complex product with the
    centring phase (6) and a weighted complex sum (4), the 2 x 2 weights
    (4) and the product with the un-centring phase (6)."""
    return 50 * A * K


def sample_bytes(gy, gx, p, replicas=1):
    y0, x0 = torch.floor(gy).long(), torch.floor(gx).long()
    taps = torch.cat([(((y0 + dy) % p) * p + (x0 + dx) % p).ravel()
                      for dy in (0, 1) for dx in (0, 1)])
    ntaps = int(torch.unique(taps).numel())
    A, K = gy.shape
    own = 8 * ntaps + 8 * 2 * A * K + 8 * p * p
    return replicas * own + 8 * ntaps + 4 * 2 * A * K + 8 * K


def iteration(traffic, field_shape, replicas=1):
    """(FLOPs, bytes) of one iteration's gather and scatter."""
    P = RF.fft_size(4 * max(field_shape))
    angles = np.linspace(0, 180, traffic["angles"], dtype=np.float32)
    _, gy, gx, _ = RF.constants(P, angles, "cpu")
    A, K = gy.shape
    return (replicas * 2 * sample_flops(A, K),
            sample_bytes(gy, gx, P, replicas))
