"""Sensor noise model (port of wire_tpu/signals/noise.py): Poisson photon
noise at integration time tau plus Gaussian readout noise, with the
signed-Poisson trick for non-positive intensities, on the host
(``measure_np``, the reference's numpy stream) and on a device
(``measure``, from a ``torch.Generator``: the same law, another stream);
and salt-and-pepper noise (``salt_and_pepper_np``)."""
from __future__ import annotations

import numpy as np
import torch


def measure_np(x, noise_snr=40, tau=100, rng=None):
    """noise_snr is the readout noise sigma in electrons (despite the name),
    tau the photon integration time; rng a numpy RandomState."""
    rng = np.random if rng is None else rng
    x = np.asarray(x)
    noise = rng.randn(x.size).reshape(x.shape) * noise_snr
    if tau != float("inf"):
        xm = x * tau
        out = np.empty_like(xm)
        pos = x > 0
        out[pos] = rng.poisson(xm[pos])
        out[~pos] = -rng.poisson(-xm[~pos])
        out = (out + noise) / tau
    else:
        out = x + noise
    return out.astype(x.dtype, copy=False)


def measure(gen, x, noise_snr=40, tau=100):
    """``measure_np``'s law on ``x``'s device (wire_tpu/signals/noise.py:37):
    readout noise N(0, noise_snr^2) and Poisson(|x| tau) photons signed by
    x > 0, over tau; ``gen`` a torch.Generator on that device."""
    noise = torch.randn(x.shape, generator=gen, dtype=x.dtype,
                        device=x.device) * noise_snr
    if tau == float("inf"):
        return x + noise
    pois = torch.poisson(torch.abs(x) * tau, generator=gen)
    signed = torch.where(x > 0, pois, -pois)
    return (signed + noise) / tau


def salt_and_pepper_np(image, salt_prob, pepper_prob, rng=None):
    """A copy of ``image`` with pixels set to 255 (salt) and 0 (pepper),
    each drawn over the first two axes with its probability, salt first
    (wire_tpu/signals/noise.py:49); ``rng`` a numpy RandomState."""
    rng = np.random if rng is None else rng
    out = np.copy(image)
    salt = rng.random(image.shape[:2]) < salt_prob
    pepper = rng.random(image.shape[:2]) < pepper_prob
    out[salt] = 255
    out[pepper] = 0
    return out
