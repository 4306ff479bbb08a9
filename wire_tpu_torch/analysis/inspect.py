"""Reconstruction inspection tools (port of wire_tpu/analysis/inspect.py),
on the host with numpy and the port's PNG writer:

- ``error_map``     the absolute difference, saved in viridis up to vmax
- ``spectrum``      the FFT log-magnitude spectrum, saved in viridis
- ``noisy_preview`` noisy copies of an image at given (tau, snr)
- ``layer_outputs`` per-layer activation-atom montages of the sequential
                    families (wire, siren, gauss, relu, bspline_form),
                    through their plain layer chain
"""
from __future__ import annotations

import os

import numpy as np
import torch

from wire_tpu_torch.signals.image import build_montage, imsave, normalize
from wire_tpu_torch.signals.noise import measure_np


def error_map(gt, rec, out_path=None, vmax=0.1):
    """|gt - rec| in float32; saved to ``out_path`` (clipped to [0, 1],
    viridis over [0, vmax]) when given."""
    err = np.abs(np.asarray(gt, np.float32) - np.asarray(rec, np.float32))
    if out_path:
        imsave(out_path, np.clip(err, 0, 1), vmin=0.0, vmax=vmax)
    return err


def spectrum(image, out_path=None):
    """log(1 + |fftshift(fft2(image))|) of the image (its channel mean
    for RGB); saved min-max normalized in viridis when ``out_path`` is
    given."""
    im = np.asarray(image, np.float32)
    if im.ndim == 3:
        im = im.mean(-1)
    mag = np.log1p(np.abs(np.fft.fftshift(np.fft.fft2(im))))
    if out_path:
        imsave(out_path, normalize(mag, True), cmap="viridis")
    return mag


def noisy_preview(image, taus_snrs, out_dir, rng=None):
    """``measure_np`` of ``image`` at each (tau, snr), clipped to [0, 1]
    and saved as ``out_dir``/noisy_T<tau>_SNR<snr>.png; returns the
    paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for tau, snr in taus_snrs:
        noisy = measure_np(np.asarray(image, np.float32), snr, tau, rng=rng)
        p = os.path.join(out_dir, f"noisy_T{tau}_SNR{snr}.png")
        imsave(p, np.clip(noisy, 0, 1))
        paths.append(p)
    return paths


def layer_outputs(model, params, coords, imsize, nfilters_vis=16,
                  get_imag=False):
    """A montage per nonlinear layer of its activations over the image
    grid (wire_tpu/analysis/inspect.py:56-87): the first ``nfilters_vis``
    filters (or "all"), each flipped to a positive peak, ordered by
    spread, min-max normalized and framed.  WIRE's real parts (imaginary
    with ``get_imag``)."""
    H, W = imsize
    with torch.no_grad():
        acts = _intermediate_activations(
            model, params, torch.as_tensor(np.asarray(coords, np.float32)),
            get_imag)
    montages = []
    for a in acts:
        imgs = a.cpu().numpy().reshape(H, W, -1)
        if nfilters_vis != "all":
            imgs = imgs[..., :nfilters_vis]
        atoms = imgs
        amin = atoms.min((0, 1), keepdims=True)
        amax = atoms.max((0, 1), keepdims=True)
        signs = np.abs(amin) > np.abs(amax)
        atoms = (1 - 2 * signs) * atoms
        order = np.argsort(atoms.std((0, 1)))
        atoms = atoms[..., order]
        amin = atoms.min((0, 1), keepdims=True)
        amax = atoms.max((0, 1), keepdims=True)
        atoms = (atoms - amin) / np.maximum(1e-14, amax - amin)
        atoms[:, [0, -1], :] = 1
        atoms[[0, -1], :, :] = 1
        montages.append(build_montage(np.transpose(atoms, (2, 0, 1))))
    return montages


def _intermediate_activations(model, params, coords, get_imag):
    """Each nonlinear layer's output, by the families' plain layer chain
    on the parameters' device."""
    from wire_tpu_torch import tree
    from wire_tpu_torch.nn import activations as act
    from wire_tpu_torch.nn.layers import complex_linear, linear
    spec = model.spec
    coords = coords.to(tree.leaves(params)[0][1].device)
    outs = []
    if spec.nonlin == "wire":
        z = linear(params["first"], coords)
        xr, xi = act.complex_gabor_real_input(z, spec.first_omega0,
                                              spec.scale)
        outs.append(xi if get_imag else xr)
        for i in range(spec.hidden_layers):
            zr, zi = complex_linear(params[f"hidden_{i}"], xr, xi)
            xr, xi = act.complex_gabor(zr, zi, spec.hidden_omega0,
                                       spec.scale)
            outs.append(xi if get_imag else xr)
        return outs
    fn = {
        "siren": lambda p, x: act.sine(linear(p, x), spec.hidden_omega0),
        "gauss": lambda p, x: act.gauss(linear(p, x), spec.scale),
        "relu": lambda p, x: act.relu(linear(p, x)),
        "bspline_form": lambda p, x: act.bspline_quadratic(
            linear(p, x) / spec.scale),
    }.get(spec.nonlin)
    if fn is None:
        raise NotImplementedError(
            f"layer_outputs: unsupported family {spec.nonlin}")
    x = fn(params["first"], coords)
    outs.append(x)
    for i in range(spec.hidden_layers):
        x = fn(params[f"hidden_{i}"], x)
        outs.append(x)
    return outs
