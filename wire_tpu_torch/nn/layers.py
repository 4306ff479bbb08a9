"""Linear-layer helpers (port of wire_tpu/nn/layers.py).

Weights are stored ``(in, out)`` so application is ``x @ w``, the layout of
the JAX package; complex linears are (re, im) pairs of real matrices.
"""
from __future__ import annotations


def linear(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def complex_linear_from_real(p, x):
    """Real input -> complex output: (x@Wr + br, x@Wi + bi)."""
    yr = x @ p["wr"]
    yi = x @ p["wi"]
    if "br" in p:
        yr = yr + p["br"]
        yi = yi + p["bi"]
    return yr, yi


def complex_linear(p, xr, xi):
    """Complex input -> complex output: (x@W) with W = Wr + i Wi."""
    yr = xr @ p["wr"] - xi @ p["wi"]
    yi = xr @ p["wi"] + xi @ p["wr"]
    if "br" in p:
        yr = yr + p["br"]
        yi = yi + p["bi"]
    return yr, yi
