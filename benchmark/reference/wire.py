"""WIRE, the complex Gabor wavelet INR (Saragadam et al., arXiv:2301.05187),
in plain PyTorch.

Layer: psi(z) = exp(j omega0 z) exp(-|sigma0 z|^2) on the complex
pre-activation z = x W + b, which for z = zr + j zi is
exp(-omega0 zi - sigma0^2 (zr^2 + zi^2)) (cos(omega0 zr) + j sin(omega0 zr)).
The first layer is real (2 -> h); each hidden layer is complex (h -> h);
the final linear is complex and its real part is the output.  h is
hidden_features / sqrt(2), truncated: complex units count double (212 for
300).  Weights are (in, out); complex weights are (re, im) pairs.

Init: every weight and bias uniform in +-1/sqrt(fan_in) (torch.nn.Linear's
default law), drawn from one CPU ``torch.Generator`` in the order first
(w, b), then per complex layer the real part's (w, b) and the imaginary
part's (w, b).
"""
from __future__ import annotations

import math

import torch


def units(config):
    return int(config["hidden_features"] / math.sqrt(2))


def _uniform(gen, shape, fan_in):
    bound = 1.0 / math.sqrt(fan_in)
    return (2.0 * torch.rand(shape, generator=gen, dtype=torch.float32)
            - 1.0) * bound


def _linear(gen, nin, nout):
    return {"w": _uniform(gen, (nin, nout), nin),
            "b": _uniform(gen, (nout,), nin)}


def _complex(gen, nin, nout):
    re, im = _linear(gen, nin, nout), _linear(gen, nin, nout)
    return {"wr": re["w"], "br": re["b"], "wi": im["w"], "bi": im["b"]}


def init(gen, config, out_features):
    h = units(config)
    params = {"first": _linear(gen, config["in_features"], h)}
    for i in range(config["hidden_layers"]):
        params[f"hidden_{i}"] = _complex(gen, h, h)
    params["final"] = _complex(gen, h, out_features)
    return params


def apply(params, coords, config, traffic, mm):
    """(rows, out) real output at ``coords`` (rows, in); ``mm`` forms every
    matrix product."""
    w0, s2 = traffic["omega0"], traffic["scale"] ** 2
    z = mm(coords, params["first"]["w"]) + params["first"]["b"]
    mag = torch.exp(-s2 * (z * z))
    xr, xi = mag * torch.cos(w0 * z), mag * torch.sin(w0 * z)
    for i in range(config["hidden_layers"]):
        p = params[f"hidden_{i}"]
        zr = mm(xr, p["wr"]) - mm(xi, p["wi"]) + p["br"]
        zi = mm(xr, p["wi"]) + mm(xi, p["wr"]) + p["bi"]
        mag = torch.exp(-w0 * zi - s2 * (zr * zr + zi * zi))
        xr, xi = mag * torch.cos(w0 * zr), mag * torch.sin(w0 * zr)
    p = params["final"]
    return mm(xr, p["wr"]) - mm(xi, p["wi"]) + p["br"]
