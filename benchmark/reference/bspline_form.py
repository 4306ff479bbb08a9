"""The quadratic B-spline INR (the fork's ``modules/bspline_form.py``,
github.com/Annatk26/wire), in plain PyTorch.

Layer: B(z / sigma0) with z = x W + b and the quadratic B-spline bump
B(u) = 0.5 q(u + 1.5) - 1.5 q(u + 0.5) + 1.5 q(u - 0.5) - 0.5 q(u - 1.5),
q = relu^2; a first layer (in -> h), hidden layers (h -> h), then a plain
linear (h -> out).  sigma0 is the preset's scale (1 / 9.5).

Init: torch.nn.Linear's law, every weight and bias uniform in
+-1/sqrt(fan_in), drawn from one CPU ``torch.Generator`` layer by layer,
w before b.
"""
from __future__ import annotations

import math

import torch


def _uniform(gen, shape, fan_in):
    bound = 1.0 / math.sqrt(fan_in)
    return (2.0 * torch.rand(shape, generator=gen, dtype=torch.float32)
            - 1.0) * bound


def _linear(gen, nin, nout):
    return {"w": _uniform(gen, (nin, nout), nin),
            "b": _uniform(gen, (nout,), nin)}


def init(gen, config, out_features):
    h = config["hidden_features"]
    params = {"first": _linear(gen, config["in_features"], h)}
    for i in range(config["hidden_layers"]):
        params[f"hidden_{i}"] = _linear(gen, h, h)
    params["final"] = _linear(gen, h, out_features)
    return params


def _q(u):
    r = torch.relu(u)
    return r * r


def bump(u):
    return (0.5 * _q(u + 1.5) - 1.5 * _q(u + 0.5) + 1.5 * _q(u - 0.5)
            - 0.5 * _q(u - 1.5))


def apply(params, coords, config, traffic, mm):
    sigma = traffic["scale"]
    x = coords
    for name in ["first"] + [f"hidden_{i}"
                             for i in range(config["hidden_layers"])]:
        p = params[name]
        x = bump((mm(x, p["w"]) + p["b"]) / sigma)
    return mm(x, params["final"]["w"]) + params["final"]["b"]
