"""Parameter initializers (port of wire_tpu/nn/init.py:25-82).

The same uniform laws as the JAX package (torch.nn.Linear's default,
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias, and SIREN's
scaled weights), drawn from an
explicit ``torch.Generator``.  The numbers differ from jax.random's for the
same seed; tests move a JAX init across with ``wire_tpu_torch.bridge``.
Weights are ``(in, out)``.  Draws are made on the CPU generator and then
moved, so an init is the same on every device.
"""
from __future__ import annotations

import math

import torch


def uniform(gen: torch.Generator, shape, bound, device="cpu"):
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return ((2.0 * u - 1.0) * bound).to(device)


def linear_params(gen, in_features, out_features, *, bias=True,
                  device="cpu"):
    """w ~ U(-1/sqrt(in), 1/sqrt(in)), same for b."""
    bound = 1.0 / math.sqrt(in_features)
    p = {"w": uniform(gen, (in_features, out_features), bound, device)}
    if bias:
        p["b"] = uniform(gen, (out_features,), bound, device)
    return p


def complex_linear_params(gen, in_features, out_features, *, bias=True,
                          device="cpu"):
    """Complex linear as (re, im) pairs, each part drawn independently from
    the same law with fan_in counted in complex elements."""
    pr = linear_params(gen, in_features, out_features, bias=bias,
                       device=device)
    pi = linear_params(gen, in_features, out_features, bias=bias,
                       device=device)
    p = {"wr": pr["w"], "wi": pi["w"]}
    if bias:
        p["br"] = pr["b"]
        p["bi"] = pi["b"]
    return p


def siren_linear_params(gen, in_features, out_features, *, is_first, omega0,
                        bias=True, device="cpu"):
    """SIREN: w ~ U(-1/in, 1/in) for the first layer, U(-sqrt(6/in)/omega0,
    sqrt(6/in)/omega0) after it; b keeps the default 1/sqrt(in) bound."""
    w_bound = (1.0 / in_features if is_first
               else math.sqrt(6.0 / in_features) / omega0)
    p = {"w": uniform(gen, (in_features, out_features), w_bound, device)}
    if bias:
        p["b"] = uniform(gen, (out_features,), 1.0 / math.sqrt(in_features),
                         device)
    return p


def siren_final_linear_params(gen, in_features, out_features, *, omega0,
                              device="cpu"):
    """SIREN's final linear: w ~ U(-sqrt(6/h)/omega0, ...), b default."""
    bound = math.sqrt(6.0 / in_features) / max(omega0, 1e-12)
    return {"w": uniform(gen, (in_features, out_features), bound, device),
            "b": uniform(gen, (out_features,), 1.0 / math.sqrt(in_features),
                         device)}
