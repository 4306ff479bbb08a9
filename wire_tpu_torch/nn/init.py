"""Parameter initializers (port of wire_tpu/nn/init.py:25-98).

The same laws as the JAX package (torch.nn.Linear's default,
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias, SIREN's scaled
weights, and MFN's Gabor filters with their Gamma-distributed widths),
drawn from an explicit ``torch.Generator``.  The numbers differ from
jax.random's for the same seed; tests move a JAX init across with
``wire_tpu_torch.bridge``.  Weights are ``(in, out)``.  Draws are made on
the CPU generator and then moved, so an init is the same on every device.
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


def gamma(gen: torch.Generator, alpha, shape, device="cpu"):
    """Gamma(alpha, 1) draws from ``gen`` (torch's own Gamma samplers take
    no generator): Marsaglia and Tsang's squeeze-free rejection method on
    the generator's normals and uniforms, in float64, for alpha >= 1; for
    alpha < 1 a Gamma(alpha + 1) draw times U^(1 / alpha).  Rounds draw
    one normal and one uniform per missing value until every value is
    accepted, so the draws are a function of the generator's state."""
    alpha = float(alpha)
    if not alpha > 0:
        raise ValueError(f"gamma: alpha must be > 0, got {alpha}")
    n = math.prod(shape)
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty((n,), dtype=torch.float64)
    filled = 0
    while filled < n:
        m = n - filled
        x = torch.randn((m,), generator=gen, dtype=torch.float64)
        u = torch.rand((m,), generator=gen, dtype=torch.float64)
        v = (1.0 + c * x) ** 3
        pos = v > 0
        logv = torch.log(torch.where(pos, v, torch.ones_like(v)))
        ok = pos & (torch.log(u) < 0.5 * x * x + d - d * v + d * logv)
        acc = d * v[ok]
        out[filled:filled + acc.numel()] = acc
        filled += acc.numel()
    if alpha < 1.0:
        u = torch.rand((n,), generator=gen, dtype=torch.float64)
        out = out * u ** (1.0 / alpha)
    return out.to(torch.float32).reshape(shape).to(device)


def mfn_gabor_params(gen, in_features, out_features, alpha, beta=1.0,
                     device="cpu"):
    """One MFN Gabor filter (wire_tpu/nn/init.py:84-98): mu ~ U(-1, 1)
    (out, in), gamma ~ Gamma(alpha, beta) (out), w ~ U(+-1/sqrt(in)) * 128
    * sqrt(gamma) (in, out), b ~ U(-pi, pi) (out)."""
    mu = uniform(gen, (out_features, in_features), 1.0)
    g = gamma(gen, alpha, (out_features,)) / beta
    w = uniform(gen, (in_features, out_features),
                1.0 / math.sqrt(in_features)) * 128.0 * torch.sqrt(g)[None, :]
    b = uniform(gen, (out_features,), math.pi)
    return {"mu": mu.to(device), "gamma": g.to(device), "w": w.to(device),
            "b": b.to(device)}
