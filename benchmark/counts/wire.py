"""Frozen FLOP and byte counts of WIRE's kernels, as the port computes them
(copies of ``ops/wire_step.py:step_flops``, ``ops/wire_mlp.py:
apply_flops`` and the byte counts of ``chip_smoke.py``'s ``measure``
phases): 2 FLOPs a multiply-add, no padding; every input read once and
every output written once, 4 bytes a float.  The hidden products run as
3xTF32 on the tensor cores (``engine``)."""
from __future__ import annotations

import math

ENGINE = "3xtf32"


def units(config):
    return int(config["hidden_features"] / math.sqrt(2))


def step_flops(n, d, h, o, L):
    """One step: forward, data gradient, weight and bias gradients."""
    h2 = 2 * h
    fwd = 2 * n * (d * h + L * h2 * h2 + h2 * o)
    data = 2 * n * (o * h2 + L * h2 * h2)
    weight = 2 * n * ((d + 1) * h + L * (h2 + 1) * h2 + (h2 + 1) * o)
    return fwd + data + weight


def apply_flops(n, d, h, o, L):
    """One forward + backward of the apply/VJP pair with dcoords."""
    h2 = 2 * h
    fwd = 2 * n * (d * h + L * h2 * h2 + h2 * o)
    data = 2 * n * (o * h2 + L * h2 * h2 + d * h)
    weight = 2 * n * ((d + 1) * h + L * (h2 + 1) * h2 + (h2 + 1) * o)
    return fwd + data + weight


def num_weights(d, h, o, L):
    return (d * h + h) + L * (2 * h * h + 2 * h) + (2 * h * o + 2 * o)


def _shape(config, out):
    return config["in_features"], units(config), out, config["hidden_layers"]


def model_flops(config, rows, out):
    """The model's FLOPs of one training step at ``rows``."""
    return step_flops(rows, *_shape(config, out))


def step(config, rows, out, replicas=1):
    """(FLOPs, bytes) of one ``wire_step`` call for ``replicas`` models on
    shared coordinates, target and gt (read once)."""
    d, h, o, L = _shape(config, out)
    w = num_weights(d, h, o, L)
    return (replicas * step_flops(rows, d, h, o, L),
            4 * (rows * (d + o + o) + replicas * (rows * o + 2 * w + 2)))


def pair(config, rows, out, replicas=1):
    """(FLOPs, bytes) of one ``wire_mlp`` forward + backward in a fit: no
    coordinate gradient."""
    d, h, o, L = _shape(config, out)
    w = num_weights(d, h, o, L)
    return (replicas * (apply_flops(rows, d, h, o, L) - 2 * rows * d * h),
            4 * (rows * d + replicas * (2 * rows * o + 2 * w)))
