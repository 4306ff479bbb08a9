"""Frozen FLOP and byte counts of the canonical real step kernel
(``real_step``) for the B-spline family, as the port computes them
(copies of ``ops/real_mlp.py:forward_flops``, ``step_flops``,
``apply_flops`` and ``chip_smoke.py``'s byte counts):
widths (d, h, .., h, o); bias sums and elementwise work not counted; the
canonical parameters per layer w, alpha, beta, then the final w, b.  The
trunk's products run as 3xTF32 on the tensor cores."""
from __future__ import annotations

ENGINE = "3xtf32"


def widths(config, out):
    return ([config["in_features"]]
            + [config["hidden_features"]] * (config["hidden_layers"] + 1)
            + [out])


def forward_flops(n, ws):
    return 2 * n * sum(a * b for a, b in zip(ws[:-1], ws[1:]))


def step_flops(n, ws):
    """Forward, weight gradients and the data gradients of every layer but
    the first."""
    return 3 * forward_flops(n, ws) - 2 * n * ws[0] * ws[1]


def apply_flops(n, ws):
    return step_flops(n, ws) + 2 * n * ws[0] * ws[1]


def num_weights(ws):
    trunk = sum(a * b + 2 * b for a, b in zip(ws[:-2], ws[1:-1]))
    return trunk + ws[-2] * ws[-1] + ws[-1]


def model_flops(config, rows, out):
    return step_flops(rows, widths(config, out))


def step(config, rows, out, replicas=1):
    ws = widths(config, out)
    w, d = num_weights(ws), ws[0]
    return (replicas * step_flops(rows, ws),
            4 * (rows * (d + out + out) + replicas * (rows * out + 2 * w + 2)))

