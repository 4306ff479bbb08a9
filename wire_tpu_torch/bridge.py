"""Weights across the two packages.

``params_from_jax`` takes a wire_tpu parameter pytree as numpy arrays and
returns the same tree (nested dicts and lists) of float32 tensors;
``params_to_numpy`` is the reverse, for parameters or gradients.  The
layout is kept as it is at the port's public functions: WIRE's
``first{w,b}``, ``hidden_i{wr,wi,br,bi}``, ``final{wr,wi,br,bi}``;
WIRE-2D's ``first_lin``/``first_orth{w,b}``,
``hidden_i_lin``/``hidden_i_orth{wr,wi,br,bi}``, ``final{wr,wi,br,bi}``;
the canonical real families' (siren, gauss, relu/posenc, the B-splines)
``{first, hidden_i, final}`` each ``{w, b}`` (siren's scaled init is only
other numbers in that shape); mscale_HL's ``trunk_in`` beside them;
mscale_2's ``combiner`` with its ``scale_weights`` tensor beside the
``{w, b}`` heads; mscale_hier's ``{stages: [[{w, b}, ...], ...], heads:
[{w, b}, ...]}``.  Weights are ``(in, out)``, used as ``x @ w``.

Both map leaves, so a replica-stacked tree (a leading replica axis on every
leaf, as ``jax.vmap`` of an init or ``tree.stack`` gives it) crosses
unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from wire_tpu_torch import tree


def params_from_jax(np_params, device="cpu"):
    return tree.map(lambda v: torch.tensor(np.asarray(v, np.float32),
                                           device=device), np_params)


def params_to_numpy(params):
    return tree.map(lambda v: v.detach().cpu().numpy(), params)
