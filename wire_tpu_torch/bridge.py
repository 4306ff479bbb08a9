"""Weights across the two packages.

``params_from_jax`` takes a wire_tpu parameter pytree as numpy arrays and
returns the same two-level nested dict of float32 tensors;
``params_to_numpy`` is the reverse, for parameters or gradients.  The
layout is kept as it is at the port's public functions: WIRE's
``first{w,b}``, ``hidden_i{wr,wi,br,bi}``, ``final{wr,wi,br,bi}``, and the
canonical real families' (siren, gauss, relu/posenc, the B-splines)
``{first, hidden_i, final}`` each ``{w, b}`` (the same shape as WIRE's first
layer, so they carry over unchanged; siren's scaled init is only other
numbers in that shape), weights ``(in, out)`` used as ``x @ w``.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(np_params: dict, device="cpu") -> dict:
    return {k: {kk: torch.tensor(np.asarray(v, np.float32), device=device)
                for kk, v in sub.items()}
            for k, sub in np_params.items()}


def params_to_numpy(params: dict) -> dict:
    return {k: {kk: v.detach().cpu().numpy() for kk, v in sub.items()}
            for k, sub in params.items()}
